#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (global_lvba_tpu_torch) on one
NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. set-up: the card's name and power limit, TF32 off, the kernels built
     from global_lvba_tpu_torch/csrc (timed), the native host library built
     from global_lvba_tpu_torch/native with g++ (timed), the DMMA (fp64
     tensor-core) instructions counted in syrk_f64_kernel's SASS
     (cuobjdump; none fails);
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, at the shapes the main path gives it (the W=512 scene below,
     every voxel chunk of one evaluation), with the tolerance printed,
     and timed (device time per evaluation = every chunk, calls queued
     behind a spin kernel so host time between launches does not show)
     beside its plain version, the one PyTorch call that computes the same
     function where there is one, and its bound on this card (soa_agg's
     over the live cells' bytes, the layout's printed beside it);
     soa_agg (one launch over the bucket) is also checked at K = 1, 4, 45,
     64 and 1,024 on seeded planes, V not a multiple of a block's voxels,
     float32 and float64, with the pose table, per-entry pose rows and
     rows off 16-byte alignment, and all five in one soa_agg_buckets call;
     soa_chain (its voxel sums finished in the launch) is also checked as
     the evaluation calls it (the first chunk stores g and Hd, the next
     adds to them): two runs bitwise equal, the rows of dead cells exact
     zeros, and at the aligned widths W = 77 and 130 (off its 32-frame
     tile; picks_aligned must take them), each launch timed alone beside
     its bound and the earlier design's time; its bound counts the live
     cells' bytes (n of every cell, μ and Pc's upper triangle of a live
     one), the layout's printed beside it;
     syrk (3xTF32 on the tensor cores) is also checked on ragged operands
     (N = 270 and 60 over 1,001 seeded rows) and at Kr = 0: its tf32 split
     bitwise equal to the plain split, the Gram within 1e-4 of syrk_plain_
     and torch.matmul, exactly symmetric and bitwise repeatable; its bound
     is the 3xTF32 one (3·Kr·N·(N+1) flops at 495 TFLOP/s TF32);
 2d. the float64 instances of kernels 1-3 (soa_agg_f64, soa_chain_f64,
     syrk_f64) on the same operands in float64 against their plain
     versions in float64 (the TOL64_* limits), timed beside them; the
     bounds at 8 B a value and the data sheet's fp64 rates; syrk_f64 also
     on ragged operands (N = 270, 60 and 45 over 1,001 seeded rows, and
     N = 270 off 16-byte alignment) and at Kr = 0 (no launch); soa_chain_f64
     as soa_chain in 2; one float64 evaluation timed and under
     torch.profiler (each kernel's own time; no aten::sum but the
     residuals');
  3. evaluation: plane_cost_grad_hess through the kernels against the same
     evaluation through the plain versions; the Hessian of two kernel
     evaluations must be bitwise equal; one evaluation under
     torch.profiler gives each kernel's own device time, and its only
     aten::sum ops must be the residuals' (the chain's voxel sums finish
     in its launch); the LM's damped
     CG solve on that H (48 done-masked trips captured as one CUDA graph,
     the capture timed once): one solve queued under sync debug mode
     "error", two solves bitwise equal and within 1e-6 of the same trips
     run eagerly, device ms of both;
  4. slice: run_lidar_ba on 512 frames / 1.02 M points (window stage off,
     both global stages at voxel size 1.0, eigen ratio 0.2, float32) with
     the launch counts set to 0 just before and read just after; every
     kernel must have run, the ATE must fall at least 5x and land within
     10% of the same run in float64 on the CPU (the port's plain path,
     which the CPU tests hold to the JAX package at 1e-8);
 4b. float64: the same run_lidar_ba with solver.dtype float64 on the card:
     every aligned kernel's float64 instance must have run and no float32
     kernel, and its ATE must land within 1e-6 relative of the float64
     CPU run's;
  5. the JAX bench's W=512 problem (bench.py bench_w512: voxel map at the
     true poses, lm_damping_iter from the perturbed ones) on the card: the
     ATE must reach <= 1 mm (the JAX package's figure is 0.00067 m); ms
     per LM iteration; a run under sync debug mode "warn" must make as many
     synchronizing calls as iterations (one read of `converged` each); a
     run under torch.profiler gives the device's busy and idle share in
     one window (the same busy time over the unprofiled run's wall is
     printed beside it as a cross-run estimate).
Slice 2, the bucketed layout:
  6. kernels at path 2b's shapes (the corridor below: every tier and every
     voxel chunk of one evaluation, in the evaluation's launch shape):
     table_select over every tier in one table_select_buckets launch,
     bitwise equal to its plain version and to torch.index_select, with
     the ids -1, P and P + 3 planted in every tier (zero rows) and on the
     W = 45 corridor's tiers; soa_agg on per-entry
     pose rows, all tiers in one soa_agg_buckets call (a launch a bucket
     timed beside it, bitwise equal), and soa_chain_entries under slice
     1's tolerances and well-conditioned-voxel rule; entry_reduce once over
     every tier's entries through the merged frame table, relative to max
     |.|, two calls bitwise equal; each timed beside its plain version,
     its library call and its bound;
     soa_chain_entries also with A over a block the caching allocator was
     handed back filled with NaN (A must take it, and be exactly zero off
     the live entries' cells), on every chunk, with frame ids -1, W and
     W + 3 planted in live entries, and on an odd-W bucketed problem
     (W = 45); syrk on the corridor's Gram operands, checked as in phase 2
     and timed in turns with torch.matmul(A.T, A);
 6f. the float64 instances of table_select, soa_agg, soa_chain_entries and
     entry_reduce on the same operands in float64, checked and timed as
     in 2d, soa_chain_entries_f64 also as in 6; syrk_f64 on the corridor's
     float64 Gram operands, checked as in 2d and timed in turns with
     torch.matmul; one float64 evaluation over the buckets timed and under
     torch.profiler;
  7. the bucketed evaluation over the corridor's five buckets (one Gram
     accumulator, one entry_reduce: solver.lm's): its launches counted
     (one entry_reduce, one table_select, at most one soa_agg a bucket),
     kernels against the plain steps (r, g, H), H bitwise
     repeatable, device ms, each kernel's own device time and the fill
     kernels under torch.profiler, and no fill op on a tensor of A's
     shape;
  8. path 2a: run_lidar_ba with the window stage on (ladder 3's LiDAR
     settings, 200 frames / 2.0 M points; 20 windows at W=10, two anchor
     stages at W=20, every solve bucketed): every bucketed kernel must have
     run, the ATE must fall and land within 10% of the float64 CPU run;
     then the same pipeline in float64 on the card: every bucketed
     kernel's float64 instance must have run, and the ATE must land within
     1e-6 relative of the float64 CPU run's;
  9. path 2b: run_lidar_ba with the window stage off on the corridor
     (make_corridor_scene(512, 2000), five tiers at W=512): every bucketed
     kernel must have run, the poses must be finite; the ATE is printed
     beside the float64 CPU run's.  Stage 1's LM alone on the card must
     lower the residual and land within 1e-4 of the float64 CPU LM's
     residual; ms per LM iteration (building its frame tables included),
     the synchronizing calls equal to the iterations plus those of
     building the frame tables, the damped CG solve on the corridor's H as
     in phase 3, and the device's idle share under torch.profiler;
 9b. [cg_mf]: the same map through lm_damping_iter(reduced_solver="cg_mf")
     (the matrix-free rows route: kernels 4, 1, the per-entry chain at
     width K on the slot ids, 5; a 256-trip rows CG as one graph replay),
     the launch counts set to 0 just before: its residual within 1e-4 of
     the float64 CPU rows LM's; its poses' largest distance from the
     dense route's LM, ms per iteration and the rows solve's device ms.
Slice 4, large W (the banded Hessian, the split LM):
 11. path 2c: run_lidar_ba with the window stage off on the JAX bench's
     corridor make_corridor_scene(4096, 1000) (4.09 M points), path 2b's
     settings: both global stages must take the route split-banded (the
     loop's record: group Grams, no (6W)² H, the compact banded CG) and
     every banded kernel must have run (table_select, soa_agg,
     soa_chain_entries, entry_reduce); the poses finite, the ATE printed.
     Stage 1's LM alone on the card (3 iterations, the JAX bench's) must
     lower the residual and land within 1e-4 of the float64 CPU LM's on
     the same map; ms per iteration, peak device memory beside (6W)²·4 B,
     the synchronizing calls (the route's set-up reads, then one
     `converged` an iteration) and the idle share under torch.profiler.
     One evaluation and one solve's trips under torch.profiler with
     record_shapes: no op may take a (6W)²-element operand.  The group
     Grams' torch.bmm timed beside syrk_ a group at a time;
 12. [banded-cg]: the compact banded CG (96 done-masked trips, one CUDA
     graph) on stage 1's linearization: one solve under sync debug mode
     "error", two solves bitwise equal, within 1e-6 of the same trips run
     eagerly, the capture and device ms printed;
 13. [2c-dense]: the corridor at W = 2048 (the banded route with the dense
     H): the banded H against the dense-Gram evaluation's on the same map
     (r, g, H within 1e-4), two banded evaluations bitwise equal, the
     block forced to 16 (stragglers: syrk must launch) against the dense
     H too, and stage 1's LM (3 iterations, launch counts kept) against
     the float64 CPU LM as in phase 11.
Slice 3, the SIFT frontend:
 10. path 3: 48 renders of the box room (640 x 512, the reference camera)
     through extract_images (default SiftParams, batches of 4) and
     match_and_compact (all 1,128 pairs through top2_similarity, kernel 6),
     then build_components, with the launch counts set to 0 just before;
     device ms per image, ms per pair, the kernel's own device time under
     torch.profiler.  Checks: kernel 6 against its plain version on one
     chunk of pairs (values 1e-5, argmax identical except at top-2 gaps
     <= 1e-5), two calls bitwise equal, pairs alone bitwise equal to
     their outputs in the chunk, planted masks (leading, scattered,
     empty) under the same rule, a pair index outside the stack (-1 and
     NaN, no read), planted exact ties and a ragged tail bit for bit, the
     4-byte load path (D = 130 and D = 7 under the chunk's rules, and the
     chunk from a stack off 16-byte alignment bitwise equal to it), the
     match sets through the kernel and the plain matcher over all pairs
     (every difference within 1e-5 of a threshold or a tie, at most
     0.1%), the transfer error of consecutive pairs through the render's
     depth (median < 2 px, inlier share > 0.8), extraction on the card
     against the CPU in float32 (99% of each side's keypoints within 1e-2
     px of one on the other, and 99% of those pairs with descriptors
     within 1e-3), and a second extraction bitwise equal to the first.  The kernel (3xTF32 on the
     tensor cores) is timed in turns with torch.bmm of the chunk's
     product; its bound counts the valid products of the timed chunk,
     three TF32 products each at 495 TFLOP/s, the fp32 bound beside it.
Slice 10, the visual stage (no kernel of its own: the JAX package runs
it in XLA, the port in plain torch; its LiDAR stage runs the kernels):
 14. [visual-m1000] and [visual-m200]: the JAX bench's solver problems
     (bench.py:574-684, from the same numpy draws: M=1000 cameras, 20k
     points, 200k observations, 5 iterations; M=200, 2k points, 20k
     observations, 10 iterations) through solve_visual_ba's plan and loop
     on the card in float32: the route must be tier, the cost must fall,
     cost0 within 1e-5 and the final cost within 1e-3 relative of the
     float64 CPU run after the same iterations; two runs bitwise equal;
     the loop's synchronizing calls under sync debug mode "warn" equal to
     its iterations (the set-up's counted apart); one reduced solve step
     (damped assembly, the 48-trip point-major CG as one graph replay,
     back-substitution) under "error"; ms per iteration, the evaluation's,
     the step's and the CG's device ms, peak memory and the idle share
     under torch.profiler.  M=200 also in float64 on the card, within
     1e-6 relative of the CPU float64 run, the same iterations;
 15. [visual-routes]: the m200 generator at M = 100 (6M < 1024: auto
     gives lu) through lu, cg (the pair scatter, once in chunks of 50,000
     pairs), cg_mf (the per-observation matvec), cg_pm (the point-major
     matvec) and tier, in float64 on the card: each takes its route, and
     its cost0 and cost lie within 1e-8 relative of the same route's
     float64 CPU run, with the same iterations;
 16. [visual-e2e]: ladder 3 (make_joint_scene(200, 10000, 8,000
     landmarks, seed 13), odometry perturb_poses(truth, 0.003, 0.008, seed
     21), scripts/ladder3_e2e.py's LiDAR settings): run_lidar_ba on the
     card with the launch counts set to 0 just before (every bucketed
     kernel must run), its ATE below odometry's and within 10% of the
     float64 CPU run's; the kernels at this path's shapes (the first
     window's merged bucket at W = 10, global stage 2's buckets at the
     final anchor poses) against their plain versions as in [cg_mf]
     (table_select, soa_agg, soa_chain_entries, entry_reduce, the
     evaluation), and syrk_ on their chain rows (the split bitwise equal,
     the Gram within 1e-4 of syrk_plain_ and torch.matmul).  Then
     run_visual_ba on the card from its poses: the post-BA reprojection
     below the pre-BA one and below 1 px; against the float64 CPU run
     (fusion in float64) at the same 50 LM iterations, the tracks, tracks
     with a plane and observations within 1%, the post-BA reprojection
     within 2%, the final cost within 1e-3 relative.  The stage again in
     float64 on the card and on the CPU, both at 10 LM iterations (from
     ~15 on, two cameras seen once each follow the rounding): the card's
     cost and post px within 1e-6 relative of the CPU's.  The depth maps
     are rendered by the first run on each device: on the card by the
     z-buffer kernel (the launch counts set to 0 just before: one launch),
     on the CPU by numpy's _zbuffer_host; the later run on each reuses
     them, and the two sets differ in under 1e-3 of an image's pixels
     (bitwise, where the host's BLAS forms R p as the kernel does).  The
     stage times (depth, fuse, planes, solve), and the solve again alone,
     warm, on the stage's problem (equal cost; ms per iteration and the
     checks of phase 14).
Slice 11, the system (dataset IO, checkpoints, exports, the CLI):
 17. [system]: phase 16's scene and odometry written as a dataset in the
     reference's layout with the port's own writers (200 binary PCDs, the
     two TUM pose files, match.db from the scene's keypoints and matches,
     200 placeholder images: the db route reads no pixels, and the card's
     machine has no cv2; cfg.yaml with ladder 3's settings in float32 and
     the COLMAP export on) under build/system_smoke/, removed after.  Run
     A: LvbaSystem(cfg, out_dir=A).run_full_pipeline() on the card with
     the launch counts set to 0 just before (every bucketed kernel must
     run); the ATE within 10%, the post-BA reprojection below 1 px and
     within 2%, tracks and observations within 1% of phase 16's float64
     CPU runs; the tree: both checkpoints, 200 depth PNGs (decoded by
     load_depth_png: the camera's size, not all empty; the scene leaves
     a few views with no LiDAR point in range), Colmap/sparse/images.txt
     (400 lines) and points3D.txt (a line a track point),
     viz/tracks_{before,after}.pcd and metrics.json.  The kernels at
     run A's own solves' shapes, as in [visual-e2e] (run A's depth maps
     one z-buffer launch): the first window
     from the dataset's poses as read back from lidar_poses.txt
     ([system-window-kernels]) and global stage 2 at run A's final anchor
     poses ([system-global-kernels]; the TUM round trip moves where the
     LM stops, so these are not phase 16's buckets).  Run B: A's
     lidar_ba.npz and a truncated visual_ba.tmp.npz in a new directory,
     then `python -m global_lvba_tpu_torch run --config cfg.yaml --out B`
     in a fresh process on the card: its visual_ba.npz bitwise A's, its
     depth PNGs A's pixels.  Run C: the same command on A's tree (both
     stages resumed) prints A's mean reprojections exactly; `info`
     prints the config's dataclasses.asdict; `view` exits 1 with the
     hint (no open3d).  Each run's wall and stage times, and the time
     outside the stages (loading, checkpoints, depth PNGs, exports), are
     printed.
Slice 12, the multi-device layer (the machine has one card, so every
mesh lists cuda:0 several times):
 18. [mesh]: [mesh-dryrun] dryrun_multichip(8, devices=[cuda:0] * 8) in
     float64, every check sharded == local within 1e-8 (its launches the
     path mesh-dryrun); [mesh-shard-kernels] kernels 1, 2b, 3, 4 and 5
     against their plain versions at the last of 3 shards of the dry
     run's problem, padding rows included (_e2e_kernels), and their
     float64 instances at every one of the dry run's 8 shards; [mesh-w512]
     the bench's W=512 problem through lm_damping_iter_sharded, lu and
     cg, n = 1, 2, 4, 8, float32, against the local LM (residual within
     1e-4, ATE within 1%; one host read an iteration; ms an iteration and
     the idle share beside the local route's; the path mesh-w512), then
     kernels 1, 2 (aligned) and 3 against their plain versions at each of
     the 8 shards' shapes, padding rows included; [mesh-w4096]
     path 2c's stage-1 map through lm_damping_iter_banded_compact_sharded
     on 4 shards, 3 iterations, the local route's blocks: the residual
     within 1e-4 of the float64 CPU LM's, no (6W)²-element operand in one
     evaluation and one solve run eagerly, peak memory, ms an iteration
     beside the local split-banded LM, the kernels at every shard's
     shapes (padded groups included; the path mesh-w4096); [mesh-visual] [visual-m1000] on 4
     shards: the route _auto_solver(1000, pairs_sharded=True) names (cg),
     the cost within 1e-3 of the local float32 solve's; [mesh-spatial]
     distributed_voxel_moments over path 2a's 2.0 M points (world frame)
     on 8 shards == host_voxel_moments (keys and counts exactly, sums
     within 1e-4 of each column's max); [mesh-processes] two processes on
     cuda:0 through gloo and a world of one NCCL process, one sharded LM
     step each == the local one (this script with --mesh-worker); the dry
     run includes the gather-plan LM (single-device, as in the JAX
     package's).
Slice 13, the JAX package's opt-in large-W evaluations:
 19. [a3b]: [a3b-kernels] the group forms of kernels 1 and 2 at path 2c's
     aligned banded stacks (G groups of Vp voxels at 2B = 128: one
     table_select of the (G, 2B, 12) pose windows bitwise its plain
     version; soa_agg on the windows under phase 2's limits, bitwise equal
     to soa_agg on the per-entry rows and to itself; soa_chain_groups'
     rows within 1e-3, its (group, slot) entry rows within 1e-3, dead
     cells' rows exactly zero, repeats bitwise), each timed over the
     stacks beside its plain version and its bound; the float64 instances
     at the CPU tests' corridor (make_corridor_scene(48, 800), block 8)
     under TOL64; [a3b-2c-aligned] stage 1's LM on path 2c's map with
     lm.BANDED_ALIGNED (route split-banded-aligned) against the gather
     layout's (split-banded) in the same call, timed in turns: the
     residual within 1e-5, ms an iteration, set-up ms, peak memory,
     launches an evaluation, no (6W)² operand; [a3b-gather-2b] path 2b's
     stage-1 map with gather_tables=True (route gather) against the dense
     route the same way.  scripts/a3b_phase.py runs the phase alone.
Slice 14, the native host runtime and the card's z-buffer:
 20. [native]: [native-zbuffer] phase 16's depth stage (200 images, ~2.0 M
     covisible points each) in numpy (_zbuffer_host) and on the card (the
     grid map's keys by the native library, image_ranges on the host, one
     z-buffer launch), the card's parts timed (host ranges, upload, a
     call's device time, its kernels under torch.profiler, copy back);
     (a) the kernel against zbuffer_plain on the card, bitwise (else its
     share, below 1e-3), (b) against the
     numpy maps: per image the share of pixels off by more than 1e-6
     below 1e-3, (c) two launches bitwise, (d) the (piece, image) pairs
     and points the kernel's cull kept equal to its plain mirror's
     (kernels/zbuffer.py work), with the pairs it culled, and no
     synchronizing call in a call; the bound from work(): the operations
     the kept pairs need, the bytes once, and beside them the bytes the
     design asks of L2; [native-host]
     at path 2a's 2.0 M points the transform (within 1e-14 of max |w|),
     keys and argsort exactly (keys of the native transform that flip
     against numpy's counted), segment sums and moments (within 1e-12 of
     each max), every build_voxel_map of path 2a's run (plane counts and
     keys equal) and the plane lookup in turns numpy, native, native,
     numpy; build_components on ladder 3's match graph (the same tracks);
     LZF (the native decoder, the port's only one) on binary_compressed
     PCDs of path 2a's first 10 frames (the payloads byte for byte,
     read_pcd the clouds); [native-system] phase 17's run A with its host
     paths and depth maps numpy, then native: each wall.
Slice 15, images without cv2:
 21. [images]: make_plane_scene's box room rendered on the card through
     the reference camera unscaled (1280 x 1024) from 48 views along a
     sideways path (models/synthetic.room_views: 0.15 m a view, 2 m from
     the wall, so that track fusion's 8-degree view-angle rule keeps
     tracks; phase 10's sweep on a 0.6 m circle turns a ray by about 1
     degree a view; texture 32 cycles/m), written with the port's writers as colour PNGs
     whose three channels are different functions of the render, every
     8th view a 24-bit BMP, of the others every 3rd a baseline JPEG (the
     port's encode_jpeg: quality 95, 4:2:0; 14 views) and view 0 an
     Adam7-interlaced PNG (tests/png_writer.py); then one PNG view
     rewritten as a CMYK JPEG and another as an arithmetic-coded
     progressive JPEG (tests/jpeg_writer.py), and the first BMP view as an
     RLE8 BMP of its 256-colour quantisation (tests/bmp_writer.py), and
     the last baseline JPEG view cut at 80% of its bytes with no EOI (a
     killed recorder's file, read with libjpeg's recovery); with
     96 LiDAR frames of 10,000 points under perturbed odometry and
     cfg.yaml at the reference scale 0.5, the COLMAP export on and no
     match.db, under build/images_smoke/ (removed after).  Each PNG and
     BMP decoded by the port equals the array written (the Adam7 one and
     the quantised RLE8 one too), each JPEG lies within PSNR 40 dB of it
     (the cut one in its top half, whose data was kept) and decodes twice
     bitwise alike; the committed cv2 fixtures
     (tests/data/images/*, decodes.npz: progressive, 4:2:2, 4:1:1,
     restart-interval, gray, EXIF-6, block-smoothed, CMYK (PIL), YCCK,
     arithmetic-coded and lossless JPEGs, a 16-bit Adam7 PNG, 1-bit,
     565, RLE8, RLE4 and OS/2 BMPs; the damaged and unusual ones: cut
     baseline, progressive and arithmetic-coded JPEGs, one with a restart
     marker removed, a PNG with a bad ancillary CRC, a V5 BMP of 10-bit
     bit fields; gamma PNGs (RGB with sRGB, RGBA 16-bit with gAMA 22000,
     a palette with gAMA 45455), a PNG of IHDR filter method 64, an OS/2
     BMP of planes 0, an 8-bit gray and a 16-bit RGB PNG) decode bit for
     bit as cv2 decoded them, colour, gray and unchanged (imread_unchanged,
     and load_depth_png over two scales), and raise where cv2 read
     nothing; decode ms of each format
     (colour and gray) at 1280 x 1024 and of each fixture at its size,
     resize ms.  Then
     LvbaSystem.run_full_pipeline(images=[resize_linear(imread_color(p),
     640, 512) ...]) on the card with the launch counts set to 0 just
     before: top2_similarity (the SIFT fallback from the files), the
     LiDAR kernels, undistort once and colorize twice must launch; the
     post-BA reprojection below the pre-BA one and below 1 px; the tree:
     48 JPEGs (SOF0 640 x 512, a second encode of the kernel's images
     byte-equal), non-empty colored clouds, points3D.txt with a line a
     downsampled colored point, reproj/*.png and 48 track_features/*.png
     decoded by the port at 640 x 512.  SIFT device ms an image and the
     all-pairs match ms; the system's wall, stage and export times
     (undistort, JPEG, colorize, overlays, track images).  undistort and
     colorize on the run's images and poses: each bitwise its plain
     version on the card and two launches bitwise equal, a colorize call
     synchronizing once (its pick count and status read back), timed beside
     the plain version (undistort also beside grid_sample, float
     bilinear, not the same function; and its other routes, each
     bitwise in one launch: k1 = -0.4, whose corner tiles exceed the box
     cap, at 640 x 512 by TMA and at 333 x 257 by global taps, and the
     run's stack one byte off by global taps, timed) and the
     bound (undistort: bytes at
     3.35 TB/s; colorize: 43 float64 operations a window point at half
     the fp64 rate), each kernel's own device time under torch.profiler.
     scripts/images_phase.py runs the phase alone.
The line before the last lists the kernels as JSON (launches summed over
the paths' runs, each counted from 0: aligned, float64, 2a, 2a-float64,
2b, cg_mf, 2c, 2c-dense, frontend, visual-e2e, visual-e2e-stage, system,
mesh-dryrun, mesh-w512, mesh-w4096, a3b-aligned, a3b-gather, images);
the last line is
{"ok": true, "device": {...}}.  A copy of the results goes to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

FRAMES = 512
PPF = 2000
VOXEL = 1.0
RATIO = 0.2
REPS = 10
LM_ITERS = 10
SPIN_CYCLES = 10_000_000   # ~5 ms at 1.98 GHz; _timed raises it as needed

# published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12   # syrk's 3xTF32 products run at this rate
FP64_FLOP_PER_S = 34e12    # fp64 outside the tensor cores (same data sheet)
FP64_TC_FLOP_PER_S = 67e12  # fp64 on the tensor cores: the Gram's bound
# flops per (voxel, frame) cell, counted from csrc/soa_agg.cu (two passes)
# and csrc/soa_chain.cu (R·μ, R·Pc and the chain); per-voxel eigensolve
AGG_FLOPS_PER_CELL = 151
AGG_FLOPS_PER_VOXEL = 250
CHAIN_FLOPS_PER_CELL = 560

# Kernel vs plain version, both float32 on the card.  λ_min (residv) and
# the cost r are compared on every voxel.  On line-like voxels (λ1 − λ0 <
# 1e-2·λ2; 26 of the 1,634 voxels of this scene) the closed-form
# eigensolve is ill-conditioned in float32, in the plain version as much
# as in the kernel: λ comes from acos(r) with r near ±1, where acos' blows
# up, so λ_min keeps only about sqrt(eps) of λ_max, and u and the B rows
# swing with the last bits of the covariance.  λ_min is held there to
# 2·sqrt(eps_f32)·λ_max (its distance to float64 is printed for both
# versions), and u, B and the g/H of the evaluation are compared on the
# other voxels, where plain float32 agrees with float64 to ~1e-6;
# finiteness and the exact zeros of padded voxels are checked on all of
# them.  B1, B2 are compared through BᵀB (B1, B2 themselves are arbitrary
# within the plane when λ1 ≈ λ2, and only BᵀB reaches H).
WELL_CONDITIONED_GAP = 1e-2
TOL_RESIDV_REL = 1e-5    # λ_min, per voxel relative to its λ_max
TOL_RESIDV_REL_LINE = 2 * 2.0 ** -11.5   # 6.9e-4, the same on line-like voxels
TOL_PV = 1e-4            # u (sign aligned) abs; BᵀB, v̄, 1/N relative
TOL_ROWS_REL = 1e-3      # factor rows A, relative to max |A|: the chain
                         # cancels (H1 − R·hat(c)); the plain version's own
                         # float32-vs-float64 departure is printed beside it
TOL_SUM_REL = 1e-3       # g, Hd: voxel sums, relative to their max |.|
TOL_GRAM_REL = 1e-4      # AᵀA over 3V = 4,095 rows, relative to max |AᵀA|
# syrk's checks beyond the main path's operands: W = 45 (odd: N = 270) and a
# path-2a window's N = 60, both over 1,001 seeded rows (not a multiple of 32)
SYRK_RAGGED = ((1001, 270), (1001, 60))
# syrk_f64's ragged checks: those and N = 45 (odd: its 8-byte copies), and
# N = 270 from an operand 8 bytes off 16-byte alignment (the same path);
# 1,001 rows are not a multiple of its 16-row k-tile
SYRK64_RAGGED = ((1001, 270, 0), (1001, 60, 0), (1001, 45, 0),
                 (1001, 270, 1))
# soa_chain_entries' odd-W bucketed problem: at W = 45, 6W float32 values
# a row are not a multiple of 16 bytes, so A's rows start off 16-byte
# alignment
ODD_W = 45
# soa_chain's aligned widths off its 32-frame tile: W = 77 (odd: A's rows
# and the spans start off 16-byte alignment; a last tile of 13 frames)
# and W = 130 (a last tile of 2 frames), make_plane_scene(W, PPF), each
# taken aligned by the density gate
CHAIN_W_CASES = (77, 130)
# the earlier aligned chain design's time per W=512 evaluation (a thread a
# frame over 16 voxels, its partial sums added by torch; this script on an
# NVIDIA H100 80GB HBM3 at 700 W with that design): its wrapper's device
# ms (the torch sums included) and its kernel's under torch.profiler
CHAIN_EARLIER_MS = {"soa_chain": (0.0968, 0.0679),
                "soa_chain_f64": (0.1668, 0.1694)}
TOL_EVAL_REL = 1e-4      # r on all voxels; g, H on well-conditioned voxels
# The float64 instances against their plain float64 versions: the float32
# limits above scaled down by eps64 / eps32 = 2^-29 leave 1e-14 to 1e-12;
# these are ~1,000x wider, still 1e-5 of the float32 ones.  On line-like
# voxels λ_min keeps sqrt(eps64)·λ_max, as it keeps sqrt(eps32)·λ_max in
# float32.
TOL64_RESIDV_REL = 1e-11
TOL64_RESIDV_REL_LINE = 2 * 2.0 ** -26
TOL64_PV = 1e-9
TOL64_ROWS_REL = 1e-9     # factor rows and the per-entry channels
TOL64_SUM_REL = 1e-9      # g, Hd, entry_reduce
TOL64_GRAM_REL = 1e-11    # AᵀA relative to max |AᵀA|
# the ops that fill a tensor (torch.zeros and new_zeros end in zero_)
FILL_OPS = ("aten::zero_", "aten::fill_")
KERNEL_SYMBOLS = {"soa_agg": "soa_agg_kernel", "soa_chain": "soa_chain_kernel",
                  "syrk": "syrk_kernel", "syrk_split": "syrk_split_kernel",
                  "table_select": "table_select_kernel",
                  "soa_chain_entries": "soa_chain_entries_kernel",
                  "entry_reduce": "entry_reduce_kernel",
                  "top2_similarity": "top2_unit_kernel"}
ALIGNED_PATH_KERNELS = ("soa_agg", "soa_chain", "syrk", "syrk_split")
BUCKETED_PATH_KERNELS = ("table_select", "soa_agg", "soa_chain_entries",
                         "syrk", "syrk_split", "entry_reduce")
# the banded and rows routes (no full-width Gram without stragglers)
BANDED_PATH_KERNELS = ("table_select", "soa_agg", "soa_chain_entries",
                       "entry_reduce")
# a float64 solve: each kernel's double instance (no tf32 split)
ALIGNED_F64_KERNELS = ("soa_agg_f64", "soa_chain_f64", "syrk_f64")
BUCKETED_F64_KERNELS = ("table_select_f64", "soa_agg_f64",
                        "soa_chain_entries_f64", "syrk_f64",
                        "entry_reduce_f64")

# slice 2.  Path 2a: the window pipeline at ladder 3's scale
# (BASELINE.md:102), 2.0 M points
WINDOW_FRAMES = 200
WINDOW_PPF = 10_000
# the JAX package's float32 pipeline on the CPU at path 2a's settings and
# scene: ATE before -> after, m (a reference figure, not measured here)
JAX_2A_ATE = (0.01710, 0.00667)
# path 2b: the sparse corridor at full width, 1.02 M points
CORRIDOR_FRAMES = 512
CORRIDOR_PPF = 2000
# path 2b's stage-1 LM: final residual, card float32 vs CPU float64 (the
# card lands 4e-7 from float64 there in this script's runs)
TOL_RESID_LM_REL = 1e-4
# slice 4, large W (ROADMAP A3): path 2c is the JAX bench's W = 4096
# corridor (bench.py:501-571, 1,000 points a frame: 4.09 M), every solve
# bucketed -> split -> compact banded; [2c-dense] the corridor at W = 2048,
# the banded route with the dense H; SMALL_BLOCK forces stragglers there.
# Stage 1's LM runs the JAX bench's 3 iterations on the card and in
# float64 on the CPU (3 float64 CPU iterations take 13-21 s at W = 2048
# and 4096 on the card's host; 10 would add about a minute to each)
LARGE_FRAMES = 4096
LARGE_DENSE_FRAMES = 2048
LARGE_PPF = 1000
LARGE_LM_ITERS = 3
SMALL_BLOCK = 16
# the compact banded CG's step against the dense-H CG's on the same
# linearization: both float32, 96 trips, the same operator summed in
# another order; relative to max |x|
TOL_STEP_REL = 1e-3

# path 3, the SIFT frontend: views of the box room through the reference
# camera (CamConfig x scale 0.5: 640 x 512), default SiftParams (5 octaves,
# first octave -1, max_kp 2,048, two orientations), extraction in batches
# of 4, all pairs in chunks of 16 (match_all_pairs' default)
FRONTEND_VIEWS = 48
# value-noise texture at 16 cycles/m (6 cm features at the walls' 3.4-4.6 m,
# about 1,500 valid keypoints a view; the renderer's default 4.0 leaves
# about 100 above SiftGPU's contrast threshold)
FRONTEND_TEXTURE = 16.0
FRONTEND_BATCH = 4
FRONTEND_CHUNK = 16
FRONTEND_DISTMAX, FRONTEND_RATIOMAX = 0.7, 0.8   # SiftGPU's defaults
TOL_TOP2 = 1e-5            # fp32 dots of unit vectors, another order
MATCH_DIFF_SHARE = 1e-3    # kernel vs plain match sets
TOL_POS_PX = 1e-2          # extraction, card vs CPU keypoint positions
# descriptors of keypoints paired by position, card vs CPU float32: max
# abs difference per descriptor.  Entries are clipped at 0.2 before the
# last normalization; a keypoint that keeps its orientation moves its
# descriptor by ~1e-5 through fp32 blur sums in another order, one whose
# orientation peak flips between near-equal bins moves it by ~0.1
TOL_DESC = 1e-3
EXTRACT_SHARE = 0.99       # both directions, and descriptors

# slice 10, the visual stage.  The JAX bench's solver problems
# (bench.py:574-684) and their iterations: M=1000 (20k points, 200k
# observations) and M=200 (2k points, 20k observations)
VISUAL_BENCH = (("m1000", 5), ("m200", 10))
TOL_VISUAL_COST0 = 1e-5    # card float32 vs CPU float64, relative
TOL_VISUAL_COST = 1e-3     # the final cost after the same iterations
TOL_VISUAL_F64 = 1e-6      # card float64 vs CPU float64
# [visual-routes]: the m200 generator at M = 100 (6M < 1024: auto gives
# lu) through every route in float64, card vs CPU; the chunked pair
# scatter in chunks of 50,000 of its 200,000 pairs
VISUAL_ROUTE_CAMS = 100
VISUAL_ROUTE_ITERS = 5
VISUAL_ROUTE_CHUNK = 50_000
TOL_VISUAL_ROUTE = 1e-8
# [visual-e2e]: ladder 3 (scripts/ladder3_e2e.py), 200 frames of 10,000
# points, 200 images of 8,000 landmarks.  The JAX package's figures on a
# TPU (BASELINE.md:102): reprojection 0.903 -> 0.302 px, 12.0k tracks,
# 59.1k observations (parity targets, not time targets)
E2E_FRAMES = 200
E2E_PPF = 10_000
E2E_LANDMARKS = 8000
JAX_E2E_REPROJ = (0.903, 0.302)
TOL_E2E_COUNT = 0.01       # tracks and observations, card vs CPU float64
TOL_E2E_POST = 0.02        # the post-BA reprojection, the same
# the float64 stage, card vs CPU, runs 10 LM iterations: two cameras of
# the stage's problem carry one observation each, their poses are free
# but for the damping, and from iteration ~15 their paths follow the
# rounding (two float64 CPU runs, 1 and 4 threads, agree to 1e-16 in cost
# at 10 iterations and differ by 3e-6 at 50, one camera by 0.36 rad)
E2E_FLOAT64_ITERS = 10
# [system]: each CLI process's limit (run B is about one visual stage)
SYSTEM_CLI_TIMEOUT_S = 300

# slice 12, the multi-device layer (phase 18): every mesh lists cuda:0
# several times (the machine has one card)
MESH_DRYRUN_N = 8
MESH_W512_NS = (1, 2, 4, 8)
MESH_W4096_N = 4
MESH_VISUAL_N = 4
MESH_SPATIAL_N = 8
MESH_KERNELS_N = 3         # the shard whose kernels are checked pads
TOL_MESH_RESID = 1e-4      # float32 sharded vs local, relative
TOL_MESH_ATE = 1e-2        # float32 sharded vs local ATE, relative
TOL_MESH_VISUAL = 1e-3     # float32 sharded cg vs the local tier route
TOL_MESH_SPATIAL = 1e-4    # float32 Σx, Σxxᵀ vs the host's float64 sums,
                           # relative to each column's max |.|
MESH_PROC_TIMEOUT_S = 300
# what later phases reuse of earlier ones (path 2a's clouds and poses,
# path 2c's voxel map), kept out of the JSON results
KEEP = {}


def _fail(msg):
    raise AssertionError(msg)


def _rel(a, b):
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / (scale if scale > 0 else 1.0)


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def _timed(torch, fn, reps=REPS):
    """Device ms per call of fn(): after two warm-up calls, `reps` calls are
    queued behind a spin kernel and CUDA events bracket them.  The host has
    queued every call before the device reaches the first, so host time
    between launches does not show; where it had not (the start event
    already passed when the host was done), the spin is made longer and
    the run repeated.  Returns (ms, queued_ahead)."""
    fn()
    fn()
    torch.cuda.synchronize()
    spin = SPIN_CYCLES
    for _ in range(6):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        ahead = not t0.query()
        torch.cuda.synchronize()
        if ahead:
            break
        spin *= 4
    return t0.elapsed_time(t1) / reps, ahead


def _times(torch, name, kernel, plain, library=None):
    """Device ms per evaluation of a kernel's wrapper, its plain version and
    the library call (None where there is none), printed."""
    out, ahead = {}, {}
    for key, fn in (("ms", kernel), ("plain_ms", plain),
                    ("library_ms", library)):
        if fn is None:
            out[key] = None
            continue
        out[key], ahead[key] = _timed(torch, fn)
    print(f"[{name}] device ms per evaluation: {out}; every call queued "
          f"ahead of the device: {ahead}", flush=True)
    out["queued_ahead"] = ahead
    return out


def _bound(nbytes, flops, rate=FP32_FLOP_PER_S):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = flops / rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _syrk_bounds(As, N):
    """syrk's bound over the operands As (Kr_i, N), each into its own gram
    read and written: 3·Kr·N·(N+1) flops at the TF32 rate (3xTF32), and the
    fp32 bound it replaced (Kr·N·(N+1) at the fp32 rate), with the
    fp32-equivalent flops Kr·N·(N+1)."""
    kr = sum(A.shape[0] for A in As)
    nbytes = kr * N * 4 + len(As) * 2 * N * N * 4
    flops = kr * N * (N + 1)
    return (_bound(nbytes, 3 * flops, TF32_FLOP_PER_S), _bound(nbytes, flops),
            flops)


def _split_bound(As):
    """tf32_split's bound: A read once, hi and lo (Np, Krp) written."""
    from global_lvba_tpu_torch.kernels.gram import padded_shape
    nbytes = sum(A.numel() * 4 + 2 * 4 * math.prod(padded_shape(*A.shape))
                 for A in As)
    return _bound(nbytes, 0)


def _dmma_count(build):
    """DMMA instructions in syrk_f64_kernel's SASS in the built library
    (cuobjdump -sass), and their distinct opcodes."""
    tool = Path(build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(build.library("syrk"))],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    count, ops, inside = 0, set(), False
    for line in out.splitlines():
        if "Function :" in line:
            inside = "syrk_f64_kernel" in line
        elif inside and "DMMA" in line:
            count += 1
            ops.update(w for w in line.replace(";", " ").split()
                       if w.startswith("DMMA"))
    return count, sorted(ops)


def _kernel_times(prof_eval, names):
    """{launcher: (device ms, launches)} in a torch.profiler run: each
    kernel by its symbol, a float64 instance (`_f64`) by the `double` in
    its signature and a float32 one by its absence."""
    out = {}
    for name in names:
        f64 = name.endswith("_f64")
        sym = ("syrk_f64_kernel" if name == "syrk_f64"
               else KERNEL_SYMBOLS[name[:-4] if f64 else name])
        hits = [v for k, v in prof_eval.items()
                if sym in k and ("double" in k) == f64]
        if hits:
            out[name] = (sum(h[0] for h in hits), sum(h[1] for h in hits))
    return out


def _planted(torch, args):
    """Chain arguments (n, mu, Pc, poses, frame, pv, W) with the frame ids
    -1, W and W + 3 planted in a live entry of each of the first three
    voxels that have one (no row may be written for them)."""
    n, frame, W = args[0], args[4], args[6]
    f = frame.clone()
    live = n > 0
    vs = torch.nonzero(live.any(dim=1)).reshape(-1)[:3].tolist()
    if len(vs) < 3:
        _fail("too few live voxels to plant frame ids in")
    for v, bad in zip(vs, (-1, W, W + 3)):
        f[v, int(torch.nonzero(live[v]).reshape(-1)[0])] = bad
    return args[:4] + (f,) + args[5:]


def _odd_w_args(torch, dev):
    """Chain arguments of an odd-width bucketed problem, every bucket of
    make_corridor_scene(ODD_W, CORRIDOR_PPF) at its perturbed poses
    (float32; the pose rows of one table_select_buckets call, pv from
    soa_agg), with the buckets' frame ids and the pose table."""
    from global_lvba_tpu_torch.__main__ import slice_config
    from global_lvba_tpu_torch.factors.padding import buckets_to_device
    from global_lvba_tpu_torch.factors.plane_eigen import (
        PlaneFactorArrays, pose_table)
    from global_lvba_tpu_torch.kernels.selection import table_select_buckets
    from global_lvba_tpu_torch.kernels.soa import soa_agg
    from global_lvba_tpu_torch.map.voxelize import build_voxel_map
    from global_lvba_tpu_torch.models.synthetic import (
        make_corridor_scene, perturb_poses)

    cfg = slice_config("float32")
    sc = make_corridor_scene(ODD_W, CORRIDOR_PPF, seed=0)
    Rp, pp = perturb_poses(sc.R_true, sc.p_true, 0.003, 0.01, seed=1)
    vm = build_voxel_map(sc.points_body, sc.frame_ids, Rp, pp, VOXEL,
                         eigen_ratios=[RATIO] * 4, min_ps=cfg.solver.min_ps,
                         layer_limit=cfg.solver.layer_limit)
    bs = buckets_to_device(vm, W=ODD_W, dtype=torch.float32, device=dev)
    if not all(isinstance(fa, PlaneFactorArrays) for fa in bs):
        _fail(f"W={ODD_W}: the density gate does not pick the bucketed "
              f"layout")
    pose12 = pose_table(
        torch.as_tensor(Rp, dtype=torch.float32, device=dev),
        torch.as_tensor(pp, dtype=torch.float32, device=dev))
    frames = [fa.frame.reshape(-1) for fa in bs]
    out = []
    for fa, rows in zip(bs, table_select_buckets(frames, pose12)):
        poses = rows.view(*fa.n.shape, 12)
        pv = soa_agg(fa.n, fa.mu, fa.Pc, poses)[1]
        out.append((fa.n, fa.mu, fa.Pc, poses, fa.frame, pv, ODD_W))
    return out, frames, pose12


def _select_check(torch, name, frames, tbl, odd):
    """table_select_buckets over every bucket's ids `frames` with the pose
    table tbl: one launch (counted), each bucket's rows bitwise equal to
    table_select_plain of its ids and to torch.index_select; again with
    the ids -1, P and P + 3 planted in every bucket (zero rows there, the
    other rows unchanged); and on the W = ODD_W corridor's buckets (`odd`:
    its frames and table).  Returns the rows."""
    from global_lvba_tpu_torch.kernels import build
    from global_lvba_tpu_torch.kernels.selection import (
        LAUNCHES, table_select_buckets, table_select_plain)

    def exact(rows, fs, t):
        P = t.shape[0]
        ok = True
        for r, f in zip(rows, fs):
            valid = (f >= 0) & (f < P)
            ok &= bool(torch.equal(r, table_select_plain(f, t))
                       and torch.equal(r[valid], torch.index_select(
                           t, 0, f[valid].long()))
                       and not r[~valid].any())
        return ok

    key = build.dtype_launcher("table_select", tbl.dtype)
    before = LAUNCHES[key]
    rows = table_select_buckets(frames, tbl)
    launches = LAUNCHES[key] - before
    torch.cuda.synchronize()
    same = exact(rows, frames, tbl)
    P = tbl.shape[0]
    planted, spots = [], []
    for f in frames:
        g = f.clone()
        i = torch.tensor([0, f.numel() // 2, f.numel() - 1], device=f.device)
        g[i] = torch.tensor([-1, P, P + 3], dtype=g.dtype, device=g.device)
        planted.append(g)
        spots.append(i)
    rows_p = table_select_buckets(planted, tbl)
    keep = True
    for r, rp, i in zip(rows, rows_p, spots):
        m = torch.ones(r.shape[0], dtype=torch.bool, device=r.device)
        m[i] = False
        keep &= bool(torch.equal(r[m], rp[m]) and not rp[i].any())
    planted_ok = keep and exact(rows_p, planted, tbl)
    odd_ok = exact(table_select_buckets(odd[0], odd[1]), odd[0], odd[1])
    print(f"[{name}] the {len(frames)} buckets in one table_select_buckets "
          f"call ({launches} launch): bitwise equal to table_select_plain "
          f"and torch.index_select: {same}; ids -1, P, P + 3 planted in "
          f"every bucket give zero rows, the rest unchanged: {planted_ok}; "
          f"the W={ODD_W} corridor's {len(odd[0])} buckets: {odd_ok}",
          flush=True)
    if not (launches == 1 and same and planted_ok and odd_ok):
        _fail(f"{name}: table_select_buckets disagrees with the plain "
              f"selection or took {launches} launches")
    return rows


def _to_f64(torch, args):
    """Chain arguments in float64, pv recomputed by soa_agg in float64."""
    from global_lvba_tpu_torch.kernels.soa import soa_agg

    out = []
    for n, mu, Pc, poses, frame, _, W in args:
        x = tuple(t.double() for t in (n, mu, Pc, poses))
        out.append(x + (frame, soa_agg(*x)[1], W))
    return out


def _chain_entries_full_write(torch, label, args, tol):
    """soa_chain_entries (float32 or float64) on each chain-argument tuple
    (n, mu, Pc, poses, frame, pv, W), its A allocated by the wrapper's
    torch.empty right after the caching allocator was handed back a block
    of A's size filled with NaN: A must take that block, hold no NaN, be
    exactly zero off the cells of the live entries with frame ids in
    [0, W), and agree with soa_chain_entries_plain (A and vals) within tol
    relative to each one's max |.|."""
    from global_lvba_tpu_torch.kernels.soa import (
        soa_chain_entries, soa_chain_entries_plain)

    err_A = err_v = 0.0
    reused = clean = 0
    for a in args:
        n, frame, W = a[0], a[4], a[6]
        V, K = n.shape
        vals = torch.empty((V * K, 30), dtype=n.dtype, device=n.device)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        nan = torch.full((3 * V, 6 * W), float("nan"), dtype=n.dtype,
                         device=n.device)
        ptr = nan.data_ptr()
        del nan
        A, _ = soa_chain_entries(*a, vals=vals)
        Ap, vp = soa_chain_entries_plain(*a)
        torch.cuda.synchronize()
        f = frame.long()
        vi, ki = torch.nonzero((n > 0) & (f >= 0) & (f < W), as_tuple=True)
        on = torch.zeros((V, W), dtype=torch.bool, device=n.device)
        on[vi, f[vi, ki]] = True
        off = (~on)[:, None, :, None].expand(V, 3, W, 6)
        reused += A.data_ptr() == ptr
        clean += bool(~A.isnan().any()) and bool(
            (A.view(V, 3, W, 6)[off] == 0).all())
        err_A = max(err_A, _rel(A, Ap))
        err_v = max(err_v, _rel(vals, vp))
    print(f"[{label}] {len(args)} calls, A over a NaN-filled block: block "
          f"reused {reused}/{len(args)}, no NaN and exact zeros off the "
          f"entries' cells {clean}/{len(args)}; rel err vs the plain "
          f"version: A {err_A:.3e}, vals {err_v:.3e} (tol {tol})",
          flush=True)
    if not (reused == clean == len(args) and err_A <= tol and err_v <= tol):
        _fail(f"{label}: soa_chain_entries does not write A in full or "
              f"disagrees with its plain version")


def _chain_bounds(ns, W, itemsize):
    """soa_chain's bounds over the chunks whose n are `ns`, one launch each
    with the running sums: "bound" by the bytes the function needs (n of
    every cell; μ and Pc's upper triangle, 9 values, of a live cell: a dead
    cell adds nothing and its rows are zeros; pv's 13 used values a voxel;
    A's 18 values a cell written; the pose table and g and Hd, 42 values a
    frame read and written, once a launch) and the live cells' chains;
    "bound_layout" by the layout's bytes (13 values a cell, 16 a voxel)
    and every cell's chain."""
    cells = sum(n.numel() for n in ns)
    live = sum(int((n > 0).sum()) for n in ns)
    vox = sum(n.shape[0] for n in ns)
    fixed = len(ns) * W * (12 + 2 * 42)
    rate = FP32_FLOP_PER_S if itemsize == 4 else FP64_FLOP_PER_S
    return (_bound((cells + live * 9 + vox * 13 + cells * 18 + fixed)
                   * itemsize, live * CHAIN_FLOPS_PER_CELL, rate),
            _bound((cells * 13 + vox * 16 + cells * 18 + fixed) * itemsize,
                   cells * CHAIN_FLOPS_PER_CELL, rate))


def _chain_evaluation(chain, ops, pose12, pvs):
    """The chain over an evaluation's voxel chunks as
    plane_eigen._aligned_pass calls it: the first chunk stores the voxel
    sums, the others add to them.  Returns ([A], g, Hd)."""
    g = Hd = None
    As = []
    for o, q in zip(ops, pvs):
        A, g, Hd = chain(*o, pose12, q, g, Hd)
        As.append(A)
    return As, g, Hd


def _chain_check(torch, name, ops, pose12, pvs, tol_rows, tol_sum):
    """soa_chain over an evaluation's chunks (_chain_evaluation) against
    soa_chain_plain doing the same: rows, g and Hd relative to each one's
    max |.|; the rows of dead cells (n == 0, padded voxels included)
    exactly zero; two runs bitwise equal (A, g and Hd).  Returns (rows
    rel err, g rel err, Hd rel err, max abs row err)."""
    from global_lvba_tpu_torch.kernels.soa import soa_chain, soa_chain_plain

    k1 = _chain_evaluation(soa_chain, ops, pose12, pvs)
    k2 = _chain_evaluation(soa_chain, ops, pose12, pvs)
    p = _chain_evaluation(soa_chain_plain, ops, pose12, pvs)
    torch.cuda.synchronize()
    W = pose12.shape[0]
    err_A = max(_rel(a, b) for a, b in zip(k1[0], p[0]))
    abs_A = max(float((a - b).abs().max()) for a, b in zip(k1[0], p[0]))
    err_g, err_hd = _rel(k1[1], p[1]), _rel(k1[2], p[2])
    rep = all(torch.equal(a, b) for a, b in
              zip(k1[0] + [k1[1], k1[2]], k2[0] + [k2[1], k2[2]]))
    dead = all(bool((A.view(-1, 3, W, 6)[(o[0] <= 0)[:, None, :, None]
                                           .expand(-1, 3, W, 6)] == 0).all())
               for A, o in zip(k1[0], ops))
    print(f"[{name}] W={W}, {len(ops)} chunks with the running sums: rows "
          f"rel err {err_A:.3e} (tol {tol_rows}); g {err_g:.3e}, Hd "
          f"{err_hd:.3e} (tol {tol_sum}); dead cells' rows == 0: {dead}; "
          f"two runs bitwise equal (A, g, Hd): {rep}", flush=True)
    if not (err_A <= tol_rows and err_g <= tol_sum and err_hd <= tol_sum
            and dead and rep):
        _fail(f"{name} at W={W} disagrees with soa_chain_plain, writes a "
              f"dead cell's row or is not repeatable")
    return err_A, err_g, err_hd, abs_A


def _chain_widths(torch, dev, name, dtype, tol_rows, tol_sum):
    """_chain_check at the widths CHAIN_W_CASES: make_plane_scene(W, PPF)
    at its perturbed poses, voxelized as the main path, each required to
    take the aligned layout (picks_aligned); pv from soa_agg."""
    from global_lvba_tpu_torch.__main__ import slice_config
    from global_lvba_tpu_torch.factors.padding import (
        buckets_to_device, picks_aligned)
    from global_lvba_tpu_torch.factors.plane_eigen import (
        pose_table, voxel_chunks)
    from global_lvba_tpu_torch.kernels.soa import soa_agg
    from global_lvba_tpu_torch.map.voxelize import build_voxel_map
    from global_lvba_tpu_torch.models.synthetic import (
        make_plane_scene, perturb_poses)

    cfg = slice_config("float32")
    for W in CHAIN_W_CASES:
        sc = make_plane_scene(num_frames=W, points_per_frame=PPF, seed=0)
        Rp, pp = perturb_poses(sc.R_true, sc.p_true, 0.003, 0.01, seed=1)
        vm = build_voxel_map(sc.points_body, sc.frame_ids, Rp, pp, VOXEL,
                             eigen_ratios=[RATIO] * 4,
                             min_ps=cfg.solver.min_ps,
                             layer_limit=cfg.solver.layer_limit)
        if not picks_aligned(vm, W):
            _fail(f"W={W}: the density gate does not pick the aligned layout")
        fa = buckets_to_device(vm, W=W, dtype=dtype, device=dev)[0]
        pose12 = pose_table(torch.as_tensor(Rp, dtype=dtype, device=dev),
                            torch.as_tensor(pp, dtype=dtype, device=dev))
        pv = soa_agg(fa.n, fa.mu, fa.Pc, pose12)[1]
        chunks = voxel_chunks(fa.n.shape[0], W)
        _chain_check(torch, name, [(fa.n[lo:hi], fa.mu[lo:hi], fa.Pc[lo:hi])
                                   for lo, hi in chunks], pose12,
                     [pv[lo:hi] for lo, hi in chunks], tol_rows, tol_sum)


def _chain_launches(torch, name, ops, pose12, pvs):
    """Each launch of one aligned evaluation's chain timed alone (device
    ms, with the running sums, as the evaluation makes it) beside its
    bounds; printed, returned."""
    from global_lvba_tpu_torch.kernels.soa import soa_chain

    W, dt = pose12.shape[0], pose12.dtype
    g = torch.zeros((W, 6), dtype=dt, device=pose12.device)
    Hd = torch.zeros((W, 6, 6), dtype=dt, device=pose12.device)
    out = []
    for o, q in zip(ops, pvs):
        ms, ahead = _timed(torch, lambda: soa_chain(*o, pose12, q, g, Hd))
        bound, layout = _chain_bounds([o[0]], W, dt.itemsize)
        out.append(dict(voxels=int(o[0].shape[0]), ms=ms, queued_ahead=ahead,
                        bound=bound, bound_layout=layout))
    old = CHAIN_EARLIER_MS[name]
    rows = [(d["voxels"], round(d["ms"], 4), round(d["bound"][0], 4),
             round(d["bound_layout"][0], 4)) for d in out]
    print(f"[{name}] each launch alone, (voxels, device ms, bound over the "
          f"live cells' bytes, the layout's): {rows}; "
          f"sum {sum(d['ms'] for d in out):.4f} ms; the earlier design took "
          f"{old[0]} ms an evaluation, its kernel {old[1]} (CHAIN_EARLIER_MS)",
          flush=True)
    return out


def _sum_shapes(prof):
    """The input shapes of the aten::sum ops a torch.profiler run (with
    record_shapes) saw."""
    return [tuple(e.input_shapes[0]) for e in prof.events()
            if e.name == "aten::sum" and e.input_shapes
            and e.input_shapes[0]]


def _no_partial_sums(prof, tag):
    """One aligned evaluation under torch.profiler: its only aten::sum ops
    are the residuals' (1-D); a sum of the chain's partials by torch (the
    earlier design's (blocks, 30, W)) fails.  The profile must have recorded
    at least the residuals' sum."""
    shapes = _sum_shapes(prof)
    print(f"[{tag}] aten::sum ops in one aligned evaluation, by input "
          f"shape: {shapes}", flush=True)
    if not shapes:
        _fail(f"{tag}: the profile recorded no aten::sum's shape: the check "
              f"that no sum of the chain's partials runs saw nothing")
    if any(len(sh) != 1 for sh in shapes):
        _fail(f"{tag}: the aligned evaluation sums a tensor of shape "
              f"{shapes} in torch: the chain's voxel sums left the kernel")
    return shapes


def _syrk_check(torch, label, As, N):
    """syrk_ over the operands As into one gram: the tf32 split bitwise
    equal to its plain version; the Gram within TOL_GRAM_REL of
    syrk_plain_ and of torch.matmul (relative to max |AᵀA|), exactly
    symmetric, and bitwise equal over two runs.  Returns the max abs
    difference to syrk_plain_."""
    from global_lvba_tpu_torch.kernels.gram import (
        syrk_, syrk_plain_, tf32_split, tf32_split_plain)
    split_same = True
    for A in As:
        for k, p in zip(tf32_split(A), tf32_split_plain(A)):
            split_same &= bool(torch.equal(k.view(torch.int32),
                                           p.view(torch.int32)))
    dev = As[0].device
    gk = torch.zeros((N, N), dtype=torch.float32, device=dev)
    gk2, gp = torch.zeros_like(gk), torch.zeros_like(gk)
    for A in As:
        syrk_(gk, A)
        syrk_(gk2, A)
        syrk_plain_(gp, A)
    gl = sum(torch.matmul(A.T, A) for A in As)
    torch.cuda.synchronize()
    err_p, err_l = _rel(gk, gp), _rel(gk, gl)
    sym, rep = bool(torch.equal(gk, gk.T)), bool(torch.equal(gk, gk2))
    print(f"[syrk] {label}, {sum(A.shape[0] for A in As)} rows x {N} "
          f"columns: tf32 split bitwise equal to tf32_split_plain: "
          f"{split_same}; rel err vs syrk_plain_ {err_p:.3e}, vs "
          f"torch.matmul {err_l:.3e} (tol {TOL_GRAM_REL}); exactly "
          f"symmetric: {sym}; two runs bitwise equal: {rep}", flush=True)
    if not (split_same and err_p <= TOL_GRAM_REL and err_l <= TOL_GRAM_REL
            and sym and rep):
        _fail(f"syrk_ disagrees with AᵀA on the {label} operand")
    return float((gk - gp).abs().max())


def _cg_check(torch, tag, H, g, u, capture=False):
    """The LM's damped CG solve (LIDAR_CG_ITERS done-masked trips, one
    CUDA graph replay on the card).  With capture, the graph cache is
    emptied first and the capture timed.  One solve is queued under sync
    debug mode "error", so a read to the host raises; two solves must be
    bitwise equal, finite, and within 1e-6 of the same trips run eagerly
    (relative to max |x|).  Device ms per solve, graph and eager."""
    from global_lvba_tpu_torch.solver import dist_solve
    from global_lvba_tpu_torch.solver.lm import LIDAR_CG_ITERS

    out = {}
    n, it = H.shape[0], LIDAR_CG_ITERS
    if capture:
        dist_solve._GRAPHS.clear()
        torch.cuda.synchronize()
        out["capture_s"] = dist_solve.cg_graph(n, H.dtype, H.device,
                                               max_iters=it).capture_s
    x1 = dist_solve.solve_damped_cg(H, g, u, max_iters=it)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        x2 = dist_solve.solve_damped_cg(H, g, u, max_iters=it)
        out["host_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    x_e = dist_solve._damped_cg(H, g, u, 6, it, 1e-10)
    torch.cuda.synchronize()
    same = bool(torch.equal(x1, x2) and torch.isfinite(x1).all())
    err = _rel(x1, x_e)
    out["ms"], ahead = _timed(torch, lambda: dist_solve.solve_damped_cg(
        H, g, u, max_iters=it))
    out["eager_ms"], ahead_e = _timed(
        torch, lambda: dist_solve._damped_cg(H, g, u, 6, it, 1e-10))
    out.update(repeatable=same, eager_rel=err,
               eager_bitwise=bool(torch.equal(x1, x_e)))
    cap = (f"graph captured in {out['capture_s'] * 1e3:.1f} ms; "
           if capture else "")
    print(f"[{tag}] damped block-Jacobi CG solve (6W = {n}, {it} "
          f"done-masked trips, one CUDA graph replay): {cap}"
          f"{out['ms']:.3f} ms device time (queued ahead {ahead}), the same "
          f"trips run eagerly {out['eager_ms']:.3f} ms (queued ahead "
          f"{ahead_e}); one solve queued in {out['host_ms']:.3f} ms of host "
          f"time under sync debug mode \"error\"; two solves bitwise equal "
          f"and finite: {same}; graph vs eager rel diff {err:.3e} (bitwise "
          f"{out['eager_bitwise']})", flush=True)
    if not (same and err <= 1e-6):
        _fail(f"{tag}: the damped CG solve is not repeatable or departs "
              f"from its eager trips")
    return out


# the source lines of the synchronizing calls of _count_syncs' last run
SYNC_SITES = {}


def _count_syncs(torch, run):
    """(run()'s result, the synchronizing calls it made): run under sync
    debug mode "warn" with the warnings recorded ("always": repeats from
    one line count too)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # torch's one-time notice on the first call of set_sync_debug_mode
    # ("Synchronization debug mode is a prototype feature and does not
    # yet detect all synchronizing operations") is not a synchronizing call
    sync = [w for w in caught if "synchronizing" in str(w.message)
            and "debug mode is a prototype" not in str(w.message)]
    SYNC_SITES.clear()
    SYNC_SITES.update(collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in sync))
    return res, len(sync)


def _lm_syncs(torch, tag, run, tables=None):
    """run() (an lm_damping_iter call) under sync debug mode "warn": the
    LM reads `converged` once per iteration and nothing else, but for
    building its buckets' frame tables when `tables` (a function that
    builds them) is given; its synchronizing calls must equal its
    iterations plus those of tables().  Returns the count."""
    extra = _count_syncs(torch, tables)[1] if tables is not None else 0
    res, syncs = _count_syncs(torch, run)
    print(f"[{tag}] lm_damping_iter under sync debug mode \"warn\": "
          f"{syncs} synchronizing calls in {res.iters} iterations (one "
          f"read of `converged` each) + {extra} of building the frame "
          f"tables", flush=True)
    if syncs != res.iters + extra:
        _fail(f"{tag}: the LM synchronized {syncs} times in {res.iters} "
              f"iterations, with {extra} for its frame tables")
    return syncs


def _times_in_turns(torch, name, kernel, plain, library):
    """_times, with the kernel and the library call timed again in the
    reverse order (kernel, plain, library, library, kernel); ms and
    library_ms are the means of their two readings."""
    out = _times(torch, name, kernel, plain, library)
    lib2, ahead_l = _timed(torch, library)
    ms2, ahead_k = _timed(torch, kernel)
    out["readings"] = dict(ms=[out["ms"], ms2],
                           library_ms=[out["library_ms"], lib2])
    out["ms"] = (out["ms"] + ms2) / 2
    out["library_ms"] = (out["library_ms"] + lib2) / 2
    out["queued_ahead"].update(ms_2=ahead_k, library_ms_2=ahead_l)
    print(f"[{name}] in turns (kernel, library, library, kernel): "
          f"{out['readings']}", flush=True)
    return out


def _top2_compare(torch, out_k, out_p, d, v, ia, ib):
    """top2_similarity's outputs against its plain version's on the pairs
    (d[ia], d[ib]) with masks v: (max abs value error, rows and columns
    whose argmax differs, those of them with a top-2 gap > TOL_TOP2)."""
    a, b = ia.long(), ib.long()
    sim = torch.bmm(d[a], d[b].transpose(1, 2))
    sim = torch.where(v[a][:, :, None] & v[b][:, None, :], sim,
                      torch.full_like(sim, -2.0))
    col2 = torch.topk(sim, 2, dim=1).values
    row_gap = out_p[0][..., 0] - out_p[0][..., 1]
    col_gap = col2[:, 0] - col2[:, 1]
    row_diff = out_k[1] != out_p[1]
    col_diff = out_k[2] != out_p[2]
    return (float((out_k[0] - out_p[0]).abs().max()), int(row_diff.sum()),
            int(col_diff.sum()), int((row_diff & (row_gap > TOL_TOP2)).sum()),
            int((col_diff & (col_gap > TOL_TOP2)).sum()))


def _pv_errors(torch, k, p):
    """(u abs err with signs aligned, BᵀB rel err, [v̄, 1/N] rel err)."""
    s = torch.sign((k[:, :3] * p[:, :3]).sum(1, keepdim=True))
    u = (k[:, :3] * torch.where(s == 0, torch.ones_like(s), s) - p[:, :3])

    def btb(q):
        return (q[:, 3:6, None] * q[:, None, 3:6]
                + q[:, 6:9, None] * q[:, None, 6:9])

    return (float(u.abs().max()), _rel(btb(k), btb(p)),
            _rel(k[:, 9:13], p[:, 9:13]))


def _spectrum(torch, fa, pose12):
    """((λ1 − λ0) / λ2, λ0, λ2) per voxel, in float64."""
    from global_lvba_tpu_torch.factors.plane_eigen import (
        _moment_channels, _pose_channels, _soa_agg)
    from global_lvba_tpu_torch.ops.eigh3 import eigvals3_soa

    d = torch.float64
    mu3, P6 = _moment_channels(fa.mu.to(d), fa.Pc.to(d))
    R9, p3 = _pose_channels(pose12.to(d))
    cov6 = _soa_agg(fa.n.to(d), mu3, P6, R9, p3)[-1]
    lam0, lam1, lam2 = eigvals3_soa(*cov6)
    return (lam1 - lam0) / lam2.abs().clamp(min=1e-30), lam0, lam2


def _device_ms(prof):
    """{key: (device ms summed over calls, calls)} of a torch.profiler run,
    from each key's own device time (empty if the profiler saw none)."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            out[e.key] = (us / 1e3, e.count)
    return out


def _window_config(dtype):
    """Path 2a's configuration: ladder 3's LiDAR settings
    (scripts/ladder3_e2e.py:100-106): 10-frame windows re-aligned to
    odometry, anchors downsampled at 0.02 m, stage 1 at voxel 1.0 / eigen
    ratio 0.2, stage 2 at 0.5 / 0.08."""
    from global_lvba_tpu_torch.config import LvbaConfig

    cfg = LvbaConfig()
    cfg.window_ba.size = 10
    cfg.window_ba.anchor_leaf_size = 0.02
    cfg.window_ba.use_window_ba_rel = True
    cfg.BALM_stage1.root_voxel_size = 1.0
    cfg.BALM_stage1.eigen_ratio_array = [0.2] * 4
    cfg.BALM_stage2.root_voxel_size = 0.5
    cfg.BALM_stage2.eigen_ratio_array = [0.08] * 4
    cfg.solver.dtype = dtype
    return cfg


def _agg_check(torch, name, rk, rp, pvk, pvp, live, wc, lam0, lam2,
               tols=(TOL_RESIDV_REL, TOL_RESIDV_REL_LINE, TOL_PV),
               ref64=False):
    """soa_agg kernel vs plain (both of one dtype on the card) under the
    well-conditioned-voxel rule above, with the limits `tols` (residv on
    well-conditioned and on line-like voxels, pv); raises on
    disagreement.  With ref64, a well-conditioned voxel where the plain
    version itself lies more than the limit from the float64 λ_min (lam0:
    float32 rounding of far-off coordinates, path 2c's) is held to that
    value instead: the kernel's error there may exceed the plain
    version's by at most the limit.  Returns residv's max abs error."""
    tol_r, tol_line, tol_pv = tols
    line_like = live & ~wc

    def r_err(a, b, where):
        d = (a.double() - b.double()).abs()[where] / lam2[where].abs()
        return float(d.max()) if d.numel() else 0.0

    err_r = float((rk - rp).abs()[live].max())
    strict, excess, n_lim = wc, 0.0, 0
    if ref64:
        e_p = (rp.double() - lam0).abs() / lam2.abs()
        e_k = (rk.double() - lam0).abs() / lam2.abs()
        limited = wc & (e_p > tol_r)
        strict, n_lim = wc & ~limited, int(limited.sum())
        if n_lim:
            excess = float((e_k - e_p)[limited].max())
            print(f"[{name}] {n_lim} well-conditioned voxels where the plain "
                  f"version lies more than {tol_r} of λ_max from float64 "
                  f"(up to {float(e_p[limited].max()):.3e}; the kernel up to "
                  f"{float(e_k[limited].max()):.3e}): there the kernel's "
                  f"error exceeds the plain version's by at most "
                  f"{excess:.3e} (tol {tol_r})", flush=True)
    err_r_rel = r_err(rk, rp, strict)
    err_r_line = r_err(rk, rp, line_like)
    line64 = (r_err(rk, lam0, line_like), r_err(rp, lam0, line_like))
    err_u, err_bb, err_vn = _pv_errors(torch, pvk[wc], pvp[wc])
    dead_ok = bool((rk[~live] == 0).all())
    finite = bool(torch.isfinite(rk).all() and torch.isfinite(pvk).all())
    print(f"[{name}] residv max abs err {err_r:.3e} on all live voxels; "
          f"err / λ_max {err_r_rel:.3e} on well-conditioned voxels (tol "
          f"{tol_r}), {err_r_line:.3e} on line-like voxels (tol "
          f"{tol_line:.3e}; there kernel vs float64 "
          f"{line64[0]:.3e}, plain vs float64 {line64[1]:.3e}); "
          f"well-conditioned voxels: u abs err {err_u:.3e}, BᵀB rel err "
          f"{err_bb:.3e}, v̄/(1/N) rel err {err_vn:.3e} (tol {tol_pv}); all "
          f"voxels finite: {finite}; padded voxels residv == 0: {dead_ok}",
          flush=True)
    if not (err_r_rel <= tol_r and excess <= tol_r and err_r_line <= tol_line
            and max(err_u, err_bb, err_vn) <= tol_pv and dead_ok and finite):
        _fail(f"{name}: soa_agg disagrees with soa_agg_plain")
    return err_r


def _agg_bounds(name, ns, table_vals, itemsize):
    """soa_agg's bounds over the buckets whose n are `ns`, one launch each:
    "bound" by the bytes the function needs (n of every cell; μ (3) and
    Pc's upper triangle (6: Pc is symmetric) of each live cell; its pose
    row where poses come per entry (table_vals 0) or the pose table once a
    launch (table_vals = its values); 17 outputs a voxel: a dead cell adds
    exactly zero) and "bound_layout" by
    the layout's (every cell's 13 moment values and pose row or the table,
    the outputs), each against its operations.  Printed."""
    cells = sum(n.numel() for n in ns)
    live = sum(int((n > 0).sum()) for n in ns)
    vox = sum(n.shape[0] for n in ns)
    row = 0 if table_vals else 12
    fixed = len(ns) * table_vals + vox * 17
    rate = FP32_FLOP_PER_S if itemsize == 4 else FP64_FLOP_PER_S
    out = dict(
        bound=_bound((cells + live * (9 + row) + fixed) * itemsize,
                     live * AGG_FLOPS_PER_CELL + vox * AGG_FLOPS_PER_VOXEL,
                     rate),
        bound_layout=_bound((cells * (13 + row) + fixed) * itemsize,
                            cells * AGG_FLOPS_PER_CELL
                            + vox * AGG_FLOPS_PER_VOXEL, rate))
    print(f"[{name}] bound {out['bound'][0]:.4f} ms ({out['bound'][1]}) "
          f"over the live cells' bytes ({live} of {cells} cells live); the "
          f"layout's bytes bound {out['bound_layout'][0]:.4f} ms", flush=True)
    return out


def _agg_per_bucket(torch, name, ops, one):
    """soa_agg a launch a bucket over `ops`, bitwise equal to the one
    launch over them (`one`, its outputs), and its device ms per
    evaluation, printed: the shape the one launch replaced."""
    from global_lvba_tpu_torch.kernels.soa import soa_agg

    each = [soa_agg(*o) for o in ops]
    torch.cuda.synchronize()
    same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(each, one))
    ms, ahead = _timed(torch, lambda: [soa_agg(*o) for o in ops])
    print(f"[{name}] a launch a bucket ({len(ops)} launches): {ms:.4f} ms "
          f"(queued ahead {ahead}), bitwise equal to the one launch: {same}",
          flush=True)
    if not same:
        _fail(f"{name}: one launch over the buckets differs from a launch "
              f"a bucket")
    return dict(ms=ms, launches=len(ops), queued_ahead=ahead)


def _agg_case(np, V, K, seed):
    """A seeded soa_agg operand of V voxels of K slots: each voxel a plane
    (centre within 8 m of the origin, the main path's box room's scale:
    at 40 m the cancellation in R μ + p − v̄ moves u by ~1e-4 in float32,
    the plain version's as much as the kernel's; entry means within 0.5 m
    of it along one in-plane axis, 1 cm off it; each cell's points
    scattered by 0.04 and 0.01 m² in-plane, 1e-5 across: λ2 − λ1 >= 0.03
    at any K.  Where λ1 ≈ λ2
    (a few entries spread along both axes) the closed-form eigensolve
    keeps only ~sqrt(eps)·λ2 of them in float32, in the plain version as
    in the kernel, as on line-like voxels), observed from K poses shared by all
    voxels (rotations up to 0.3 rad, offsets of ~5 m); counts 1-29 on 60%
    of the slots, and one voxel in ten padded (no live slot).  Returns
    numpy (n, mu, Pc, pose table (K, 12))."""
    rng = np.random.default_rng(seed)

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    ax = unit(rng.normal(size=(K, 3)))
    ang = rng.uniform(-0.3, 0.3, K)[:, None, None]
    X = np.zeros((K, 3, 3))
    X[:, 0, 1], X[:, 0, 2], X[:, 1, 2] = -ax[:, 2], ax[:, 1], -ax[:, 0]
    X = X - X.transpose(0, 2, 1)
    R = np.eye(3) + np.sin(ang) * X + (1 - np.cos(ang)) * (X @ X)
    pk = rng.normal(scale=5.0, size=(K, 3))
    nv = unit(rng.normal(size=(V, 3)))
    t1 = unit(np.cross(nv, rng.normal(size=(V, 3))))
    t2 = np.cross(nv, t1)
    c = rng.uniform(-8.0, 8.0, (V, 3))
    a = rng.uniform(-0.5, 0.5, (V, K, 1))
    off = 0.01 * rng.normal(size=(V, K, 1))
    wm = c[:, None] + a * t1[:, None] + off * nv[:, None]
    mu = np.einsum("kji,vkj->vki", R, wm - pk)          # Rᵀ (wm − p)
    Lw = (0.04 * t1[:, :, None] * t1[:, None]           # world scatter:
          + 0.01 * t2[:, :, None] * t2[:, None]         # distinct λ
          + 1e-5 * nv[:, :, None] * nv[:, None])
    n = rng.integers(1, 30, (V, K)) * (rng.random((V, K)) < 0.6)
    n[rng.random(V) < 0.1] = 0
    # a cell's Pc is its points' scatter about their mean: n · Rᵀ L R
    Pc = n[..., None, None] * np.einsum("kji,vjl,klm->vkim", R, Lw, R)
    tbl = np.concatenate([R.reshape(K, 9), pk], axis=1)
    return n.astype(np.float64), mu, Pc, tbl


AGG_K_CASES = ((1, 773), (4, 773), (45, 773), (64, 773), (1024, 301))


def _agg_k_cases(torch, np, dev):
    """soa_agg against its plain version beyond the main path's shapes:
    K = 1, 4, 45 (odd), 64 and 1,024 (two rounds of a warp's 512
    entries), V = 773 and 301 (not multiples of the block's voxels),
    float32 and float64, under _agg_check's limits (both versions'
    distance to float64 printed beside); each case with the (K, 12) pose
    table (voxel stride 0), the same poses as per-entry rows (bitwise equal
    to it), and, at K = 45, those rows 4 bytes off 16-byte alignment (the
    scalar pose loads; bitwise equal too).  Then all five cases in one
    soa_agg_buckets call (a launch per entries a thread), bitwise equal to
    their own launches."""
    from types import SimpleNamespace

    from global_lvba_tpu_torch.kernels import launch_counts
    from global_lvba_tpu_torch.kernels.soa import (
        AGG_THREADS, agg_group, soa_agg, soa_agg_buckets, soa_agg_plain)

    for d, tols in ((torch.float32, (TOL_RESIDV_REL, TOL_RESIDV_REL_LINE,
                                     TOL_PV)),
                    (torch.float64, (TOL64_RESIDV_REL,
                                     TOL64_RESIDV_REL_LINE, TOL64_PV))):
        ops, outs = [], []
        for K, V in AGG_K_CASES:
            n, mu, Pc, tbl = (torch.as_tensor(x, dtype=d, device=dev)
                              for x in _agg_case(np, V, K, seed=K))
            rows = tbl.expand(V, K, 12).contiguous()
            fa = SimpleNamespace(n=n, mu=mu, Pc=Pc)
            gap, lam0, lam2 = _spectrum(torch, fa, tbl)
            live = n.sum(dim=1) > 0
            wc = live & (gap >= WELL_CONDITIONED_GAP)
            name = f"soa_agg{'_f64' if d == torch.float64 else ''} K={K}"
            rk, pvk = soa_agg(n, mu, Pc, tbl)
            rp, pvp = soa_agg_plain(n, mu, Pc, tbl)
            pv64 = soa_agg_plain(*(x.double() for x in (n, mu, Pc, tbl)))[1]
            variants = [soa_agg(n, mu, Pc, rows)]
            if K == 45:
                buf = torch.empty(V * K * 12 + 1, dtype=d, device=dev)
                off = buf[1:].view(V, K, 12)
                off.copy_(rows)
                variants.append(soa_agg(n, mu, Pc, off))
            torch.cuda.synchronize()
            lg, ept = agg_group(K)
            e64 = [_pv_errors(torch, x[wc].double(), pv64[wc])[:2]
                   for x in (pvk, pvp)]
            print(f"[{name}] V={V}, {1 << lg} threads a voxel, {ept} "
                  f"entries a thread a round, {AGG_THREADS >> lg} voxels a "
                  f"block; {int(live.sum())} live voxels; on well-"
                  f"conditioned voxels (u abs, BᵀB rel) against float64: "
                  f"kernel {e64[0][0]:.2e}, {e64[0][1]:.2e}; plain "
                  f"{e64[1][0]:.2e}, {e64[1][1]:.2e}", flush=True)
            _agg_check(torch, name, rk, rp, pvk, pvp, live, wc, lam0, lam2,
                       tols=tols)
            same = all(torch.equal(rk, a) and torch.equal(pvk, b)
                       for a, b in variants)
            rows_s = "rows (and 4 B off alignment)" if K == 45 else "rows"
            print(f"[{name}] per-entry pose {rows_s} bitwise equal to the "
                  f"pose table: {same}", flush=True)
            if not same:
                _fail(f"{name}: soa_agg on per-entry pose rows differs "
                      f"from the pose table's")
            ops.append((n, mu, Pc, rows if K % 2 else tbl))
            outs.append((rk, pvk))
        before = launch_counts()
        one = soa_agg_buckets(ops)
        torch.cuda.synchronize()
        calls = sum(launch_counts().values()) - sum(before.values())
        same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                   for a, b in zip(one, outs))
        print(f"[soa_agg{'_f64' if d == torch.float64 else ''} K cases] the "
              f"{len(ops)} cases in one soa_agg_buckets call ({calls} "
              f"launches, one per entries a thread) bitwise equal to their "
              f"own launches: {same}", flush=True)
        if not same:
            _fail("soa_agg_buckets differs from soa_agg per bucket")


def _aligned_f64(torch, kern, results, fa, R, p, ops, pose12, live, wc,
                 lam0, lam2, W):
    """Phase 2d: the float64 instances of kernels 1-3 (soa_agg_f64,
    soa_chain_f64, syrk_f64) against their plain versions in float64 on
    the main path's operands, timed beside them and their bounds (bytes
    at 8 B a value; operations at the fp64 rates); syrk_f64 also on ragged
    operands and at Kr = 0; one float64 evaluation timed and under
    torch.profiler for each kernel's own device time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from global_lvba_tpu_torch.factors.plane_eigen import (
        plane_cost_grad_hess, voxel_chunks)
    from global_lvba_tpu_torch.kernels import launch_counts
    from global_lvba_tpu_torch.kernels.gram import syrk_
    from global_lvba_tpu_torch.kernels.soa import (
        soa_agg, soa_agg_plain, soa_chain, soa_chain_plain)

    d = torch.float64
    ops = [tuple(x.to(d) for x in o) for o in ops]
    pose12 = pose12.to(d)
    fa64 = fa._replace(n=fa.n.to(d), mu=fa.mu.to(d), Pc=fa.Pc.to(d))
    rk, pvk = soa_agg(fa64.n, fa64.mu, fa64.Pc, pose12)
    rp, pvp = soa_agg_plain(fa64.n, fa64.mu, fa64.Pc, pose12)
    torch.cuda.synchronize()
    err_r = _agg_check(
        torch, "soa_agg_f64", rk, rp, pvk, pvp, live, wc, lam0, lam2,
        tols=(TOL64_RESIDV_REL, TOL64_RESIDV_REL_LINE, TOL64_PV))
    nb = fa.n.shape[0]
    kern["soa_agg_f64"] = dict(
        max_abs_err=err_r,
        **_times(torch, "soa_agg_f64",
                 lambda: soa_agg(fa64.n, fa64.mu, fa64.Pc, pose12),
                 lambda: soa_agg_plain(fa64.n, fa64.mu, fa64.Pc, pose12)),
        **_agg_bounds("soa_agg_f64", [fa64.n], W * 12, 8))
    chunks = voxel_chunks(nb, W)
    pvs = [pvk[lo:hi] for lo, hi in chunks]
    del rk, rp, pvp
    ch_k = [soa_chain(*o, pose12, q) for o, q in zip(ops, pvs)]
    ch_p = [soa_chain_plain(*o, pose12, q) for o, q in zip(ops, pvs)]
    torch.cuda.synchronize()
    err_A = max(_rel(a[0], b[0]) for a, b in zip(ch_k, ch_p))
    err_g = _rel(sum(a[1] for a in ch_k), sum(b[1] for b in ch_p))
    err_hd = _rel(sum(a[2] for a in ch_k), sum(b[2] for b in ch_p))
    print(f"[soa_chain_f64] rows rel err {err_A:.3e} (tol {TOL64_ROWS_REL}); "
          f"g rel err {err_g:.3e}, Hd rel err {err_hd:.3e} (tol "
          f"{TOL64_SUM_REL})", flush=True)
    if not (err_A <= TOL64_ROWS_REL and err_g <= TOL64_SUM_REL
            and err_hd <= TOL64_SUM_REL):
        _fail("soa_chain_f64 disagrees with soa_chain_plain in float64")
    err_ev = _chain_check(torch, "soa_chain_f64", ops, pose12, pvs,
                          TOL64_ROWS_REL, TOL64_SUM_REL)
    _chain_widths(torch, pose12.device, "soa_chain_f64", d, TOL64_ROWS_REL,
                  TOL64_SUM_REL)
    bound, bound_layout = _chain_bounds([o[0] for o in ops], W, 8)
    kern["soa_chain_f64"] = dict(
        max_abs_err=max(err_ev[3], max(float((a[0] - b[0]).abs().max())
                                       for a, b in zip(ch_k, ch_p))),
        **_times(torch, "soa_chain_f64",
                 lambda: _chain_evaluation(soa_chain, ops, pose12, pvs),
                 lambda: _chain_evaluation(soa_chain_plain, ops, pose12,
                                           pvs)),
        bound=bound, bound_layout=bound_layout)
    results["soa_chain_f64_launches"] = _chain_launches(
        torch, "soa_chain_f64", ops, pose12, pvs)
    print(f"[soa_chain_f64] bound {bound[0]:.4f} ms ({bound[1]}) over the "
          f"live cells' bytes; the layout's {bound_layout[0]:.4f} ms "
          f"({bound_layout[1]}); the earlier design "
          f"{CHAIN_EARLIER_MS['soa_chain_f64'][0]} ms an evaluation",
          flush=True)
    As = [a[0] for a in ch_k]
    del ch_k, ch_p, pvk, pvs
    kern["syrk_f64"] = _syrk_f64_check(torch, "aligned W=512", As, 6 * W)
    del As
    rng = np.random.default_rng(5)
    for kr_, n_, off in SYRK64_RAGGED:
        flat = torch.as_tensor(rng.normal(size=kr_ * n_ + off),
                               device=pose12.device)
        A_ = flat[off:].view(kr_, n_)
        _syrk_f64_check(torch, f"ragged N={n_}"
                        + (f", A {8 * off} B off 16-byte alignment"
                           if off else ""), [A_], n_, timed=False)
    N = 6 * W
    before = launch_counts()
    g0 = torch.zeros((N, N), dtype=d, device=pose12.device)
    out0 = syrk_(g0, torch.empty((0, N), dtype=d, device=pose12.device))
    torch.cuda.synchronize()
    empty_ok = (out0 is g0 and launch_counts() == before
                and not bool(g0.any()))
    print(f"[syrk_f64] Kr = 0: returns gram unchanged with no launch: "
          f"{empty_ok}", flush=True)
    if not empty_ok:
        _fail("syrk_ launched or changed gram on an empty float64 operand")
    del g0
    # one float64 evaluation: device ms, and each kernel's own time
    R64, p64 = R.to(d), p.to(d)
    ms, ahead = _timed(torch, lambda: plane_cost_grad_hess(fa64, R64, p64, W))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        plane_cost_grad_hess(fa64, R64, p64, W)
        torch.cuda.synchronize()
    sums = _no_partial_sums(prof, "eval float64")
    per = _kernel_times(_device_ms(prof), ALIGNED_F64_KERNELS)
    for name, (k_ms, _) in per.items():
        kern[name]["kernel_device_ms"] = k_ms
    print(f"[eval float64] {ms:.4f} ms device time (queued ahead {ahead}); "
          f"profiler, (device ms, launches) per evaluation by kernel: {per}",
          flush=True)
    results["eval_float64"] = dict(ms=ms, queued_ahead=ahead, per_kernel=per,
                                   sum_shapes=sums)


def _syrk_f64_check(torch, label, As, N, timed=True):
    """syrk_ on float64 operands As into one gram: within TOL64_GRAM_REL of
    syrk_plain_ and torch.matmul, exactly symmetric, two runs bitwise
    equal; with `timed`, timed in turns with torch.matmul(A.T, A).  Its
    bound: Kr·N·(N+1) flops at the fp64 tensor-core rate."""
    from global_lvba_tpu_torch.kernels.gram import syrk_, syrk_plain_

    gk = torch.zeros((N, N), dtype=torch.float64, device=As[0].device)
    gk2, gp = torch.zeros_like(gk), torch.zeros_like(gk)
    for A in As:
        syrk_(gk, A)
        syrk_(gk2, A)
        syrk_plain_(gp, A)
    gl = sum(torch.matmul(A.T, A) for A in As)
    torch.cuda.synchronize()
    err_p, err_l = _rel(gk, gp), _rel(gk, gl)
    sym, rep = bool(torch.equal(gk, gk.T)), bool(torch.equal(gk, gk2))
    kr = sum(A.shape[0] for A in As)
    print(f"[syrk_f64] {label}, {kr} rows x {N} columns: rel err vs "
          f"syrk_plain_ {err_p:.3e}, vs torch.matmul {err_l:.3e} (tol "
          f"{TOL64_GRAM_REL}); exactly symmetric: {sym}; two runs bitwise "
          f"equal: {rep}", flush=True)
    if not (err_p <= TOL64_GRAM_REL and err_l <= TOL64_GRAM_REL and sym
            and rep):
        _fail(f"syrk_ disagrees with AᵀA on the float64 {label} operand")
    out = dict(max_abs_err=float((gk - gp).abs().max()))
    del gk2, gp, gl
    if not timed:
        return out
    out.update(_times_in_turns(torch, "syrk_f64",
                               lambda: [syrk_(gk, A) for A in As],
                               lambda: [syrk_plain_(gk, A) for A in As],
                               lambda: [torch.matmul(A.T, A) for A in As]))
    flops = kr * N * (N + 1)
    out["bound"] = _bound(kr * N * 8 + len(As) * 2 * N * N * 8, flops,
                          FP64_TC_FLOP_PER_S)
    print(f"[syrk_f64] {label}: {flops / 1e9:.1f} GFLOP; bound "
          f"{out['bound'][0]:.4f} ms ({out['bound'][1]}, fp64 at "
          f"{FP64_TC_FLOP_PER_S / 1e12:.0f} TFLOP/s on the tensor cores); "
          f"{flops / out['ms'] / 1e9:.1f} TFLOP/s at the wrapper's "
          f"{out['ms']:.4f} ms; torch.matmul {out['library_ms']:.4f} ms "
          f"({flops / out['library_ms'] / 1e9:.1f} TFLOP/s)", flush=True)
    return out


def _bucketed_f64(torch, kern, results, bs, frames, tbl_m, chunks, live, wc,
                  lam0, lam2, pose12, R, p, W, odd):
    """Phase 6f: the float64 instances of the bucketed kernels
    (table_select_f64, soa_agg_f64 on per-entry pose rows,
    soa_chain_entries_f64, entry_reduce_f64) against their plain versions
    in float64 on path 2b's operands, in the evaluation's launch shape
    (soa_agg once a bucket, entry_reduce once through the merged frame
    table tbl_m), timed beside them, their library
    calls and their bounds; soa_chain_entries_f64 also over NaN-filled
    memory, with planted frame ids and at W = 45; syrk_f64 on the
    corridor's Gram operands; one float64 evaluation timed and under
    torch.profiler for each kernel's own device time."""
    from torch.profiler import ProfilerActivity, profile

    from global_lvba_tpu_torch.factors.plane_eigen import (
        KERNEL_STEPS, _cost_grad_hess_buckets)
    from global_lvba_tpu_torch.kernels.selection import (
        entry_reduce, entry_reduce_plain, table_select_buckets,
        table_select_buckets_plain)
    from global_lvba_tpu_torch.kernels.soa import (
        soa_agg_buckets, soa_agg_plain, soa_chain_entries,
        soa_chain_entries_plain)

    d, dev = torch.float64, pose12.device
    odd_args, odd_frames, odd_pose12 = odd
    pose12 = pose12.to(d)
    bs = [fa._replace(n=fa.n.to(d), mu=fa.mu.to(d), Pc=fa.Pc.to(d))
          for fa in bs]
    frames64 = [f.long() for f in frames]
    VK = sum(f.numel() for f in frames)
    Vs = sum(fa.n.shape[0] for fa in bs)
    live_e = sum(int((fa.n > 0).sum()) for fa in bs)
    sel_k = _select_check(torch, "table_select_f64", frames, pose12,
                          (odd_frames, odd_pose12.to(d)))
    kern["table_select_f64"] = dict(
        max_abs_err=0.0,
        **_times(torch, "table_select_f64",
                 lambda: table_select_buckets(frames, pose12),
                 lambda: table_select_buckets_plain(frames, pose12),
                 lambda: [torch.index_select(pose12, 0, f)
                          for f in frames64]),
        bound=_bound(VK * 4 + W * 96 + VK * 96, 0))
    poses = [s.reshape(fa.n.shape[0], fa.n.shape[1], 12)
             for s, fa in zip(sel_k, bs)]
    agg_ops = [(fa.n, fa.mu, fa.Pc, ps) for fa, ps in zip(bs, poses)]
    agg_k = soa_agg_buckets(agg_ops)
    agg_p = [soa_agg_plain(*o) for o in agg_ops]
    torch.cuda.synchronize()
    err_r = _agg_check(
        torch, "soa_agg_f64 2b", *(torch.cat([a[i] for a in x])
                                   for i in (0, 1) for x in (agg_k, agg_p)),
        live, wc, lam0, lam2,
        tols=(TOL64_RESIDV_REL, TOL64_RESIDV_REL_LINE, TOL64_PV))
    results["soa_agg_f64_2b"] = dict(
        max_abs_err=err_r,
        **_times(torch, "soa_agg_f64 2b", lambda: soa_agg_buckets(agg_ops),
                 lambda: [soa_agg_plain(*o) for o in agg_ops]),
        per_bucket=_agg_per_bucket(torch, "soa_agg_f64 2b", agg_ops, agg_k),
        **_agg_bounds("soa_agg_f64 2b", [fa.n for fa in bs], 0, 8))
    ops = [(bs[b].n[lo:hi], bs[b].mu[lo:hi], bs[b].Pc[lo:hi],
            poses[b][lo:hi]) for b, lo, hi in chunks]
    chain_args = [o + (bs[b].frame[lo:hi], agg_k[b][1][lo:hi], W)
                  for o, (b, lo, hi) in zip(ops, chunks)]
    ch_k = [soa_chain_entries(*a) for a in chain_args]
    ch_p = [soa_chain_entries_plain(*a) for a in chain_args]
    torch.cuda.synchronize()
    vk = torch.cat([a[1] for a in ch_k])
    vp = torch.cat([b[1] for b in ch_p])
    err_A = max(_rel(a[0], b[0]) for a, b in zip(ch_k, ch_p))
    err_v = _rel(vk, vp)
    print(f"[soa_chain_entries_f64] rows rel err {err_A:.3e}, per-entry "
          f"channels {err_v:.3e} (tol {TOL64_ROWS_REL})", flush=True)
    if not (err_A <= TOL64_ROWS_REL and err_v <= TOL64_ROWS_REL):
        _fail("soa_chain_entries_f64 disagrees with its plain version")
    kern["soa_chain_entries_f64"] = dict(
        max_abs_err=max(float((a[0] - b[0]).abs().max())
                        for a, b in zip(ch_k, ch_p)),
        **_times(torch, "soa_chain_entries_f64",
                 lambda: [soa_chain_entries(*a) for a in chain_args],
                 lambda: [soa_chain_entries_plain(*a) for a in chain_args]),
        bound=_bound(VK * 25 * 8 + VK * 4 + Vs * 16 * 8 + VK * 30 * 8
                     + 3 * Vs * 6 * W * 8, VK * CHAIN_FLOPS_PER_CELL,
                     FP64_FLOP_PER_S))
    _chain_entries_full_write(torch, "soa_chain_entries_f64 2b", chain_args,
                              TOL64_ROWS_REL)
    big = max(chain_args, key=lambda a: a[0].shape[0])
    _chain_entries_full_write(torch, "soa_chain_entries_f64 planted ids",
                              [_planted(torch, big)], TOL64_ROWS_REL)
    _chain_entries_full_write(torch, f"soa_chain_entries_f64 W={ODD_W}",
                              _to_f64(torch, odd_args), TOL64_ROWS_REL)
    As = [a[0] for a in ch_k]
    del ch_k, ch_p, agg_k, agg_p
    results["syrk_f64_2b"] = _syrk_f64_check(torch, "corridor W=512", As,
                                             6 * W)
    del As
    fcat = torch.cat(frames64)
    red_k = entry_reduce(vk, tbl_m)
    red_k2 = entry_reduce(vk, tbl_m)
    red_p = entry_reduce_plain(vk, tbl_m)
    red_l = torch.zeros((W, 30), dtype=d, device=dev).index_add_(0, fcat, vk)
    torch.cuda.synchronize()
    err_red, err_lib = _rel(red_k, red_p), _rel(red_k, red_l)
    rep = bool(torch.equal(red_k, red_k2))
    print(f"[entry_reduce_f64] one launch over the buckets: rel err vs "
          f"entry_reduce_plain {err_red:.3e}, vs index_add_ {err_lib:.3e} "
          f"(tol {TOL64_SUM_REL}); two calls bitwise equal: {rep}",
          flush=True)
    if not (err_red <= TOL64_SUM_REL and err_lib <= TOL64_SUM_REL and rep):
        _fail("entry_reduce_f64 disagrees with entry_reduce_plain or is not "
              "repeatable")
    kern["entry_reduce_f64"] = dict(
        max_abs_err=float((red_k - red_p).abs().max()),
        **_times(torch, "entry_reduce_f64",
                 lambda: entry_reduce(vk, tbl_m),
                 lambda: entry_reduce_plain(vk, tbl_m),
                 lambda: torch.zeros((W, 30), dtype=d, device=dev)
                 .index_add_(0, fcat, vk)),
        bound=_bound(live_e * 30 * 8 + tbl_m.numel() * 4 + W * 30 * 8,
                     live_e * 30, FP64_FLOP_PER_S))
    # one float64 evaluation over the buckets: device ms, kernel times
    R64, p64 = R.to(d), p.to(d)

    def cgh64():
        return _cost_grad_hess_buckets(KERNEL_STEPS, bs, R64, p64, W,
                                       table=tbl_m)

    ms, ahead = _timed(torch, cgh64)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cgh64()
        torch.cuda.synchronize()
    per = _kernel_times(_device_ms(prof), BUCKETED_F64_KERNELS)
    for name, (k_ms, _) in per.items():
        # soa_agg_f64's and syrk_f64's rows keep the aligned evaluation's
        kern[name].setdefault("kernel_device_ms", k_ms)
    print(f"[eval 2b float64] {ms:.4f} ms device time (queued ahead "
          f"{ahead}); profiler, (device ms, launches) per evaluation by "
          f"kernel: {per}", flush=True)
    results["eval_2b_float64"] = dict(ms=ms, queued_ahead=ahead,
                                      per_kernel=per)


@contextlib.contextmanager
def _recording_builds(builds):
    """While the block runs, pipeline.lidar_ba._build_vm appends its
    arguments (points, frame ids, poses, voxel size, eigen ratios) to
    builds."""
    from global_lvba_tpu_torch.pipeline import lidar_ba

    build_vm = lidar_ba._build_vm

    def recorded(*a):
        builds.append(a[:6])
        return build_vm(*a)

    lidar_ba._build_vm = recorded
    try:
        yield
    finally:
        lidar_ba._build_vm = build_vm


def _keep_2a(torch, np):
    """Path 2a's scene and its card run's voxel map builds in KEEP, as
    phase 8 leaves them, for phase 20 run alone
    (scripts/visual_phases.py)."""
    from global_lvba_tpu_torch.models.synthetic import (
        make_plane_scene, perturb_poses)
    from global_lvba_tpu_torch.pipeline.lidar_ba import run_lidar_ba

    sc = make_plane_scene(num_frames=WINDOW_FRAMES,
                          points_per_frame=WINDOW_PPF, seed=0)
    Ra, pa = perturb_poses(sc.R_true, sc.p_true, 0.003, 0.01, seed=1)
    builds = []
    with _recording_builds(builds):
        run_lidar_ba([sc.points_body[sc.frame_ids == i]
                      for i in range(WINDOW_FRAMES)], Ra, pa,
                     _window_config("float32"), device="cuda")
        torch.cuda.synchronize()
    KEEP["2a"] = (sc.points_body, sc.frame_ids, Ra, pa)
    KEEP["2a_builds"] = builds


def _stage_lines(tag, stats):
    w = stats["window"]
    print(f"[{tag}] window stage: {w['windows']} windows, {w['skipped']} "
          f"skipped, {w['lm_iters']} LM iterations in {w['lm_s']:.3f} s",
          flush=True)
    for s in stats["global"]:
        print(f"[{tag}] global stage {s['stage']}: {s['planes']} planes, "
              f"{s.get('lm_iters', 0)} LM iterations in "
              f"{s.get('lm_s', 0.0):.3f} s on route {s.get('lm_route')}, "
              f"{s['time_s']:.3f} s", flush=True)


def _slice2(torch, np, dev, kern, results, paths):
    """Slice 2, the bucketed layout: kernels 4-5 and the per-entry chain
    at path 2b's shapes, the bucketed evaluation, and paths 2a and 2b
    through run_lidar_ba (phases 6-9 of the module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    from global_lvba_tpu_torch.__main__ import slice_config
    from global_lvba_tpu_torch.factors.padding import buckets_to_device
    from global_lvba_tpu_torch.factors.plane_eigen import (
        KERNEL_STEPS, PLAIN_STEPS, PlaneFactorArrays, _cost_grad_hess_buckets,
        buckets_frame_table, frame_gather_table, plane_cost, pose_table,
        voxel_chunks)
    from global_lvba_tpu_torch.kernels import launch_counts, reset_launch_counts
    from global_lvba_tpu_torch.kernels.gram import (
        syrk_, syrk_plain_, tf32_split, tf32_split_plain)
    from global_lvba_tpu_torch.kernels.selection import (
        entry_reduce, entry_reduce_plain, table_select_buckets,
        table_select_buckets_plain)
    from global_lvba_tpu_torch.kernels.soa import (
        soa_agg_buckets, soa_agg_plain, soa_chain_entries,
        soa_chain_entries_plain)
    from global_lvba_tpu_torch.map.voxelize import build_voxel_map
    from global_lvba_tpu_torch.models.synthetic import (
        ate_rmse, make_corridor_scene, make_plane_scene, perturb_poses)
    from global_lvba_tpu_torch.pipeline.lidar_ba import run_lidar_ba
    from global_lvba_tpu_torch.solver.lm import lm_damping_iter

    # ---- path 2b's problem: the corridor at W=512, stage-1 voxelization ----
    W = CORRIDOR_FRAMES
    cfg = slice_config("float32")
    scene = make_corridor_scene(W, CORRIDOR_PPF, seed=0)
    Rp, pp = perturb_poses(scene.R_true, scene.p_true, 0.003, 0.01, seed=1)
    vm = build_voxel_map(
        scene.points_body, scene.frame_ids, Rp, pp, VOXEL,
        eigen_ratios=[RATIO] * 4, min_ps=cfg.solver.min_ps,
        layer_limit=cfg.solver.layer_limit)
    bs = buckets_to_device(vm, W=W, dtype=torch.float32, device=dev)
    if not all(isinstance(fa, PlaneFactorArrays) for fa in bs):
        _fail("the density gate does not pick the bucketed layout on the "
              "corridor")
    R = torch.as_tensor(Rp, dtype=torch.float32, device=dev)
    p = torch.as_tensor(pp, dtype=torch.float32, device=dev)
    pose12 = pose_table(R, p)
    # the evaluation's one frame table over every bucket's entries (the
    # buckets' own, for their widths)
    tbl_m = buckets_frame_table(bs, W)
    widths = [int(frame_gather_table(fa, W).shape[1]) for fa in bs]
    frames = [fa.frame.reshape(-1) for fa in bs]
    frames64 = [f.long() for f in frames]
    live_e = sum(int((fa.n > 0).sum()) for fa in bs)
    VK = sum(f.numel() for f in frames)
    Vs = sum(fa.n.shape[0] for fa in bs)
    chunks = [(b, lo, hi) for b, fa in enumerate(bs)
              for lo, hi in voxel_chunks(fa.n.shape[0], W, K=fa.n.shape[1])]
    info = dict(points=int(scene.points_body.shape[0]),
                voxels=vm.num_planes,
                tiers=[[int(b.n.shape[0]), int(b.n.shape[1])]
                       for b in vm.buckets],
                padded=[list(fa.n.shape) for fa in bs], entries=live_e,
                slots=VK, gram_rows=3 * Vs, gram_cols=6 * W,
                chunks=[hi - lo for _, lo, hi in chunks],
                table_widths=widths, merged_table_width=int(tbl_m.shape[1]))
    print(f"[2b] corridor W={W}: {info}", flush=True)
    results["corridor"] = info

    # ---- 6a. table_select: every bucket in one launch, bitwise equal
    # (it is a copy) ----
    odd_args, odd_frames, odd_pose12 = _odd_w_args(torch, dev)
    sel_k = _select_check(torch, "table_select", frames, pose12,
                          (odd_frames, odd_pose12))
    kern["table_select"] = dict(
        max_abs_err=0.0,
        **_times(torch, "table_select",
                 lambda: table_select_buckets(frames, pose12),
                 lambda: table_select_buckets_plain(frames, pose12),
                 lambda: [torch.index_select(pose12, 0, f)
                          for f in frames64]),
        bound=_bound(VK * 4 + W * 48 + VK * 48, 0),
    )
    poses = [s.reshape(fa.n.shape[0], fa.n.shape[1], 12)
             for s, fa in zip(sel_k, bs)]

    # ---- 6b. soa_agg on the per-entry pose rows: one launch over the
    # buckets (the evaluation's), a launch a bucket timed beside it ----
    agg_ops = [(fa.n, fa.mu, fa.Pc, ps) for fa, ps in zip(bs, poses)]
    agg_k = soa_agg_buckets(agg_ops)
    agg_p = [soa_agg_plain(*o) for o in agg_ops]
    torch.cuda.synchronize()
    spec = [_spectrum(torch, fa, ps) for fa, ps in zip(bs, poses)]
    gap, lam0, lam2 = (torch.cat([s[i] for s in spec]) for i in range(3))
    live = torch.cat([fa.n.sum(dim=1) > 0 for fa in bs])
    wc = live & (gap >= WELL_CONDITIONED_GAP)
    n_ill = int((live & ~wc).sum())
    print(f"[2b] {n_ill} of {int(live.sum())} voxels line-like", flush=True)
    results["corridor"]["line_like_voxels"] = n_ill

    def cat(xs, i):
        return torch.cat([x[i] for x in xs])

    err_r = _agg_check(torch, "soa_agg 2b", cat(agg_k, 0), cat(agg_p, 0),
                       cat(agg_k, 1), cat(agg_p, 1), live, wc, lam0, lam2)
    results["soa_agg_2b"] = dict(
        max_abs_err=err_r,
        **_times(torch, "soa_agg 2b", lambda: soa_agg_buckets(agg_ops),
                 lambda: [soa_agg_plain(*o) for o in agg_ops]),
        per_bucket=_agg_per_bucket(torch, "soa_agg 2b", agg_ops, agg_k),
        **_agg_bounds("soa_agg 2b", [fa.n for fa in bs], 0, 4))

    # ---- 6c. soa_chain_entries (both versions take the kernel's pv) ----
    ops = [(bs[b].n[lo:hi], bs[b].mu[lo:hi], bs[b].Pc[lo:hi],
            poses[b][lo:hi]) for b, lo, hi in chunks]
    chain_args = [o + (bs[b].frame[lo:hi], agg_k[b][1][lo:hi], W)
                  for o, (b, lo, hi) in zip(ops, chunks)]
    ch_k = [soa_chain_entries(*a) for a in chain_args]
    ch_p = [soa_chain_entries_plain(*a) for a in chain_args]
    torch.cuda.synchronize()
    err_A = max(_rel(a[0], b[0]) for a, b in zip(ch_k, ch_p))
    vk, vp = cat(ch_k, 1), cat(ch_p, 1)
    err_j, err_d = _rel(vk[:, :6], vp[:, :6]), _rel(vk[:, 6:], vp[:, 6:])
    live_s = torch.cat([fa.n.reshape(-1) > 0 for fa in bs])
    dead_ok = bool((vk[~live_s] == 0).all())
    print(f"[soa_chain_entries] rows rel err {err_A:.3e}, per-entry jjt "
          f"{err_j:.3e} and diagonal extras {err_d:.3e} (tol "
          f"{TOL_ROWS_REL}, relative to each one's max |.|); dead entries' "
          f"channels == 0: {dead_ok}", flush=True)
    if not (err_A <= TOL_ROWS_REL and err_j <= TOL_ROWS_REL
            and err_d <= TOL_ROWS_REL and dead_ok):
        _fail("soa_chain_entries disagrees with soa_chain_entries_plain")
    kern["soa_chain_entries"] = dict(
        max_abs_err=max(float((a[0] - b[0]).abs().max())
                        for a, b in zip(ch_k, ch_p)),
        **_times(torch, "soa_chain_entries",
                 lambda: [soa_chain_entries(*a) for a in chain_args],
                 lambda: [soa_chain_entries_plain(*a) for a in chain_args]),
        bound=_bound(VK * 26 * 4 + Vs * 16 * 4 + VK * 30 * 4
                     + 3 * Vs * 6 * W * 4, VK * CHAIN_FLOPS_PER_CELL),
    )
    del ch_p
    # A written in full: over NaN-filled memory, with planted frame ids,
    # and at an odd W (the stores' narrow path)
    _chain_entries_full_write(torch, "soa_chain_entries 2b", chain_args,
                              TOL_ROWS_REL)
    big = max(chain_args, key=lambda a: a[0].shape[0])
    _chain_entries_full_write(torch, "soa_chain_entries planted ids",
                              [_planted(torch, big)], TOL_ROWS_REL)
    _chain_entries_full_write(torch, f"soa_chain_entries W={ODD_W}",
                              odd_args, TOL_ROWS_REL)

    # ---- 6d. entry_reduce, one launch over every bucket's entries:
    # relative to max |.|, two calls bitwise equal ----
    fcat = torch.cat(frames64)
    red_k = entry_reduce(vk, tbl_m)
    red_k2 = entry_reduce(vk, tbl_m)
    red_p = entry_reduce_plain(vk, tbl_m)
    red_l = torch.zeros((W, 30), device=dev).index_add_(0, fcat, vk)
    torch.cuda.synchronize()
    err_red, err_lib = _rel(red_k, red_p), _rel(red_k, red_l)
    rep = bool(torch.equal(red_k, red_k2))
    print(f"[entry_reduce] one launch over the {len(bs)} buckets' {VK} "
          f"entries, table ({W}, {tbl_m.shape[1]}): rel err vs "
          f"entry_reduce_plain {err_red:.3e}, vs index_add_ {err_lib:.3e} "
          f"(tol {TOL_SUM_REL}, relative to max |.|: float32 sums in "
          f"another order); two calls bitwise equal: {rep}", flush=True)
    if not (err_red <= TOL_SUM_REL and err_lib <= TOL_SUM_REL and rep):
        _fail("entry_reduce disagrees with entry_reduce_plain or is not "
              "repeatable")
    kern["entry_reduce"] = dict(
        max_abs_err=float((red_k - red_p).abs().max()),
        **_times(torch, "entry_reduce",
                 lambda: entry_reduce(vk, tbl_m),
                 lambda: entry_reduce_plain(vk, tbl_m),
                 lambda: torch.zeros((W, 30), device=dev).index_add_(
                     0, fcat, vk)),
        bound=_bound(live_e * 30 * 4 + tbl_m.numel() * 4 + W * 30 * 4,
                     live_e * 30),
    )
    # ---- 6e. syrk on the corridor's Gram operands (every tier and chunk
    # of one evaluation, into one gram), timed with its library call ----
    As = [a[0] for a in ch_k]
    N = 6 * W
    err_g2 = _syrk_check(torch, "corridor W=512", As, N)
    scratch = torch.zeros((N, N), dtype=torch.float32, device=dev)
    bound, bound_fp32, flops = _syrk_bounds(As, N)
    t2 = _times_in_turns(torch, "syrk 2b",
                         lambda: [syrk_(scratch, A) for A in As],
                         lambda: [syrk_plain_(scratch, A) for A in As],
                         lambda: [torch.matmul(A.T, A) for A in As])
    t2s = _times(torch, "syrk_split 2b", lambda: [tf32_split(A) for A in As],
                 lambda: [tf32_split_plain(A) for A in As])
    print(f"[syrk 2b] {len(As)} operands, {sum(A.shape[0] for A in As)} "
          f"rows: {flops / 1e9:.1f} GFLOP (fp32-equivalent); bound "
          f"{bound[0]:.4f} ms ({bound[1]}, 3xTF32; fp32 bound "
          f"{bound_fp32[0]:.4f} ms); {flops / t2['ms'] / 1e9:.1f} TFLOP/s "
          f"fp32-equivalent at the wrapper's {t2['ms']:.4f} ms, of which the "
          f"split {t2s['ms']:.4f} ms; torch.matmul(A.T, A) "
          f"{t2['library_ms']:.4f} ms", flush=True)
    results["syrk_2b"] = dict(max_abs_err=err_g2, bound=bound,
                              bound_fp32=bound_fp32, split=t2s, **t2)
    del scratch, As
    del ch_k, vk, vp, agg_k, agg_p, agg_ops, ops, chain_args, fcat
    # ---- 6f. the float64 instances of the bucketed kernels ----
    _bucketed_f64(torch, kern, results, bs, frames, tbl_m, chunks, live, wc,
                  lam0, lam2, pose12, R, p, W,
                  (odd_args, odd_frames, odd_pose12))
    del odd_args

    # ---- 7. the bucketed evaluation over the corridor's buckets: one
    # Gram accumulator, one entry_reduce (solver.lm._total_cgh's) ----
    def cgh(steps, fas, table):
        return _cost_grad_hess_buckets(steps, fas, R, p, W, table=table)

    reset_launch_counts()
    r1, g1, H1 = cgh(KERNEL_STEPS, bs, tbl_m)
    torch.cuda.synchronize()
    per_eval = {k: v for k, v in launch_counts().items() if v}
    shape_ok = (per_eval.get("entry_reduce") == 1
                and 1 <= per_eval.get("soa_agg", 0) <= len(bs)
                and per_eval.get("table_select") == 1)
    print(f"[eval 2b] launches in one evaluation over the {len(bs)} "
          f"buckets: {per_eval}", flush=True)
    if not shape_ok:
        _fail(f"the bucketed evaluation launched {per_eval}: one "
              f"entry_reduce, at most one soa_agg a bucket and one "
              f"table_select expected")
    r2, g2, H2 = cgh(KERNEL_STEPS, bs, tbl_m)
    torch.cuda.synchronize()
    same = bool(torch.equal(r1, r2) and torch.equal(g1, g2)
                and torch.equal(H1, H2) and torch.isfinite(H1).all()
                and torch.isfinite(g1).all())
    rq = cgh(PLAIN_STEPS, bs, tbl_m)[0]
    line_like = live & ~wc
    r_slack = TOL_RESIDV_REL_LINE * float(lam2[line_like].abs().sum())
    e_r = max(0.0, abs(float(r1) - float(rq)) - r_slack) / abs(float(rq))
    wcs = torch.split(wc, [fa.n.shape[0] for fa in bs])
    bs_wc = [fa._replace(n=fa.n * w[:, None].to(fa.n.dtype))
             for fa, w in zip(bs, wcs)]
    tb_wc = buckets_frame_table(bs_wc, W)
    _, gk_, Hk_ = cgh(KERNEL_STEPS, bs_wc, tb_wc)
    _, gq, Hq = cgh(PLAIN_STEPS, bs_wc, tb_wc)
    e_g, e_H = _rel(gk_, gq), _rel(Hk_, Hq)
    del gk_, Hk_, gq, Hq, bs_wc, tb_wc
    # no step of the evaluation may wait on the device (the frame tables
    # are built once per solve, outside it)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    cgh(KERNEL_STEPS, bs, tbl_m)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    eval_ms, ahead_e = _timed(torch, lambda: cgh(KERNEL_STEPS, bs, tbl_m))
    plain_eval_ms, ahead_pe = _timed(torch,
                                     lambda: cgh(PLAIN_STEPS, bs, tbl_m))
    print(f"[eval 2b] kernels vs plain over the {len(bs)} buckets: r rel err "
          f"{e_r:.3e} (beyond the line-like voxels' {r_slack:.3e}), g "
          f"{e_g:.3e}, H {e_H:.3e} (well-conditioned voxels) (tol "
          f"{TOL_EVAL_REL}); H finite and bitwise repeatable: {same}; eval "
          f"{eval_ms:.4f} ms device time (queued ahead {ahead_e}), plain "
          f"{plain_eval_ms:.4f} ms (queued ahead {ahead_pe}); one evaluation "
          f"queued in {host_ms:.3f} ms of host time with no synchronizing "
          f"call (torch.cuda sync debug mode)", flush=True)
    if not (e_r <= TOL_EVAL_REL and e_g <= TOL_EVAL_REL
            and e_H <= TOL_EVAL_REL and same):
        _fail("the bucketed kernel evaluation disagrees with the plain one "
              "or is not repeatable")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        cgh(KERNEL_STEPS, bs, tbl_m)
        torch.cuda.synchronize()
    prof_eval = _device_ms(prof)
    # no fill may touch A: the fill ops' tensors, by shape, against the
    # buckets' Gram operands (3V, 6W)
    a_shapes = {(3 * fa.n.shape[0], 6 * W) for fa in bs}
    fill_shapes = [tuple(sh) for e in prof.events() if e.name in FILL_OPS
                   for sh in e.input_shapes if sh]
    a_fills = [sh for sh in fill_shapes if sh in a_shapes]
    per_kernel = {}
    for name, sym in KERNEL_SYMBOLS.items():
        hits = [v for k, v in prof_eval.items() if sym in k]
        if hits:
            per_kernel[name] = hits[0]
            if name in kern and "kernel_device_ms" not in kern[name]:
                kern[name]["kernel_device_ms"] = hits[0][0]
    fills = {k[:60]: v for k, v in prof_eval.items() if "Fill" in k}
    print(f"[eval 2b] profiler, (device ms, launches) per evaluation by "
          f"kernel: {per_kernel}; fill kernels: {fills}; fill ops by "
          f"shape: {sorted(set(fill_shapes))}, of A's shape "
          f"{sorted(a_shapes)}: {len(a_fills)}", flush=True)
    if a_fills:
        _fail(f"the bucketed evaluation fills A ({a_fills}): the chain "
              f"kernel writes every element of it")
    if not fill_shapes:
        _fail("the profile recorded no fill op's shape: the check that "
              "no fill touches A saw nothing")
    N, kr = 6 * W, 3 * Vs
    syrk_ms = per_kernel.get("syrk", (float("nan"), 0))[0]
    split_ms = per_kernel.get("syrk_split", (float("nan"), 0))[0]
    syrk_bound = results["syrk_2b"]["bound"]
    print(f"[eval 2b] syrk over {kr} rows x {N} columns: "
          f"{kr * N * (N + 1) / 1e9:.1f} GFLOP per evaluation, bound "
          f"{syrk_bound[0]:.4f} ms ({syrk_bound[1]}, 3xTF32), "
          f"{kr * N * (N + 1) / (syrk_ms + split_ms) / 1e9:.1f} TFLOP/s "
          f"fp32-equivalent at its profiled {syrk_ms:.4f} ms + the split's "
          f"{split_ms:.4f} ms", flush=True)
    results["eval_2b"] = dict(ms=eval_ms, plain_ms=plain_eval_ms,
                              launches=per_eval,
                              host_queue_ms=host_ms, r_rel=e_r,
                              g_rel=e_g, H_rel=e_H, bitwise_repeatable=same,
                              queued_ahead=ahead_e, per_kernel=per_kernel,
                              syrk_bound=syrk_bound, fills=fills,
                              profiler_device_ms=prof_eval)
    del r1, g1, H1, r2, g2, H2, rq

    # ---- 8. path 2a: the window pipeline at 2.0 M points ----
    F = WINDOW_FRAMES
    sc_a = make_plane_scene(num_frames=F, points_per_frame=WINDOW_PPF, seed=0)
    Ra, pa = perturb_poses(sc_a.R_true, sc_a.p_true, 0.003, 0.01, seed=1)
    clouds = [sc_a.points_body[sc_a.frame_ids == i] for i in range(F)]
    builds = []      # the run's voxel map builds, for phase 20
    reset_launch_counts()
    t0 = time.time()
    with _recording_builds(builds):
        res = run_lidar_ba(clouds, Ra, pa, _window_config("float32"),
                           device="cuda")
        torch.cuda.synchronize()
    wall = time.time() - t0
    counts = paths["2a"] = launch_counts()
    ate0, ate = ate_rmse(pa, sc_a.p_true), ate_rmse(res.p_opt, sc_a.p_true)
    print(f"[2a] run_lidar_ba {F} frames / {sc_a.points_body.shape[0]} "
          f"points: ATE {ate0:.6f} -> {ate:.6f} m, wall {wall:.2f} s, "
          f"launches {counts}; the JAX package's float32 CPU run at these "
          f"settings: {JAX_2A_ATE[0]} -> {JAX_2A_ATE[1]} m", flush=True)
    _stage_lines("2a", res.stats)
    if not all(counts[k] > 0 for k in BUCKETED_PATH_KERNELS):
        _fail(f"a kernel of path 2a was never launched: {counts}")
    t0 = time.time()
    ref = run_lidar_ba(clouds, Ra, pa, _window_config("float64"), device="cpu")
    ate_ref = ate_rmse(ref.p_opt, sc_a.p_true)
    print(f"[2a] float64 reference on the CPU: ATE {ate_ref:.6f} m "
          f"({time.time() - t0:.1f} s)", flush=True)
    _stage_lines("2a float64 CPU", ref.stats)
    results["path_2a"] = dict(ate0=ate0, ate=ate, ate_float64_cpu=ate_ref,
                              wall_s=wall, stats=res.stats,
                              stats_float64_cpu=ref.stats, launches=counts)
    if not (np.isfinite(res.p_opt).all() and ate < ate0
            and abs(ate - ate_ref) <= 0.1 * ate_ref):
        _fail(f"2a: ATE {ate0} -> {ate} (float64 reference {ate_ref})")
    # the same pipeline in float64 on the card: every bucketed kernel's
    # double instance, and the float64 CPU run's ATE within 1e-6
    reset_launch_counts()
    t0 = time.time()
    res64 = run_lidar_ba(clouds, Ra, pa, _window_config("float64"),
                         device="cuda")
    torch.cuda.synchronize()
    wall64 = time.time() - t0
    counts64 = paths["2a-float64"] = launch_counts()
    ate64 = ate_rmse(res64.p_opt, sc_a.p_true)
    e64 = abs(ate64 - ate_ref) / ate_ref
    print(f"[2a-float64] run_lidar_ba in float64 on the card: ATE {ate0:.6f} "
          f"-> {ate64:.9f} m, wall {wall64:.2f} s; the float64 CPU run's "
          f"{ate_ref:.9f} m: rel diff {e64:.3e} (tol 1e-6); launches "
          f"{counts64}", flush=True)
    results["path_2a"].update(ate_float64_card=ate64, rel_diff_float64=e64,
                              wall_s_float64=wall64, launches_float64=counts64)
    f64_only = all(counts64[k] > 0 for k in BUCKETED_F64_KERNELS) and not any(
        v for k, v in counts64.items() if not k.endswith("_f64"))
    if not (np.isfinite(res64.p_opt).all() and e64 <= 1e-6 and f64_only):
        _fail(f"2a in float64 on the card: ATE {ate64} vs the CPU's "
              f"{ate_ref}, launches {counts64}")
    KEEP["2a"] = (sc_a.points_body, sc_a.frame_ids, Ra, pa)
    KEEP["2a_builds"] = builds
    del clouds, sc_a, res, ref, res64

    # ---- 9. path 2b: the sparse corridor at W=512 ----
    clouds = [scene.points_body[scene.frame_ids == i] for i in range(W)]
    reset_launch_counts()
    t0 = time.time()
    res = run_lidar_ba(clouds, Rp, pp, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = paths["2b"] = launch_counts()
    ate0, ate = ate_rmse(pp, scene.p_true), ate_rmse(res.p_opt, scene.p_true)
    st = res.stats["global"]
    iters = sum(s.get("lm_iters", 0) for s in st)
    lm_s = sum(s.get("lm_s", 0.0) for s in st)
    print(f"[2b] run_lidar_ba {W} frames / {scene.points_body.shape[0]} "
          f"points: ATE {ate0:.6f} -> {ate:.6f} m, wall {wall:.2f} s, {iters} "
          f"LM iterations in {lm_s:.3f} s ({lm_s / max(iters, 1) * 1e3:.2f} "
          f"ms/iter), launches {counts}", flush=True)
    _stage_lines("2b", res.stats)
    if not all(counts[k] > 0 for k in BUCKETED_PATH_KERNELS):
        _fail(f"a kernel of path 2b was never launched: {counts}")
    if not (np.isfinite(res.p_opt).all()
            and all(s.get("lm_iters", 0) > 0 for s in st)):
        _fail("2b: the pipeline gave non-finite poses or a stage ran no LM")
    t0 = time.time()
    ref = run_lidar_ba(clouds, Rp, pp, slice_config("float64"), device="cpu")
    ate_ref = ate_rmse(ref.p_opt, scene.p_true)
    print(f"[2b] float64 reference on the CPU: ATE {ate_ref:.6f} m "
          f"({time.time() - t0:.1f} s)", flush=True)
    _stage_lines("2b float64 CPU", ref.stats)
    results["path_2b"] = dict(ate0=ate0, ate=ate, ate_float64_cpu=ate_ref,
                              wall_s=wall, lm_iters=iters, lm_s=lm_s,
                              stats=res.stats, stats_float64_cpu=ref.stats,
                              launches=counts)
    del clouds, res, ref

    # stage 1 of path 2b alone (the same voxel map on every device): the
    # card's float32 LM against the CPU's float64 one, by the final LM
    # residual.  The corridor's ATE moves along near-flat bending modes of
    # the cost (BASELINE.md:71), so float32 and float64 runs that agree on
    # the residual to 1e-6 land at different ATEs; the pipeline's ATE is no
    # measure of agreement there.  The LM builds its frame tables (reading
    # the buckets' ids to the host), inside its timed run, and then reads
    # only its `converged`s.
    def lm_2b():
        return lm_damping_iter(bs, R, p, max_iters=LM_ITERS)

    lm_2b()
    torch.cuda.synchronize()
    t0 = time.time()
    lm = lm_2b()
    torch.cuda.synchronize()
    lm_wall = time.time() - t0
    syncs = _lm_syncs(torch, "2b-lm", lm_2b,
                      tables=lambda: buckets_frame_table(bs, W))
    _, g_c, H_c = cgh(KERNEL_STEPS, bs, tbl_m)
    cg_2b = _cg_check(torch, "2b-lm", H_c.reshape(6 * W, 6 * W),
                      g_c.reshape(-1), torch.full((), 0.01, device=dev))
    del g_c, H_c
    g_size = sum(fa.n.shape[0] for fa in bs)
    res0 = float(sum(plane_cost(fa, R, p) for fa in bs)) / g_size
    bs64 = buckets_to_device(vm, W=W, dtype=torch.float64, device="cpu")
    t0 = time.time()
    lm64 = lm_damping_iter(bs64, torch.as_tensor(Rp), torch.as_tensor(pp),
                           max_iters=LM_ITERS)
    cpu_s = time.time() - t0
    e_res = abs(float(lm.residual) - float(lm64.residual)) / float(
        lm64.residual)
    ate_c = ate_rmse(lm.p.double().cpu().numpy(), scene.p_true)
    ate_c64 = ate_rmse(lm64.p.numpy(), scene.p_true)
    print(f"[2b-lm] lm_damping_iter on stage 1's map ({len(bs)} buckets, "
          f"W={W}): residual {res0:.9g} -> {float(lm.residual):.9g} in "
          f"{lm.iters} iterations, {lm_wall * 1e3:.1f} ms "
          f"({lm_wall / max(lm.iters, 1) * 1e3:.2f} ms/iter incl. the "
          f"frame tables and the initial evaluation); float64 CPU residual "
          f"{float(lm64.residual):.9g} in {lm64.iters} iterations "
          f"({cpu_s:.1f} s): rel diff {e_res:.3e} (tol {TOL_RESID_LM_REL}); "
          f"ATE {ate_c:.6f} m, float64 {ate_c64:.6f} m", flush=True)
    if not (float(lm.residual) < res0 and e_res <= TOL_RESID_LM_REL):
        _fail(f"2b stage-1 LM: residual {res0} -> {float(lm.residual)}, "
              f"float64 {float(lm64.residual)}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm_2b()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy = sum(v[0] for v in _device_ms(prof).values())
    idle = 1.0 - busy / (prof_wall * 1e3)
    idle_w = 1.0 - busy / (lm_wall * 1e3)
    print(f"[2b-lm] under torch.profiler: {prof_wall * 1e3:.1f} ms wall, "
          f"{busy:.1f} ms device busy, idle share {idle:.3f} (one window); "
          f"a cross-run estimate, that device time over the unprofiled "
          f"run's {lm_wall * 1e3:.1f} ms wall: {idle_w:.3f}", flush=True)
    results["path_2b"]["stage1_lm"] = dict(
        residual0=res0, residual=float(lm.residual),
        residual_float64_cpu=float(lm64.residual), rel_diff=e_res,
        iters=lm.iters, iters_float64_cpu=lm64.iters, wall_ms=lm_wall * 1e3,
        ms_per_iter=lm_wall / max(lm.iters, 1) * 1e3, ate=ate_c,
        ate_float64_cpu=ate_c64, profiled_wall_ms=prof_wall * 1e3,
        device_busy_ms=busy, idle_share=idle,
        idle_share_cross_run_estimate=idle_w, host_reads=syncs, cg=cg_2b)
    # ---- 9b. [cg_mf]: the same map through the matrix-free rows route ----
    _cg_mf(torch, kern, results, paths, bs, bs64, R, p, Rp, pp, W, lm)
    KEEP["2b"] = (bs, R, p)


def _corridor_clouds(np, scene, W):
    """The scene's points split by frame (one pass: the frame ids are
    grouped by a stable sort)."""
    order = np.argsort(scene.frame_ids, kind="stable")
    counts = np.bincount(scene.frame_ids, minlength=W)
    return np.split(scene.points_body[order], np.cumsum(counts)[:-1])


def _large_map(np, W, cfg):
    """The corridor at W frames of LARGE_PPF points, the perturbed poses
    and stage 1's voxel map on them (path 2b's settings)."""
    from global_lvba_tpu_torch.map.voxelize import build_voxel_map
    from global_lvba_tpu_torch.models.synthetic import (
        make_corridor_scene, perturb_poses)

    scene = make_corridor_scene(W, LARGE_PPF, seed=0)
    Rp, pp = perturb_poses(scene.R_true, scene.p_true, 0.003, 0.01, seed=1)
    vm = build_voxel_map(
        scene.points_body, scene.frame_ids, Rp, pp, VOXEL,
        eigen_ratios=[RATIO] * 4, min_ps=cfg.solver.min_ps,
        layer_limit=cfg.solver.layer_limit)
    return scene, Rp, pp, vm


def _group_info(groups):
    from global_lvba_tpu_torch.factors.plane_eigen import group_width

    return [dict(G=int(bg.fa.n.shape[0]), Vp=int(bg.fa.n.shape[1]),
                 K=int(bg.fa.n.shape[2]), width=group_width(bg),
                 Vw=int(bg.wide_fa.n.shape[0])) for bg in groups]


def _idle(torch, run, wall_ms):
    """run() under torch.profiler: (wall ms, device busy ms, idle share in
    that window, the busy time over the unprofiled `wall_ms`), and the
    device ms by op name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    dev_ms = _device_ms(prof)
    busy = sum(v[0] for v in dev_ms.values())
    return prof_wall, busy, 1.0 - busy / prof_wall, 1.0 - busy / wall_ms, \
        dev_ms


def _top_ops(dev_ms, n=10):
    return [(k[:56], round(v[0], 4), v[1])
            for k, v in sorted(dev_ms.items(), key=lambda kv: -kv[1][0])[:n]]


def _eval_kernels(torch, kern, results, tag, fas, cols, widths, table, R,
                  p, W, evaluate, f64=False):
    """[tag]: the kernels of one large-W evaluation held against their
    plain versions at the shapes that evaluation gives them, then the
    evaluation against the plain one.  fas: its buckets (the flattened
    group stacks and the straggler buckets, or the rows route's buckets),
    cols and widths: each one's chain column ids (local, global or slot
    ids) and chain width, table: its merged frame table, evaluate(steps,
    fas) -> (r, sums: [g, Hd, Grams...], rows: [A...]).  table_select over
    every bucket's global ids bitwise equal (a copy); soa_agg on the
    selected rows under _agg_check; soa_chain_entries at each width on its
    column ids (rows, jjt and the diagonal extras within TOL_ROWS_REL of
    max |.|, dead entries' channels zero); entry_reduce over the merged
    table within TOL_SUM_REL, two calls bitwise equal; the evaluation as
    [eval 2b]: r within TOL_EVAL_REL beyond the line-like voxels' slack,
    the sums within TOL_EVAL_REL and the rows within TOL_ROWS_REL on the
    well-conditioned voxels.  With f64 (float64 operands) the float64
    instances under the TOL64_* limits; evaluate None leaves the
    evaluation out.  Each kernel's max abs error goes to results and
    raises its kernels-line max_abs_err."""
    from global_lvba_tpu_torch.factors.plane_eigen import (
        KERNEL_STEPS, PLAIN_STEPS, pose_table)
    from global_lvba_tpu_torch.kernels.selection import (
        entry_reduce, entry_reduce_plain, table_select_buckets,
        table_select_buckets_plain)
    from global_lvba_tpu_torch.kernels.soa import (
        soa_agg_buckets, soa_agg_plain, soa_chain_entries,
        soa_chain_entries_plain)

    if f64:
        tol_agg = (TOL64_RESIDV_REL, TOL64_RESIDV_REL_LINE, TOL64_PV)
        tol_rows, tol_sum, sfx = TOL64_ROWS_REL, TOL64_SUM_REL, "_f64"
    else:
        tol_agg = (TOL_RESIDV_REL, TOL_RESIDV_REL_LINE, TOL_PV)
        tol_rows, tol_sum, sfx = TOL_ROWS_REL, TOL_SUM_REL, ""
    pose12 = pose_table(R, p)
    frames = [fa.frame.reshape(-1) for fa in fas]
    sel_k = table_select_buckets(frames, pose12)
    sel_p = table_select_buckets_plain(frames, pose12)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(sel_k, sel_p)):
        _fail(f"{tag}: table_select disagrees with its plain version")
    poses = [s.view(*fa.n.shape, 12) for s, fa in zip(sel_k, fas)]
    ops = [(fa.n, fa.mu, fa.Pc, ps) for fa, ps in zip(fas, poses)]
    agg_k = soa_agg_buckets(ops)
    agg_p = [soa_agg_plain(*o) for o in ops]
    spec = [_spectrum(torch, fa, ps) for fa, ps in zip(fas, poses)]
    gap, lam0, lam2 = (torch.cat([x[i] for x in spec]) for i in range(3))
    live = torch.cat([fa.n.sum(dim=1) > 0 for fa in fas])
    wc = live & (gap >= WELL_CONDITIONED_GAP)
    err_agg = _agg_check(
        torch, f"soa_agg{sfx} {tag}", torch.cat([a[0] for a in agg_k]),
        torch.cat([a[0] for a in agg_p]), torch.cat([a[1] for a in agg_k]),
        torch.cat([a[1] for a in agg_p]), live, wc, lam0, lam2, tols=tol_agg,
        ref64=not f64)
    del agg_p, spec
    vk, vp, err_A, abs_A = [], [], 0.0, 0.0
    for fa, ps, (_, pv), c, w in zip(fas, poses, agg_k, cols, widths):
        args = (fa.n, fa.mu, fa.Pc, ps, c, pv, w)
        A_k, v_k = soa_chain_entries(*args)
        A_p, v_p = soa_chain_entries_plain(*args)
        err_A = max(err_A, _rel(A_k, A_p))
        abs_A = max(abs_A, float((A_k - A_p).abs().max()))
        vk.append(v_k)
        vp.append(v_p)
        del A_k, A_p
    vk, vp = torch.cat(vk), torch.cat(vp)
    err_j, err_d = _rel(vk[:, :6], vp[:, :6]), _rel(vk[:, 6:], vp[:, 6:])
    live_s = torch.cat([fa.n.reshape(-1) > 0 for fa in fas])
    dead_ok = bool((vk[~live_s] == 0).all())
    red_k, red_k2 = entry_reduce(vk, table), entry_reduce(vk, table)
    red_p = entry_reduce_plain(vk, table)
    torch.cuda.synchronize()
    err_red, rep = _rel(red_k, red_p), bool(torch.equal(red_k, red_k2))
    abs_red = float((red_k - red_p).abs().max())
    del vk, vp, red_k2
    out = dict(buckets=[list(fa.n.shape) for fa in fas], widths=list(widths),
               table=list(table.shape), soa_agg=err_agg,
               soa_chain_entries=dict(rows=err_A, jjt=err_j, extras=err_d,
                                      max_abs=abs_A, dead_zero=dead_ok),
               entry_reduce=dict(rel=err_red, max_abs=abs_red,
                                 repeatable=rep))
    print(f"[{tag}] kernels at this evaluation's shapes (buckets "
          f"{out['buckets']}, chain widths {out['widths']}, table "
          f"{out['table']}): table_select{sfx} bitwise equal; "
          f"soa_chain_entries{sfx} rows rel err {err_A:.3e}, jjt "
          f"{err_j:.3e}, extras {err_d:.3e} (tol {tol_rows}), dead entries' "
          f"channels == 0: {dead_ok}; entry_reduce{sfx} rel err "
          f"{err_red:.3e} (tol {tol_sum}), two calls bitwise equal: {rep}",
          flush=True)
    ok = (max(err_A, err_j, err_d) <= tol_rows and dead_ok
          and err_red <= tol_sum and rep)
    if evaluate is not None:
        r1, sums_k, rows_k = evaluate(KERNEL_STEPS, fas)
        r_p = evaluate(PLAIN_STEPS, fas)[0]
        line_like = live & ~wc
        r_slack = TOL_RESIDV_REL_LINE * float(lam2[line_like].abs().sum())
        e_r = max(0.0, abs(float(r1) - float(r_p)) - r_slack) / abs(
            float(r_p))
        del sums_k, rows_k
        wcs = torch.split(wc, [fa.n.shape[0] for fa in fas])
        fas_wc = [fa._replace(n=fa.n * w[:, None].to(fa.n.dtype))
                  for fa, w in zip(fas, wcs)]
        _, sums_k, rows_k = evaluate(KERNEL_STEPS, fas_wc)
        _, sums_p, rows_p = evaluate(PLAIN_STEPS, fas_wc)
        torch.cuda.synchronize()
        e_each = [_rel(a, b) for a, b in zip(sums_k, sums_p)]
        e_rows = max((_rel(a, b) for a, b in zip(rows_k, rows_p)),
                     default=0.0)
        del sums_k, sums_p, rows_k, rows_p, fas_wc
        out["eval"] = dict(r=e_r, g=e_each[0], Hd=e_each[1],
                           grams=max(e_each[2:], default=0.0), rows=e_rows,
                           line_like_voxels=int(line_like.sum()))
        print(f"[{tag}] the evaluation, kernels vs plain: r {e_r:.3e} "
              f"(beyond the line-like voxels' {r_slack:.3e}), g "
              f"{e_each[0]:.3e}, Hd {e_each[1]:.3e}, Grams "
              f"{out['eval']['grams']:.3e} (tol {TOL_EVAL_REL}), rows "
              f"{e_rows:.3e} (tol {TOL_ROWS_REL}) on well-conditioned "
              f"voxels", flush=True)
        ok = ok and e_rows <= TOL_ROWS_REL and max(
            e_r, *e_each) <= TOL_EVAL_REL
    if not ok:
        _fail(f"{tag}: a kernel or the evaluation disagrees with its plain "
              f"version at these shapes: {out}")
    results.setdefault("large_w_kernels", {})[tag] = out
    for k, e in (("table_select", 0.0), ("soa_agg", err_agg),
                 ("soa_chain_entries", abs_A), ("entry_reduce", abs_red)):
        kern[k + sfx]["max_abs_err"] = max(kern[k + sfx]["max_abs_err"], e)
    return out


def _banded_evaluate(plan, R, p, W):
    """_eval_kernels' evaluate of a BandedPlan: the compact evaluation
    over the stacks and straggler buckets given."""
    from global_lvba_tpu_torch.factors.plane_eigen import _banded_eval

    ns = len(plan.stacks)

    def evaluate(steps, fas):
        r, g, Hd, grams, wide = _banded_eval(
            steps, plan._replace(stacks=fas[:ns], wide=fas[ns:]), R, p, W,
            True)
        return r, [g, Hd, *grams], wide

    return evaluate


def _plan_kernels(torch, kern, results, tag, plan, R, p, W):
    """_eval_kernels over a BandedPlan: the stacks at width 2B on their
    local ids, the straggler buckets at W on their global ids."""
    return _eval_kernels(
        torch, kern, results, tag, plan.stacks + plan.wide,
        plan.local + [fa.frame for fa in plan.wide],
        [d[2] for d in plan.dims] + [W] * len(plan.wide), plan.table, R, p,
        W, _banded_evaluate(plan, R, p, W))


def _large_lm(torch, np, tag, vm, Rp, pp, W, scene, dev, route_name, paths):
    """Stage 1's LM alone on the card (LARGE_LM_ITERS iterations, launch
    counts set to 0 just before the measured run and kept as the path's)
    against the float64 CPU LM on the same voxel map: the residual must
    fall and land within TOL_RESID_LM_REL of the CPU's; the route from the
    loop's record; ms per iteration, peak device memory, the synchronizing
    calls (plan_route's set-up reads, then the loop's: one `converged` an
    iteration) and the idle share under torch.profiler."""
    from global_lvba_tpu_torch.factors.padding import buckets_to_device
    from global_lvba_tpu_torch.factors.plane_eigen import plane_cost
    from global_lvba_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    from global_lvba_tpu_torch.models.synthetic import ate_rmse
    from global_lvba_tpu_torch.solver import dist_solve, lm as lm_mod
    from global_lvba_tpu_torch.solver.lm import lm_damping_iter, plan_route

    bs = buckets_to_device(vm, W=W, dtype=torch.float32, device=dev)
    R = torch.as_tensor(Rp, dtype=torch.float32, device=dev)
    p = torch.as_tensor(pp, dtype=torch.float32, device=dev)

    def run():
        return lm_damping_iter(bs, R, p, max_iters=LARGE_LM_ITERS)

    # the earlier phases' graphs (and their copies of operands) go first,
    # so the peak below is this LM's own
    dist_solve._GRAPHS.clear()
    run()               # captures the damped solve's graph
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    graphs = set(map(id, dist_solve._GRAPHS.values()))
    t0 = time.time()
    lm = run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = paths[tag] = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # the solve's graph is cached by its operands' shapes: the measured
    # run must find the warm-up's (a capture here costs ~0.1 s)
    captures = sum(id(g) not in graphs for g in dist_solve._GRAPHS.values())
    # the route's set-up (plan_route: the buckets' ids and counts read to
    # the host, the groups and tables built) and the loop counted apart:
    # the loop must synchronize once an iteration (`converged`)
    t0 = time.perf_counter()
    route, setup_syncs = _count_syncs(torch, lambda: plan_route(bs, W))
    t1 = time.perf_counter()
    res_l, loop_syncs = _count_syncs(torch, lambda: lm_mod._run(
        route, R, p, LARGE_LM_ITERS, 0.01, 2.0, 1e-6))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    _, all_syncs = _count_syncs(torch, run)
    syncs = dict(setup=setup_syncs, loop=loop_syncs, lm_damping_iter=all_syncs)
    setup_ms, loop_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    print(f"[{tag}] synchronizing calls under sync debug mode \"warn\": "
          f"the route's set-up {setup_syncs} ({setup_ms:.1f} ms of wall), "
          f"its loop {loop_syncs} in {res_l.iters} iterations (one read of "
          f"`converged` each; {loop_ms:.1f} ms of wall, "
          f"{loop_ms / max(res_l.iters, 1):.2f} ms/iter with the initial "
          f"evaluation); lm_damping_iter in all {all_syncs}", flush=True)
    if loop_syncs != res_l.iters or not torch.equal(res_l.p, lm.p):
        _fail(f"{tag}: the loop synchronized {loop_syncs} times in "
              f"{res_l.iters} iterations, or differs from lm_damping_iter")
    g_size = sum(fa.n.shape[0] for fa in bs)
    res0 = float(sum(plane_cost(fa, R, p) for fa in bs)) / g_size
    bs64 = buckets_to_device(vm, W=W, dtype=torch.float64, device="cpu")
    t0 = time.time()
    lm64 = lm_damping_iter(bs64, torch.as_tensor(Rp), torch.as_tensor(pp),
                           max_iters=LARGE_LM_ITERS)
    cpu_s = time.time() - t0
    e_res = abs(float(lm.residual) - float(lm64.residual)) / float(
        lm64.residual)
    ate_c = ate_rmse(lm.p.double().cpu().numpy(), scene.p_true)
    ate_c64 = ate_rmse(lm64.p.numpy(), scene.p_true)
    ms_iter = wall / max(lm.iters, 1) * 1e3
    print(f"[{tag}] lm_damping_iter on stage 1's map ({len(bs)} buckets, "
          f"W={W}), route {lm.route} (the CPU's {lm64.route}): residual "
          f"{res0:.9g} -> {float(lm.residual):.9g} in {lm.iters} iterations "
          f"(max_iters {LARGE_LM_ITERS}, the JAX bench's), {wall * 1e3:.1f} "
          f"ms ({ms_iter:.2f} ms/iter incl. the route's set-up and the "
          f"initial evaluation, {captures} graph captures); peak device "
          f"memory {peak / 1e9:.3f} GB "
          f"((6W)² float32 = {(6 * W) ** 2 * 4 / 1e9:.3f} GB); float64 CPU "
          f"residual {float(lm64.residual):.9g} in {lm64.iters} iterations "
          f"({cpu_s:.1f} s): rel diff {e_res:.3e} (tol {TOL_RESID_LM_REL}); "
          f"ATE {ate_c:.6f} m, float64 {ate_c64:.6f} m; launches {counts}",
          flush=True)
    if not (lm.route == route_name == lm64.route
            and float(lm.residual) < res0 and e_res <= TOL_RESID_LM_REL
            and bool(torch.isfinite(lm.p).all())):
        _fail(f"{tag} stage-1 LM: route {lm.route}, residual {res0} -> "
              f"{float(lm.residual)}, float64 {float(lm64.residual)}")
    if not all(counts[k] > 0 for k in BANDED_PATH_KERNELS):
        _fail(f"{tag}: a kernel of the banded path was never launched: "
              f"{counts}")
    prof_wall, busy, idle, idle_w, dev_ms = _idle(torch, run, wall * 1e3)
    print(f"[{tag}] under torch.profiler: {prof_wall:.1f} ms wall, "
          f"{busy:.1f} ms device busy, idle share {idle:.3f} (one window); "
          f"that device time over the unprofiled run's {wall * 1e3:.1f} ms "
          f"wall: {idle_w:.3f}; device ms by op (ms, calls) over the run: "
          f"{_top_ops(dev_ms)}", flush=True)
    return bs, R, p, dict(
        route=lm.route, residual0=res0, residual=float(lm.residual),
        residual_float64_cpu=float(lm64.residual), rel_diff=e_res,
        iters=lm.iters, iters_float64_cpu=lm64.iters, wall_ms=wall * 1e3,
        ms_per_iter=ms_iter, setup_ms=setup_ms, loop_ms=loop_ms, cpu_s=cpu_s,
        graph_captures=captures,
        ate=ate_c, ate_float64_cpu=ate_c64,
        peak_bytes=peak, host_reads=syncs, launches=counts,
        profiled_wall_ms=prof_wall, device_busy_ms=busy, idle_share=idle,
        idle_share_cross_run_estimate=idle_w,
        device_ms_by_op=_top_ops(dev_ms, 20))


def _banded_dense(torch, np, dev, kern, results, paths):
    """[2c-dense]: the corridor at W = 2048 (1024 <= W < SPLIT_W, bucketed:
    the banded route with the dense H).  The banded H against the
    dense-Gram evaluation's on the same map (r, g, H within TOL_EVAL_REL),
    two banded evaluations bitwise equal, the same with the block forced
    to SMALL_BLOCK (stragglers: syrk must launch), each evaluation's
    kernels under torch.profiler, and stage 1's LM against the float64
    CPU LM."""
    from torch.profiler import ProfilerActivity, profile

    from global_lvba_tpu_torch.__main__ import slice_config
    from global_lvba_tpu_torch.factors.padding import buckets_to_device
    from global_lvba_tpu_torch.factors.plane_eigen import (
        banded_cost, banded_cost_grad_hess, banded_plan, build_banded_groups,
        buckets_frame_table, plane_cost_grad_hess_buckets)
    from global_lvba_tpu_torch.kernels import launch_counts
    from global_lvba_tpu_torch.solver import dist_solve
    from global_lvba_tpu_torch.solver.lm import BANDED_CG_ITERS, plan_route

    W = LARGE_DENSE_FRAMES
    cfg = slice_config("float32")
    t0 = time.time()
    scene, Rp, pp, vm = _large_map(np, W, cfg)
    print(f"[2c-dense] corridor W={W}: {scene.points_body.shape[0]} points, "
          f"{vm.num_planes} planes ({time.time() - t0:.1f} s)", flush=True)
    bs = buckets_to_device(vm, W=W, dtype=torch.float32, device=dev)
    R = torch.as_tensor(Rp, dtype=torch.float32, device=dev)
    p = torch.as_tensor(pp, dtype=torch.float32, device=dev)
    route = plan_route(bs, W)
    groups = [build_banded_groups(fa, W) for fa in bs]
    saving = banded_cost(groups, bs, W)
    plan = banded_plan(groups, W)
    info = dict(route=route.name, trips=route.trips,
                buckets=[list(fa.n.shape) for fa in bs],
                groups=_group_info(groups),
                dense_over_banded_flops=saving[1] / saving[0])
    print(f"[2c-dense] {info}", flush=True)
    if route.name != "banded":
        _fail(f"2c-dense: route {route.name}, not banded")
    table = buckets_frame_table(bs, W)
    rb, gb, Hb = banded_cost_grad_hess(plan, R, p, W)
    rb2, gb2, Hb2 = banded_cost_grad_hess(plan, R, p, W)
    torch.cuda.synchronize()
    same = bool(torch.equal(rb, rb2) and torch.equal(gb, gb2)
                and torch.equal(Hb, Hb2) and torch.isfinite(Hb).all())
    del rb2, gb2, Hb2
    rd, gd, Hd_ = plane_cost_grad_hess_buckets(bs, R, p, W, table)
    e = dict(r=abs(float(rb) - float(rd)) / abs(float(rd)), g=_rel(gb, gd),
             H=_rel(Hb, Hd_))
    del Hb
    before = launch_counts()["syrk"]
    groups16 = [build_banded_groups(fa, W, block=SMALL_BLOCK) for fa in bs]
    plan16 = banded_plan(groups16, W)
    rs, gs, Hs = banded_cost_grad_hess(plan16, R, p, W)
    torch.cuda.synchronize()
    syrk_n = launch_counts()["syrk"] - before
    vw = sum(int(bg.wide_fa.n.shape[0]) for bg in groups16)
    e16 = dict(r=abs(float(rs) - float(rd)) / abs(float(rd)), g=_rel(gs, gd),
               H=_rel(Hs, Hd_))
    del Hd_
    # the compact route with stragglers: its kernels at these shapes, its
    # solve as [banded-cg], and its step against the dense-H CG's on the
    # same linearization (the same trips)
    _plan_kernels(torch, kern, results, "2c-dense-kernels", plan, R, p, W)
    _plan_kernels(torch, kern, results, "2c-dense-stragglers-kernels",
                  plan16, R, p, W)
    rec16, _, u0, x16 = _banded_cg(torch, "2c-dense stragglers", plan16, R,
                                   p, W)
    x_h = dist_solve.solve_damped_cg(Hs.reshape(6 * W, 6 * W),
                                     gs.reshape(-1), u0,
                                     max_iters=BANDED_CG_ITERS)
    e_step = _rel(x16, x_h)
    print(f"[2c-dense stragglers] the compact banded CG's step vs "
          f"solve_damped_cg's on the dense H with the stragglers "
          f"({BANDED_CG_ITERS} trips each): rel diff {e_step:.3e} (tol "
          f"{TOL_STEP_REL}, relative to max |x|)", flush=True)
    if not e_step <= TOL_STEP_REL:
        _fail("2c-dense: the compact banded CG's step departs from the "
              "dense-H CG's")
    rec16.update(step_vs_dense_cg=e_step)
    del Hs, x16, x_h
    eval_ms, ahead = _timed(torch, lambda: banded_cost_grad_hess(plan, R, p,
                                                                 W), reps=3)
    dense_ms, ahead_d = _timed(torch, lambda: plane_cost_grad_hess_buckets(
        bs, R, p, W, table), reps=3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        banded_cost_grad_hess(plan, R, p, W)
        torch.cuda.synchronize()
    ev = _device_ms(prof)
    print(f"[2c-dense] banded vs dense-Gram evaluation: rel err {e} (tol "
          f"{TOL_EVAL_REL}); bitwise repeatable and finite: {same}; block "
          f"{SMALL_BLOCK}: {vw} straggler voxels, {syrk_n} syrk launches, "
          f"rel err {e16}; banded evaluation {eval_ms:.3f} ms device time "
          f"(queued ahead {ahead}), dense-Gram {dense_ms:.3f} ms (queued "
          f"ahead {ahead_d}); one banded evaluation by op (ms, calls): "
          f"{_top_ops(ev)}", flush=True)
    if not (same and max(e.values()) <= TOL_EVAL_REL and vw > 0
            and syrk_n > 0 and max(e16.values()) <= TOL_EVAL_REL):
        _fail("2c-dense: the banded H disagrees with the dense one, is not "
              "repeatable, or the straggler path did not run")
    del rb, gb, rd, gd, rs, gs, groups16, plan16
    _, _, _, lmres = _large_lm(torch, np, "2c-dense", vm, Rp, pp, W, scene,
                               dev, "banded", paths)
    results["path_2c_dense"] = dict(
        info, points=int(scene.points_body.shape[0]), planes=vm.num_planes,
        eval_rel=e, bitwise_repeatable=same, stragglers_block=SMALL_BLOCK,
        straggler_voxels=vw, straggler_syrk_launches=syrk_n, eval_rel_block=e16,
        eval_ms=eval_ms, dense_eval_ms=dense_ms,
        eval_device_ms_by_op=_top_ops(ev, 20), stage1_lm=lmres,
        compact_stragglers=rec16)


def _no_dense_operand(torch, tag, plan, R, p, W, u0):
    """[tag]: no op of one compact evaluation of `plan` and one solve (its
    trips run eagerly: a graph replay shows no op) takes an operand of
    (6W)² elements (torch.profiler with record_shapes).  Returns the
    largest operand's elements."""
    from torch.profiler import ProfilerActivity, profile

    from global_lvba_tpu_torch.factors.plane_eigen import (
        banded_cost_grad_compact)
    from global_lvba_tpu_torch.solver import dist_solve
    from global_lvba_tpu_torch.solver.lm import BANDED_CG_ITERS

    big = (6 * W) ** 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        st = banded_cost_grad_compact(plan, R, p, W)
        dist_solve._damped_cg_banded(st[2], st[1], u0, st[3],
                                     [A for A in st[4] if A.shape[0]],
                                     plan.windows[0], plan.windows[1],
                                     BANDED_CG_ITERS, 1e-10)
        torch.cuda.synchronize()
    largest, hits = 0, []
    for ev in prof.events():
        for shp in ev.input_shapes or ():
            if isinstance(shp, (list, tuple)) and shp and all(
                    isinstance(s, int) for s in shp):
                n = math.prod(shp)
                largest = max(largest, n)
                if n >= big:
                    hits.append((ev.name, shp))
    ev_ms = _device_ms(prof)
    del st
    print(f"[{tag}] one evaluation and one solve's trips under "
          f"torch.profiler (record_shapes): largest operand {largest} "
          f"elements, (6W)² = {big}; ops at or above it: {hits[:5]}; device "
          f"ms by op (ms, calls): {_top_ops(ev_ms)}", flush=True)
    if hits:
        _fail(f"{tag}: an op takes a (6W)²-element operand: {hits[:5]}")
    return largest


def _banded_cg(torch, tag, plan, R, p, W):
    """[tag]: the compact evaluation of `plan` queued under sync debug mode
    "error", then its banded CG (BANDED_CG_ITERS done-masked trips, one
    CUDA graph replay, the graph cache emptied first and the capture
    timed): one solve under "error", two solves bitwise equal and finite,
    within 1e-6 of the same trips run eagerly (relative to max |x|), and
    device ms of both.  Returns (the record, the state (r, g, Hd, grams,
    wide), u, the step)."""
    from global_lvba_tpu_torch.factors.plane_eigen import (
        banded_cost_grad_compact)
    from global_lvba_tpu_torch.solver import dist_solve
    from global_lvba_tpu_torch.solver.lm import BANDED_CG_ITERS

    u0 = torch.full((), 0.01, dtype=R.dtype, device=R.device)
    dist_solve._GRAPHS.clear()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        st = banded_cost_grad_compact(plan, R, p, W)
        eval_host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    r, g, Hd, grams, wide = st
    wides = [A for A in wide if A.shape[0]]

    def solve():
        return dist_solve.solve_damped_cg_banded(
            grams, wide, plan.offsets, Hd, g, u0, max_iters=BANDED_CG_ITERS,
            windows=plan.windows)

    def eager():
        return dist_solve._damped_cg_banded(
            Hd, g, u0, grams, wides, plan.windows[0], plan.windows[1],
            BANDED_CG_ITERS, 1e-10)

    x1, _ = solve()
    torch.cuda.synchronize()
    capture_s = next(reversed(dist_solve._GRAPHS.values())).capture_s
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        x2, _ = solve()
        host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    x_e, _ = eager()
    torch.cuda.synchronize()
    same = bool(torch.equal(x1, x2) and torch.isfinite(x1).all())
    err = _rel(x1, x_e)
    cg_ms, ahead = _timed(torch, solve, reps=3)
    eager_ms, ahead_e = _timed(torch, eager, reps=3)
    vw = sum(A.shape[0] // 3 for A in wides)
    print(f"[{tag}] compact banded CG (W={W}, {vw} straggler voxels, "
          f"{BANDED_CG_ITERS} done-masked trips, one CUDA graph replay): "
          f"the evaluation queued in {eval_host_ms:.3f} ms and one solve in "
          f"{host_ms:.3f} ms of host time under sync debug mode \"error\"; "
          f"graph captured in {capture_s * 1e3:.1f} ms; {cg_ms:.3f} ms device "
          f"time (queued ahead {ahead}), the same trips run eagerly "
          f"{eager_ms:.3f} ms (queued ahead {ahead_e}); two solves bitwise "
          f"equal and finite: {same}; graph vs eager rel diff {err:.3e}",
          flush=True)
    if not (same and err <= 1e-6):
        _fail(f"{tag}: the compact solve is not repeatable or departs from "
              f"its eager trips")
    rec = dict(capture_s=capture_s, ms=cg_ms, eager_ms=eager_ms,
               host_ms=host_ms, eval_host_ms=eval_host_ms, repeatable=same,
               eager_rel=err, straggler_voxels=vw)
    return rec, st, u0, x1


def _large_w(torch, np, dev, kern, results, paths):
    """Path 2c, the main path at the JAX bench's W = 4096 (bench.py:501-571),
    with [banded-cg]; then [2c-dense] (W = 2048).  Returns stage 1's
    buckets and poses on the card (bs, R, p), which phase 19 reuses."""
    from torch.profiler import ProfilerActivity, profile

    from global_lvba_tpu_torch.__main__ import slice_config
    from global_lvba_tpu_torch.factors.plane_eigen import (
        KERNEL_STEPS, _pose_operands, banded_cost, banded_cost_grad_compact,
        banded_plan, build_banded_groups, pose_table)
    from global_lvba_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    from global_lvba_tpu_torch.kernels.gram import syrk_
    from global_lvba_tpu_torch.kernels.soa import (
        soa_agg_buckets, soa_chain_entries)
    from global_lvba_tpu_torch.models.synthetic import ate_rmse
    from global_lvba_tpu_torch.pipeline.lidar_ba import run_lidar_ba

    W = LARGE_FRAMES
    cfg = slice_config("float32")
    t0 = time.time()
    scene, Rp, pp, vm = _large_map(np, W, cfg)
    clouds = _corridor_clouds(np, scene, W)
    print(f"[2c] corridor W={W}: {scene.points_body.shape[0]} points, stage "
          f"1's map {vm.num_planes} planes, tiers "
          f"{[list(b.n.shape) for b in vm.buckets]} ({time.time() - t0:.1f} "
          f"s)", flush=True)
    reset_launch_counts()
    t0 = time.time()
    res = run_lidar_ba(clouds, Rp, pp, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = paths["2c"] = launch_counts()
    ate0, ate = ate_rmse(pp, scene.p_true), ate_rmse(res.p_opt, scene.p_true)
    st = res.stats["global"]
    routes = [s.get("lm_route") for s in st]
    print(f"[2c] run_lidar_ba {W} frames: ATE {ate0:.6f} -> {ate:.6f} m, "
          f"wall {wall:.2f} s, routes {routes}, launches {counts}",
          flush=True)
    _stage_lines("2c", res.stats)
    if not (np.isfinite(res.p_opt).all() and len(st) == 2
            and routes == ["split-banded"] * 2
            and all(s.get("lm_iters", 0) > 0 for s in st)):
        _fail(f"2c: non-finite poses, or a stage ran no LM or took another "
              f"route: {routes}")
    if not all(counts[k] > 0 for k in BANDED_PATH_KERNELS):
        _fail(f"2c: a kernel of the banded path was never launched: {counts}")
    results["path_2c"] = dict(
        points=int(scene.points_body.shape[0]), ate0=ate0, ate=ate,
        wall_s=wall, routes=routes, stats=res.stats, launches=counts)
    del res, clouds

    KEEP["2c"] = (vm, Rp, pp, scene.p_true)
    # stage 1's LM alone, against the float64 CPU LM on the same map
    bs, R, p, lmres = _large_lm(torch, np, "2c-lm", vm, Rp, pp, W, scene,
                                dev, "split-banded", {})
    results["path_2c"]["stage1_lm"] = lmres
    print(f"[2c] ATE: the pipeline {ate:.6f} m; stage 1's LM on the card "
          f"{lmres['ate']:.6f} m, the float64 CPU LM's {lmres['ate_float64_cpu']:.6f} m "
          f"(scene-noise-bound at this W)", flush=True)

    # the kernels at the stacks' shapes, [banded-cg], and the same with
    # the block forced small (stragglers at full width)
    groups = [build_banded_groups(fa, W) for fa in bs]
    saving = banded_cost(groups, bs, W)
    plan = banded_plan(groups, W)
    results["path_2c"]["groups"] = _group_info(groups)
    print(f"[2c] banded groups {_group_info(groups)}; dense/banded Gram "
          f"flops {saving[1] / saving[0]:.1f}x", flush=True)
    _plan_kernels(torch, kern, results, "2c-kernels", plan, R, p, W)
    results["banded_cg"], _, u0, _ = _banded_cg(torch, "banded-cg", plan, R,
                                                p, W)
    groups16 = [build_banded_groups(fa, W, block=SMALL_BLOCK) for fa in bs]
    plan16 = banded_plan(groups16, W)
    results["banded_cg_stragglers"], _, _, _ = _banded_cg(
        torch, "banded-cg stragglers", plan16, R, p, W)
    results["banded_cg_stragglers"]["groups"] = _group_info(groups16)
    del groups16, plan16

    largest = _no_dense_operand(torch, "2c", plan, R, p, W, u0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        banded_cost_grad_compact(plan, R, p, W)
        torch.cuda.synchronize()
    per_eval = _device_ms(prof)
    eval_ms, ahead_ev = _timed(torch, lambda: banded_cost_grad_compact(
        plan, R, p, W), reps=3)
    print(f"[2c] compact evaluation {eval_ms:.3f} ms device time (queued "
          f"ahead {ahead_ev}); by op (ms, calls): {_top_ops(per_eval)}",
          flush=True)

    # the group Grams (torch.bmm, a library call) beside syrk_ group by
    # group on the same operands
    pose12 = pose_table(R, p)
    poses = _pose_operands(KERNEL_STEPS, plan.stacks, pose12, W)
    aggs = soa_agg_buckets([(fa.n, fa.mu, fa.Pc, ps)
                            for fa, ps in zip(plan.stacks, poses)])
    A3s = []
    for fa, ps, (_, pv), loc, (G, Vp, w) in zip(
            plan.stacks, poses, aggs, plan.local, plan.dims):
        A, _ = soa_chain_entries(fa.n, fa.mu, fa.Pc, ps, loc, pv, w)
        A3s.append(A.view(G, 3 * Vp, 6 * w))
    bmm_ms, ahead_b = _timed(torch, lambda: [torch.bmm(A.transpose(1, 2), A)
                                             for A in A3s], reps=3)
    scratch = [torch.zeros((A.shape[0], A.shape[2], A.shape[2]),
                           dtype=A.dtype, device=dev) for A in A3s]
    syrk_ms, ahead_s = _timed(torch, lambda: [
        [syrk_(s[i], A[i]) for i in range(A.shape[0])]
        for s, A in zip(scratch, A3s)], reps=3)
    flops = sum(2 * A.shape[0] * A.shape[1] * A.shape[2] ** 2 for A in A3s)
    gram_err = max(_rel(torch.stack([syrk_(torch.zeros_like(s[i]), A[i])
                                     for i in range(A.shape[0])]),
                        torch.bmm(A.transpose(1, 2), A))
                   for s, A in zip(scratch, A3s))
    print(f"[2c] group Grams per evaluation: torch.bmm {bmm_ms:.4f} ms "
          f"(queued ahead {ahead_b}), syrk_ a group at a time "
          f"{syrk_ms:.4f} ms (queued ahead {ahead_s}), "
          f"{flops / 1e9:.2f} GFLOP (full products), syrk vs bmm rel diff "
          f"{gram_err:.3e}; fp32 bound {flops / FP32_FLOP_PER_S * 1e3:.4f} "
          f"ms", flush=True)
    results["path_2c"].update(
        dense_over_banded_flops=saving[1] / saving[0], eval_ms=eval_ms,
        eval_device_ms_by_op=_top_ops(per_eval, 20),
        largest_operand=largest, group_gram_bmm_ms=bmm_ms,
        group_gram_syrk_ms=syrk_ms, group_gram_gflop=flops / 1e9,
        group_gram_syrk_vs_bmm=gram_err)
    del A3s, scratch, plan, groups

    _banded_dense(torch, np, dev, kern, results, paths)
    return bs, R, p


def _cg_mf(torch, kern, results, paths, bs, bs64, R, p, Rp, pp, W,
           lm_dense):
    """[cg_mf]: path 2b's stage-1 map through lm_damping_iter with
    reduced_solver="cg_mf" (the rows route), launch counts set to 0 just
    before: its residual within TOL_RESID_LM_REL of the float64 CPU rows
    LM's, its poses' largest distance from the dense route's LM on the
    card, ms per iteration and the rows solve's device ms."""
    from global_lvba_tpu_torch.factors.plane_eigen import _rows_eval, rows_plan
    from global_lvba_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    from global_lvba_tpu_torch.solver.lm import (
        ROWS_CG_ITERS, lm_damping_iter, plan_route)

    # the kernels at the rows evaluation's shapes: the chain at width K on
    # the slot ids, entry_reduce over the merged table
    plan = rows_plan(bs, W)

    def evaluate(steps, fas):
        r, g, Hd, rows = _rows_eval(steps, fas, plan, R, p, W)
        return r, [g, Hd], rows

    _eval_kernels(torch, kern, results, "cg_mf-kernels", bs, plan.slots,
                  [fa.n.shape[1] for fa in bs], plan.table, R, p, W, evaluate)

    def run():
        return lm_damping_iter(bs, R, p, max_iters=LM_ITERS,
                               reduced_solver="cg_mf")

    run()               # captures the rows solve's graph
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.time()
    mf = run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = paths["cg_mf"] = launch_counts()
    t0 = time.time()
    mf64 = lm_damping_iter(bs64, torch.as_tensor(Rp), torch.as_tensor(pp),
                           max_iters=LM_ITERS, reduced_solver="cg_mf")
    cpu_s = time.time() - t0
    e_res = abs(float(mf.residual) - float(mf64.residual)) / float(
        mf64.residual)
    dp = float((mf.p - lm_dense.p).abs().max())
    route = plan_route(bs, W, "cg_mf")
    state = route.cgh(R, p)
    u0 = torch.full((), 0.01, dtype=R.dtype, device=R.device)
    solve_ms, ahead = _timed(torch, lambda: route.solve(state, u0), reps=3)
    print(f"[cg_mf] lm_damping_iter(reduced_solver='cg_mf') on path 2b's "
          f"map (W={W}), route {mf.route}: residual "
          f"{float(mf.residual):.9g} in {mf.iters} iterations, "
          f"{wall * 1e3:.1f} ms ({wall / max(mf.iters, 1) * 1e3:.2f} "
          f"ms/iter incl. the set-up); float64 CPU rows LM "
          f"{float(mf64.residual):.9g} in {mf64.iters} iterations "
          f"({cpu_s:.1f} s): rel diff {e_res:.3e} (tol {TOL_RESID_LM_REL}); "
          f"poses' largest distance from the dense route's LM {dp:.3e}; the "
          f"rows solve ({ROWS_CG_ITERS} trips, one graph replay) {solve_ms:.3f} "
          f"ms device time (queued ahead {ahead}); launches {counts}",
          flush=True)
    if not (mf.route == "rows" and e_res <= TOL_RESID_LM_REL
            and bool(torch.isfinite(mf.p).all())):
        _fail(f"cg_mf: route {mf.route}, residual {float(mf.residual)} vs "
              f"float64 {float(mf64.residual)}")
    if not all(counts[k] > 0 for k in BANDED_PATH_KERNELS):
        _fail(f"cg_mf: a kernel of the rows path was never launched: "
              f"{counts}")
    results["cg_mf"] = dict(
        residual=float(mf.residual), residual_float64_cpu=float(mf64.residual),
        rel_diff=e_res, iters=mf.iters, iters_float64_cpu=mf64.iters,
        wall_ms=wall * 1e3, ms_per_iter=wall / max(mf.iters, 1) * 1e3,
        cpu_s=cpu_s, max_pose_diff_vs_dense=dp, solve_ms=solve_ms,
        launches=counts)

def _frontend_views(np):
    """Path 3's input: FRONTEND_VIEWS renders of make_plane_scene's box room
    (walls at ±4 m) through the reference camera at its configured scale,
    from a yaw sweep of 7.5° steps around the room's centre (camera centres
    on a 0.6 m circle): neighbouring views overlap, views more than about
    60° apart see other walls.  Returns (cam, Rcw, tcw, images, depths)."""
    from global_lvba_tpu_torch.config import LvbaConfig
    from global_lvba_tpu_torch.geometry.camera import CameraModel
    from global_lvba_tpu_torch.models.synthetic import (
        make_plane_scene, render_textured_views)

    cm = LvbaConfig().cam_model
    cam = CameraModel(fx=cm.cam_fx, fy=cm.cam_fy, cx=cm.cam_cx, cy=cm.cam_cy,
                      k1=cm.cam_d0, k2=cm.cam_d1, p1=cm.cam_d2, p2=cm.cam_d3,
                      width=cm.cam_width, height=cm.cam_height).scaled(cm.scale)
    scene = make_plane_scene(num_frames=2, points_per_frame=60, seed=0)
    R0 = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    Rcw, tcw = [], []
    for k in range(FRONTEND_VIEWS):
        a = 2 * np.pi * k / FRONTEND_VIEWS
        c, s = np.cos(a), np.sin(a)
        Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        C = np.array([0.6 * c, 0.6 * s, 0.15 * np.sin(3 * a)])
        Rcw.append(R0 @ Rz.T)
        tcw.append(-(R0 @ Rz.T) @ C)
    Rcw, tcw = np.stack(Rcw), np.stack(tcw)
    imgs, depths = render_textured_views(scene, cam, Rcw, tcw,
                                         base_scale=FRONTEND_TEXTURE,
                                         return_depth=True)
    return cam, Rcw, tcw, imgs, depths


def _transfer(torch, cam, depth_i, xy_i, Rcw, tcw, i, j):
    """Keypoints xy_i (n, 2) of view i (SIFT coordinates: pixel k centred
    at k) moved into view j through view i's rendered depth (bilinear) and
    the camera model; float64 on the CPU.  Returns (uv in view j in SIFT
    coordinates, ok)."""
    from global_lvba_tpu_torch.geometry.camera import (
        back_project_pixel_depth, cam_to_world, fetch_depth_bilinear,
        project_world_to_pixel)

    d = torch.float64
    xy = torch.as_tensor(xy_i, dtype=d)
    z, okz = fetch_depth_bilinear(torch.as_tensor(depth_i, dtype=d), xy)
    # the render's camera puts pixel k's centre at k + 0.5
    Xc, okb = back_project_pixel_depth(cam, xy + 0.5, z)
    R = torch.as_tensor(Rcw, dtype=d)
    t = torch.as_tensor(tcw, dtype=d)
    Xw = cam_to_world(Xc, R[i], t[i])
    uv, zj, okp = project_world_to_pixel(cam, R[j], t[j], Xw)
    return uv - 0.5, okz & okb & okp & (z > 0.1) & (zj > 0.1)


def _frontend(torch, np, dev, kern, results, paths):
    """Path 3, the SIFT frontend (phase 10 of the module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    from global_lvba_tpu_torch.frontend.matching import accept_matches
    from global_lvba_tpu_torch.frontend.sift import (
        SiftParams, extract_sift, extract_sift_batch)
    from global_lvba_tpu_torch.kernels import launch_counts, reset_launch_counts
    from global_lvba_tpu_torch.kernels.matcher import (
        COL_TILE, ROW_TILE, top2_similarity, top2_similarity_plain)
    from global_lvba_tpu_torch.pipeline.sift_frontend import (
        extract_images, match_and_compact)
    from global_lvba_tpu_torch.tracks.build import build_components

    params = SiftParams()
    t0 = time.time()
    cam, Rcw, tcw, imgs, depths = _frontend_views(np)
    N = len(imgs)
    print(f"[frontend] {N} renders of {cam.width} x {cam.height} (fx "
          f"{cam.fx:.2f}) in {time.time() - t0:.1f} s; {params}", flush=True)
    info = dict(views=N, width=cam.width, height=cam.height, fx=cam.fx,
                params=params._asdict(), render_s=time.time() - t0)

    # ---- the main path: extraction in batches, all pairs, tracks ----
    # (one batch first: the blur operands are built and cached per shape)
    extract_images(list(imgs[:FRONTEND_BATCH]), params, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.time()
    kps, descs, valids = extract_images(list(imgs), params,
                                        batch=FRONTEND_BATCH, device=dev)
    torch.cuda.synchronize()
    t1 = time.time()
    kps_c, matches = match_and_compact(kps, descs, valids, device=dev)
    torch.cuda.synchronize()
    t2 = time.time()
    counts = paths["frontend"] = launch_counts()
    tracks = build_components(kps_c, matches)
    t3 = time.time()
    n_pairs = N * (N - 1) // 2
    n_kp = [k.shape[0] for k in kps_c]
    print(f"[frontend] extract_images {N} views: {t1 - t0:.2f} s wall; "
          f"match_and_compact {n_pairs} pairs: {(t2 - t1) * 1e3:.1f} ms wall "
          f"({(t2 - t1) * 1e3 / n_pairs:.3f} ms/pair); build_components "
          f"{t3 - t2:.2f} s: {tracks.stats}; launches {counts}", flush=True)
    if counts.get("top2_similarity", 0) <= 0:
        _fail(f"top2_similarity was never launched on the frontend path: "
              f"{counts}")
    info.update(extract_wall_s=t1 - t0, match_wall_ms=(t2 - t1) * 1e3,
                match_ms_per_pair=(t2 - t1) * 1e3 / n_pairs,
                tracks_s=t3 - t2, tracks=tracks.stats, launches=counts,
                mean_valid_kp=float(np.mean(n_kp)))

    # device time: extraction of one batch, the matcher under the profiler
    stack = torch.as_tensor(np.stack(imgs[:FRONTEND_BATCH])).to(dev)
    ext_ms, ahead_x = _timed(
        torch, lambda: extract_sift_batch(stack, params, dev), reps=3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        tp = time.perf_counter()
        extract_sift_batch(stack, params, dev)
        torch.cuda.synchronize()
        ext_wall = (time.perf_counter() - tp) * 1e3
    ext_busy = sum(v[0] for v in _device_ms(prof).values())
    # the device's busy share while matching all pairs, and the kernel's
    # own time per launch among the launches the profiler saw (in a long
    # process it misses records: 70 of 71 seen in this script's runs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        tp = time.perf_counter()
        match_and_compact(kps, descs, valids, device=dev)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - tp) * 1e3
    prof_m = _device_ms(prof)
    hits = [v for k, v in prof_m.items()
            if KERNEL_SYMBOLS["top2_similarity"] in k]
    top2_all = hits[0] if hits else (float("nan"), 0)
    busy = sum(v[0] for v in prof_m.values())
    print(f"[frontend] extraction: device ms per image "
          f"{ext_busy / FRONTEND_BATCH:.3f} (one batch of {FRONTEND_BATCH} "
          f"under torch.profiler: {ext_busy:.3f} ms device busy in "
          f"{ext_wall:.1f} ms wall); {ext_ms / FRONTEND_BATCH:.3f} ms per "
          f"image in calls queued back to back (queued ahead of the card: "
          f"{ahead_x}; if not, host-paced); all pairs under "
          f"torch.profiler: {prof_wall:.1f} ms wall, top2_unit_kernel "
          f"{top2_all[0]:.3f} ms device time in the {top2_all[1]} of "
          f"{counts['top2_similarity']} launches it saw "
          f"({top2_all[0] / max(top2_all[1], 1):.4f} ms each), device busy "
          f"{busy:.1f} ms, idle share {1 - busy / prof_wall:.3f}", flush=True)
    info.update(extract_device_ms_per_image=ext_busy / FRONTEND_BATCH,
                extract_queued_ms_per_image=ext_ms / FRONTEND_BATCH,
                extract_profiled_wall_ms=ext_wall,
                extract_queued_ahead=ahead_x, match_profiled_wall_ms=prof_wall,
                top2_kernel_profiled_ms=top2_all[0],
                top2_kernel_profiled_launches=top2_all[1],
                match_device_busy_ms=busy,
                match_idle_share=1 - busy / prof_wall)

    # ---- the kernel against its plain version, one chunk of pairs ----
    d_all = torch.stack(list(descs)).contiguous()
    v_all = torch.stack(list(valids)).contiguous()
    pairs = [(i, j) for i in range(N) for j in range(i + 1, N)]
    pidx = torch.as_tensor(np.asarray(pairs, np.int32).T.copy()).to(dev)
    ia, ib = pidx[0, :FRONTEND_CHUNK], pidx[1, :FRONTEND_CHUNK]
    out_k = top2_similarity(d_all, d_all, v_all, v_all, ia, ib)
    out_p = top2_similarity_plain(d_all, d_all, v_all, v_all, ia, ib)
    A, B = d_all[ia.long()], d_all[ib.long()]
    err_v, row_diff, col_diff, row_bad, col_bad = _top2_compare(
        torch, out_k, out_p, d_all, v_all, ia, ib)
    print(f"[top2_similarity] one chunk of {FRONTEND_CHUNK} pairs: values "
          f"max abs err {err_v:.3e} vs top2_similarity_plain (tol {TOL_TOP2}: "
          f"fp32 sums of 128 products in another order); row argmax differs "
          f"at {row_diff}, column argmax at {col_diff} slots, of which "
          f"{row_bad} / {col_bad} with a top-2 gap > {TOL_TOP2}", flush=True)
    if not (err_v <= TOL_TOP2 and row_bad == 0 and col_bad == 0):
        _fail("top2_similarity disagrees with top2_similarity_plain")
    # determinism: a second call, and each of three pairs alone, bitwise
    # equal to the chunk's outputs
    again = top2_similarity(d_all, d_all, v_all, v_all, ia, ib)
    repeat = all(torch.equal(a, b) for a, b in zip(out_k, again))
    alone = True
    for q in (0, 7, FRONTEND_CHUNK - 1):
        one = top2_similarity(d_all, d_all, v_all, v_all, ia[q:q + 1].clone(),
                              ib[q:q + 1].clone())
        alone &= all(torch.equal(a[q:q + 1], b) for a, b in zip(out_k, one))
    print(f"[top2_similarity] two calls bitwise equal: {repeat}; pairs 0, 7 "
          f"and {FRONTEND_CHUNK - 1} alone bitwise equal to their outputs in "
          f"the chunk: {alone}", flush=True)
    if not (repeat and alone):
        _fail("top2_similarity is not repeatable or depends on its chunk")
    del again, one

    # planted cases: exact ties and a ragged tail, bit for bit
    rng = np.random.default_rng(0)

    def unit(n):
        x = rng.normal(size=(n, 128)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    # masks the block skip must honour: valid slots leading (1,300 of
    # 2,000: the last 4 column tiles and row tiles skipped), valid slots
    # scattered, no valid slot; then a pair index outside the stack
    d3 = torch.as_tensor(np.stack([unit(2000) for _ in range(3)])).to(dev)
    v3 = np.zeros((3, 2000), bool)
    v3[0, :1300] = True
    v3[1] = rng.uniform(size=2000) > 0.5
    v3 = torch.as_tensor(v3).to(dev)
    ia3 = torch.tensor([0, 0, 1, 2, 1, 0], dtype=torch.int32, device=dev)
    ib3 = torch.tensor([1, 2, 0, 1, 1, 0], dtype=torch.int32, device=dev)
    mk = top2_similarity(d3, d3, v3, v3, ia3, ib3)
    mp = top2_similarity_plain(d3, d3, v3, v3, ia3, ib3)
    m_err, m_rd, m_cd, m_rb, m_cb = _top2_compare(torch, mk, mp, d3, v3,
                                                  ia3, ib3)
    m_inv = bool(((mk[0] == -2.0) == (mp[0] == -2.0)).all())
    bad = top2_similarity(d3, d3, v3, v3, ia3[:2].clone(),
                          torch.tensor([1, 3], dtype=torch.int32, device=dev))
    ranged = (bool(torch.equal(bad[1][0], mk[1][0])
                   and torch.equal(bad[2][0], mk[2][0]))
              and bool((bad[1][1] == -1).all() and (bad[2][1] == -1).all()
                       and torch.isnan(bad[0][1]).all()))
    print(f"[top2_similarity] planted masks (leading 1,300 of 2,000, "
          f"scattered, none; 6 pairs): values max abs err {m_err:.3e}, "
          f"argmax differs at {m_rd} rows / {m_cd} columns ({m_rb} / {m_cb} "
          f"with a top-2 gap > {TOL_TOP2}), -2 entries in the same places: "
          f"{m_inv}; a pair index outside the stack gives -1 and NaN, the "
          f"other pair unchanged: {ranged}", flush=True)
    if not (m_err <= TOL_TOP2 and m_rb == 0 and m_cb == 0 and m_inv
            and ranged):
        _fail("top2_similarity mishandles masks or an out-of-range pair")
    del d3, v3, mk, mp, bad

    d1, d2 = unit(300), unit(2000)          # 2000 = 15 tiles of 128 + 80
    d2[[40, 1000, 1999]] = d1[5]            # three identical best columns
    d1[[9, 260]] = d2[11]                   # two identical best rows
    d2[1990], d2[1950] = d1[3], d1[77]      # best matches in the tail tile
    g1, g2 = (torch.as_tensor(x).to(dev) for x in (d1, d2))
    pk = top2_similarity(g1, g2)
    pp = top2_similarity_plain(g1, g2)
    planted = (int(pk[1][5]) == 40 and bool(pk[0][5, 0] == pk[0][5, 1])
               and int(pk[2][11]) == 9 and int(pk[1][3]) == 1990
               and int(pk[1][77]) == 1950 and int(pk[2][1990]) == 3
               and torch.equal(pk[1], pp[1]) and torch.equal(pk[2], pp[2]))
    print(f"[top2_similarity] planted ties (lowest index, second == best) "
          f"and tail-tile winners (K1 = 300, K2 = 2000) equal to the plain "
          f"version: {planted}", flush=True)
    if not planted:
        _fail("top2_similarity breaks a tie or misses the ragged tail")

    # the 4-byte load path (D % 4 != 0, or a stack not 16-byte aligned):
    # D = 130 and D = 7 under the chunk's rules; D = 128 from a stack one
    # float off alignment bitwise equal to the same values aligned
    odd = {}
    for Dx in (130, 7):
        x = rng.normal(size=(3, 700, Dx)).astype(np.float32)
        dx = torch.as_tensor(x / np.linalg.norm(x, axis=2, keepdims=True))
        dx = dx.to(dev)
        vx = torch.as_tensor(rng.uniform(size=(3, 700)) > 0.3).to(dev)
        iax = torch.tensor([0, 1, 2], dtype=torch.int32, device=dev)
        ibx = torch.tensor([1, 2, 0], dtype=torch.int32, device=dev)
        odd[Dx] = _top2_compare(
            torch, top2_similarity(dx, dx, vx, vx, iax, ibx),
            top2_similarity_plain(dx, dx, vx, vx, iax, ibx), dx, vx, iax, ibx)
    buf = torch.empty(d_all.numel() + 1, dtype=torch.float32, device=dev)
    d_off = buf[1:].view(d_all.shape)
    d_off.copy_(d_all)
    off_k = top2_similarity(d_off, d_off, v_all, v_all, ia, ib)
    aligned_off = d_off.data_ptr() % 16 != 0
    off_same = all(torch.equal(a, b) for a, b in zip(off_k, out_k))
    print(f"[top2_similarity] 4-byte load path: D = 130 (3 pairs of 700): "
          f"values max abs err {odd[130][0]:.3e}, argmax differs at "
          f"{odd[130][1]} rows / {odd[130][2]} columns ({odd[130][3]} / "
          f"{odd[130][4]} with a top-2 gap > {TOL_TOP2}); D = 7: "
          f"{odd[7][0]:.3e}, {odd[7][1]} / {odd[7][2]} ({odd[7][3]} / "
          f"{odd[7][4]}); the chunk from a stack off 16-byte alignment "
          f"({aligned_off}) bitwise equal to the aligned one: {off_same}",
          flush=True)
    if not (all(o[0] <= TOL_TOP2 and o[3] == 0 and o[4] == 0
                for o in odd.values()) and aligned_off and off_same):
        _fail("top2_similarity's 4-byte load path disagrees")
    del buf, d_off, off_k

    chunk_lib = lambda: torch.bmm(A, B.transpose(1, 2))
    # the bound counts the products this chunk's masks need: valid rows x
    # valid columns per pair, each once; bytes: the valid descriptors in,
    # every slot's results out (12 B a row, 4 B a column)
    P, K, D = int(ia.shape[0]), d_all.shape[1], d_all.shape[2]
    vh = v_all.cpu()
    nv = vh.sum(1).double()
    last = torch.where(vh.any(1), K - torch.flip(vh, [1]).int().argmax(1),
                       torch.zeros(vh.shape[0], dtype=torch.long))
    # the kernel's units compute the row and column tiles up to the last
    # valid slot of each set (csrc/matcher.cu, kernels/matcher.unit_plan)
    def walk(tile):
        return (-(-last // tile) * tile).clamp(max=K).double()

    a_h, b_h = ia.long().cpu(), ib.long().cpu()
    useful = float((nv[a_h] * nv[b_h]).sum())
    walked = float((walk(ROW_TILE)[a_h] * walk(COL_TILE)[b_h]).sum())
    flops = 2 * D * useful
    nbytes = 4 * D * float(nv[a_h].sum() + nv[b_h].sum()) + P * K * 16
    bound = _bound(nbytes, 3 * flops, TF32_FLOP_PER_S)
    bound_fp32 = _bound(nbytes, flops)
    print(f"[top2_similarity] bound of the chunk: {useful:.0f} valid "
          f"products of {P * K * K} slot pairs (share {useful / (P * K * K):.4f}"
          f"); the kernel's tiles cover {walked:.0f} (share "
          f"{walked / (P * K * K):.4f}); bound {bound[0]:.4f} ms ({bound[1]}, "
          f"3xTF32 at {TF32_FLOP_PER_S / 1e12:.0f} TFLOP/s), the fp32 bound "
          f"{bound_fp32[0]:.4f} ms ({bound_fp32[1]})", flush=True)
    info.update(top2_useful_products=useful, top2_walked_products=walked,
                top2_slot_products=P * K * K, top2_bound_fp32=bound_fp32)
    kern["top2_similarity"] = dict(
        max_abs_err=err_v,
        **_times_in_turns(
            torch, "top2_similarity",
            lambda: top2_similarity(d_all, d_all, v_all, v_all, ia, ib),
            lambda: top2_similarity_plain(d_all, d_all, v_all, v_all, ia, ib),
            chunk_lib),
        bound=bound,
        kernel_device_ms=top2_all[0] / max(top2_all[1], 1),   # per chunk
    )

    del A, B, out_k, out_p

    # ---- match sets through the kernel and through the plain version ----
    total = diff = unexplained = 0
    cmax, rmax = np.cos(FRONTEND_DISTMAX), FRONTEND_RATIOMAX
    for s in range(0, len(pairs), FRONTEND_CHUNK):
        a_, b_ = pidx[0, s:s + FRONTEND_CHUNK], pidx[1, s:s + FRONTEND_CHUNK]
        va = v_all[a_.long()]
        jk, okk = accept_matches(*top2_similarity(
            d_all, d_all, v_all, v_all, a_, b_), va)
        jp, okp = accept_matches(*top2_similarity_plain(
            d_all, d_all, v_all, v_all, a_, b_), va)
        total += int(okk.sum())
        dm = (okk != okp) | (okk & okp & (jk != jp))
        nd = int(dm.sum())
        if nd == 0:
            continue
        diff += nd
        # explain each difference in float64: a top-2 tie of the row or of
        # either candidate column, or a best dot at the angle or ratio
        # threshold
        pi_all, ri_all = torch.nonzero(dm, as_tuple=True)
        for lo in range(0, nd, 256):
            pi_, ri = pi_all[lo:lo + 256], ri_all[lo:lo + 256]
            ai, bi = a_.long()[pi_], b_.long()[pi_]
            bset = d_all[bi].double()                           # (n, K, D)
            srow = torch.einsum("nd,nkd->nk", d_all[ai, ri].double(), bset)
            srow = torch.where(v_all[bi], srow, torch.full_like(srow, -2.0))
            t2 = torch.topk(srow, 2, dim=1).values
            best, second = t2[:, 0], t2[:, 1]
            near = ((best - second) <= TOL_TOP2) \
                | ((best - cmax).abs() <= TOL_TOP2) \
                | ((best - torch.cos(rmax * torch.arccos(
                    second.clamp(-1, 1)))).abs() <= TOL_TOP2)
            aset = d_all[ai].double()
            for jc in (jk[pi_, ri], jp[pi_, ri]):
                col = bset[torch.arange(len(jc), device=dev), jc]
                scol = torch.einsum("nd,nkd->nk", col, aset)
                scol = torch.where(v_all[ai], scol,
                                   torch.full_like(scol, -2.0))
                c2 = torch.topk(scol, 2, dim=1).values
                near |= (c2[:, 0] - c2[:, 1]) <= TOL_TOP2
            unexplained += int((~near).sum())
    share = diff / max(total, 1)
    print(f"[frontend] match sets over all {len(pairs)} pairs, kernel vs "
          f"plain on the card: {total} matches, {diff} differ (share "
          f"{share:.2e}, limit {MATCH_DIFF_SHARE}), {unexplained} of them "
          f"not within {TOL_TOP2} of a threshold or a top-2 tie", flush=True)
    info.update(matches=total, match_set_diffs=diff,
                match_set_unexplained=unexplained)
    if share > MATCH_DIFF_SHARE or unexplained:
        _fail("the kernel's match sets differ from the plain matcher's")

    # ---- matches on overlapping and on disjoint pairs; tracks ----
    gy, gx = np.meshgrid(np.linspace(8, cam.height - 9, 16),
                         np.linspace(8, cam.width - 9, 20), indexing="ij")
    grid = np.stack([gx.ravel(), gy.ravel()], axis=1)
    overlap = np.zeros((N, N))
    for i in range(N):
        for j in range(N):
            if i != j:
                uv, ok = _transfer(torch, cam, depths[i], grid, Rcw, tcw, i, j)
                inb = ok & (uv[:, 0] >= 0) & (uv[:, 1] >= 0) \
                    & (uv[:, 0] <= cam.width - 1) & (uv[:, 1] <= cam.height - 1)
                overlap[i, j] = float(inb.double().mean())
    m_over = [len(matches.get(p, ())) for p in pairs if overlap[p] >= 0.2]
    m_none = [len(matches.get(p, ())) for p in pairs if overlap[p] == 0]
    print(f"[frontend] mean valid keypoints {np.mean(n_kp):.1f} (min "
          f"{min(n_kp)}); mean matches {np.mean(m_over):.1f} on "
          f"{len(m_over)} overlapping pairs (view overlap >= 0.2), "
          f"{np.mean(m_none):.2f} on {len(m_none)} disjoint pairs (no "
          f"overlap); {tracks.stats['kept_components']} tracks", flush=True)
    info.update(mean_matches_overlapping=float(np.mean(m_over)),
                overlapping_pairs=len(m_over),
                mean_matches_disjoint=float(np.mean(m_none)),
                disjoint_pairs=len(m_none),
                track_count=tracks.stats["kept_components"])

    # ---- geometry: consecutive pairs through the render's depth ----
    errs = []
    for i in range(N - 1):
        m = matches.get((i, i + 1))
        if m is None:
            continue
        uv, ok = _transfer(torch, cam, depths[i], kps_c[i][m[:, 0]], Rcw, tcw,
                           i, i + 1)
        e = (uv - torch.as_tensor(kps_c[i + 1][m[:, 1]],
                                  dtype=torch.float64)).norm(dim=1)
        errs.append(e[ok].numpy())
    errs = np.concatenate(errs)
    med, inl = float(np.median(errs)), float(np.mean(errs < 3.0))
    print(f"[frontend] geometry over the {N - 1} consecutive pairs: "
          f"{errs.size} matches, transfer error median {med:.3f} px (limit 2), "
          f"inlier share (< 3 px) {inl:.4f} (limit 0.8)", flush=True)
    info.update(transfer_median_px=med, transfer_inlier_share=inl)
    if not (med < 2.0 and inl > 0.8):
        _fail("the frontend's matches do not follow the scene's geometry")

    # ---- extraction on the card against the CPU, and determinism ----
    two = np.stack(imgs[:2])
    cmp = {}
    for dt in (torch.float32, torch.float64):
        t0 = time.time()
        f = extract_sift_batch(torch.as_tensor(two, dtype=dt), params,
                               device="cpu")
        secs = time.time() - t0
        n_card = n_cpu = hit_card = hit_cpu = 0
        dd = []
        for b in range(2):
            vb = valids[b].cpu()
            card = torch.as_tensor(kps[b])[vb].double()
            ref = f.xy[b][f.valid[b]].double()
            near = torch.cdist(card, ref) <= TOL_POS_PX
            n_card += card.shape[0]
            n_cpu += ref.shape[0]
            hit_card += int(near.any(1).sum())
            hit_cpu += int(near.any(0).sum())
            # descriptors of the pairs by position; of a keypoint's two
            # orientations at one position, the nearer descriptor
            i, j = torch.nonzero(near, as_tuple=True)
            dk = descs[b].cpu()[vb].double()[i]
            dr = f.desc[b][f.valid[b]].double()[j]
            e = (dk - dr).abs().amax(1)
            best = torch.full((card.shape[0],), float("inf"), dtype=e.dtype)
            best = best.scatter_reduce(0, i, e, reduce="amin")
            dd.append(best[near.any(1)])
        dd = torch.cat(dd)
        cmp[str(dt)] = dict(
            card_kp=n_card, cpu_kp=n_cpu, card_share=hit_card / n_card,
            cpu_share=hit_cpu / n_cpu,
            desc_share=float((dd <= TOL_DESC).double().mean()),
            desc_max=float(dd.max()), desc_p99=float(dd.quantile(0.99)),
            desc_median=float(dd.median()), cpu_s=secs)
    c32 = cmp[str(torch.float32)]
    f1 = extract_sift(imgs[0], params, dev)
    f2 = extract_sift(imgs[0], params, dev)
    same = all(torch.equal(a, b) for a, b in zip(f1, f2))
    for k, c in cmp.items():
        print(f"[frontend] extraction card vs CPU {k} on 2 views: valid "
              f"keypoints {c['card_kp']} / {c['cpu_kp']}; within "
              f"{TOL_POS_PX} px of one on the other side: card's "
              f"{c['card_share']:.4f}, CPU's {c['cpu_share']:.4f}; their "
              f"descriptors' max abs difference: median "
              f"{c['desc_median']:.3e}, 99th percentile {c['desc_p99']:.3e}, "
              f"max {c['desc_max']:.3e}, share <= {TOL_DESC} "
              f"{c['desc_share']:.4f}; CPU {c['cpu_s']:.1f} s", flush=True)
    print(f"[frontend] limits on float32: each share >= {EXTRACT_SHARE}; a "
          f"second extraction of view 0 bitwise equal: {same}", flush=True)
    info.update(card_vs_cpu=cmp, extraction_repeatable=same)
    if not (min(c32["card_share"], c32["cpu_share"], c32["desc_share"])
            >= EXTRACT_SHARE and same):
        _fail("extraction on the card disagrees with the CPU or is not "
              "repeatable")
    results["frontend"] = info


def _visual_problem(kind, num_cams=None):
    """(VisualBAProblem, VisualBenchProblem) of a JAX bench problem."""
    from global_lvba_tpu_torch.models.synthetic import (
        make_visual_bench_problem)
    from global_lvba_tpu_torch.solver.schur import VisualBAProblem

    bp = make_visual_bench_problem(kind, num_cams)
    return VisualBAProblem(
        cam=bp.cam, obs_cam=bp.obs_cam, obs_pt=bp.obs_pt, obs_uv=bp.obs_uv,
        plane_n=bp.plane_n, plane_d=bp.plane_d, num_cams=bp.R0.shape[0],
        num_pts=bp.X0.shape[0]), bp


def _rel_cost(a, b):
    return abs(a - b) / abs(b)


def _visual_loop(torch, tag, plan, iters, dev):
    """The visual LM over a plan on the card (its CG graph captured by a
    warm-up run): ms per iteration (the initial evaluation included), peak
    memory, two runs bitwise equal, the loop's synchronizing calls (one
    read an iteration), one reduced solve step (damped assembly, the
    point-major CG, back-substitution) under sync debug mode "error", the
    CG's and the step's device ms, the idle share under torch.profiler."""
    from global_lvba_tpu_torch.solver import dist_solve, schur

    schur.run_visual(plan, iters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = schur.run_visual(plan, iters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    res2, syncs = _count_syncs(torch, lambda: schur.run_visual(plan, iters))
    same = (all(torch.equal(a, b) for a, b in zip(res[:3], res2[:3]))
            and (res.iters, res.cost0, res.cost)
            == (res2.iters, res2.cost0, res2.cost))
    cache = plan.lin(plan.R0, plan.t0, plan.X0)
    u = torch.full((), 1e-3, dtype=plan.R0.dtype, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        plan.solve(cache, u)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    step_ms = _timed(torch, lambda: plan.solve(cache, u))[0]
    lin_ms = _timed(torch, lambda: plan.lin(plan.R0, plan.t0, plan.X0))[0]
    cg_ms = None
    if plan.route == "tier":
        T = plan.consts.tiers
        dHcc, Hpi = schur._damped_blocks(u, cache.Hcc, cache.Hpp)
        Y = cache.Wb @ Hpi[T.pt]
        b = schur._zero_first(-cache.g_c, True)
        cg_ms = _timed(torch, lambda: dist_solve.solve_schur_cg_pm_tiers(
            dHcc, cache.Wb, Y, T, b))[0]
    prof_wall, busy, idle, idle_w, dev_ms = _idle(
        torch, lambda: schur.run_visual(plan, iters), wall * 1e3)
    ms_iter = wall / max(res.iters, 1) * 1e3
    print(f"[{tag}] route {res.route}: cost {res.cost0:.9g} -> "
          f"{res.cost:.9g} in {res.iters} iterations, {wall * 1e3:.1f} ms "
          f"({ms_iter:.2f} ms/iter incl. the initial evaluation); peak device "
          f"memory {peak / 1e9:.3f} GB; two runs bitwise equal: {same}; "
          f"synchronizing calls in the loop {syncs} (one read an "
          f"iteration); one evaluation {lin_ms:.3f} ms, one reduced solve "
          f"step {step_ms:.3f} ms device time (its point-major CG "
          f"{cg_ms} ms); under torch.profiler {prof_wall:.1f} ms wall, "
          f"{busy:.1f} ms device busy, idle share {idle:.3f} (that device "
          f"time over the unprofiled wall: {idle_w:.3f}); device ms by op "
          f"{_top_ops(dev_ms, 6)}", flush=True)
    if not (same and syncs == res2.iters):
        _fail(f"{tag}: two runs differ, or the loop synchronized {syncs} "
              f"times in {res2.iters} iterations (at {SYNC_SITES})")
    return res, dict(
        route=res.route, iters=res.iters, cost0=res.cost0, cost=res.cost,
        wall_ms=wall * 1e3, ms_per_iter=ms_iter, peak_bytes=peak,
        bitwise_repeatable=same, loop_syncs=syncs, eval_ms=lin_ms,
        step_ms=step_ms, cg_ms=cg_ms, profiled_wall_ms=prof_wall,
        device_busy_ms=busy, idle_share=idle,
        idle_share_cross_run_estimate=idle_w,
        device_ms_by_op=_top_ops(dev_ms, 12))


def _visual_bench(torch, np, dev, results):
    """Phase 14, [visual-m1000] and [visual-m200]: the JAX bench's solver
    problems through solve_visual_ba's plan and loop on the card in
    float32 (the tier route), against the float64 CPU run; M=200 also in
    float64 on the card."""
    from global_lvba_tpu_torch.solver import schur

    out = results["visual_bench"] = {}
    for kind, iters in VISUAL_BENCH:
        tag = f"visual-{kind}"
        prob, bp = _visual_problem(kind)
        args = (prob, bp.R0, bp.t0, bp.X0)
        t0 = time.perf_counter()
        plan, setup_syncs = _count_syncs(torch, lambda: schur.plan_visual(
            *args, dtype=torch.float32, device=dev))
        setup_ms = (time.perf_counter() - t0) * 1e3
        print(f"[{tag}] M={prob.num_cams}, P={prob.num_pts}, "
              f"O={prob.obs_cam.shape[0]}: route {plan.route}, set-up "
              f"{setup_ms:.1f} ms with {setup_syncs} synchronizing calls",
              flush=True)
        if plan.route != "tier":
            _fail(f"{tag}: route {plan.route}, not tier")
        res, rec = _visual_loop(torch, tag, plan, iters, dev)
        t0 = time.time()
        ref = schur.solve_visual_ba(*args, max_iters=iters,
                                    dtype=torch.float64, device="cpu")
        cpu_s = time.time() - t0
        e0, e1 = _rel_cost(res.cost0, ref.cost0), _rel_cost(res.cost,
                                                            ref.cost)
        rec.update(setup_ms=setup_ms, setup_syncs=setup_syncs,
                   cost0_float64_cpu=ref.cost0, cost_float64_cpu=ref.cost,
                   iters_float64_cpu=ref.iters, cost0_rel=e0, cost_rel=e1,
                   cpu_s=cpu_s)
        print(f"[{tag}] float64 CPU: cost {ref.cost0:.12g} -> "
              f"{ref.cost:.12g} in {ref.iters} iterations ({cpu_s:.1f} s); "
              f"card float32 cost0 rel diff {e0:.3e} (tol "
              f"{TOL_VISUAL_COST0}), final {e1:.3e} (tol {TOL_VISUAL_COST})",
              flush=True)
        if not (res.cost < res.cost0 and e0 <= TOL_VISUAL_COST0
                and e1 <= TOL_VISUAL_COST):
            _fail(f"{tag}: cost {res.cost0} -> {res.cost}, float64 CPU "
                  f"{ref.cost0} -> {ref.cost}")
        if kind == "m200":
            plan64 = schur.plan_visual(*args, dtype=torch.float64,
                                       device=dev)
            res64 = schur.run_visual(plan64, iters)
            f0, f1 = _rel_cost(res64.cost0, ref.cost0), _rel_cost(
                res64.cost, ref.cost)
            print(f"[{tag}] float64 on the card: cost {res64.cost0:.12g} -> "
                  f"{res64.cost:.12g} in {res64.iters} iterations; rel diff "
                  f"from the CPU's {f0:.3e} / {f1:.3e} (tol {TOL_VISUAL_F64})",
                  flush=True)
            rec.update(float64_card=dict(cost0=res64.cost0, cost=res64.cost,
                                         iters=res64.iters, cost0_rel=f0,
                                         cost_rel=f1))
            if not (f0 <= TOL_VISUAL_F64 and f1 <= TOL_VISUAL_F64
                    and res64.iters == ref.iters):
                _fail(f"{tag}: float64 on the card departs from the CPU's")
        out[kind] = rec


def _visual_routes(torch, np, dev, results):
    """Phase 15, [visual-routes]: the m200 generator at M=100 through every
    single-device route in float64, card against CPU."""
    import dataclasses

    from global_lvba_tpu_torch.solver import schur

    prob, bp = _visual_problem("m200", VISUAL_ROUTE_CAMS)
    counts = np.bincount(prob.obs_pt)
    Q = int((counts.astype(np.int64) ** 2).sum())
    # (name, problem fields, schur module switches, the route it must take)
    cases = (
        ("lu", {}, {}, "lu"),
        ("cg", dict(reduced_solver="cg"), {}, "cg"),
        ("cg chunked", dict(reduced_solver="cg",
                            pair_chunk=VISUAL_ROUTE_CHUNK), {}, "cg"),
        ("cg_mf", dict(reduced_solver="cg_mf"),
         dict(VISUAL_TIER=False, PM_ONEHOT_BUDGET=0), "cg_mf"),
        ("cg_pm", dict(reduced_solver="cg_mf"), dict(VISUAL_TIER=False),
         "cg_pm"),
        ("tier", dict(reduced_solver="cg_mf"), {}, "tier"),
    )
    out = results["visual_routes"] = dict(M=prob.num_cams, Q=Q)
    for name, fields, switches, route in cases:
        p = dataclasses.replace(prob, **fields)
        saved = {k: getattr(schur, k) for k in switches}
        for k, v in switches.items():
            setattr(schur, k, v)
        try:
            args = (p, bp.R0, bp.t0, bp.X0)
            t0 = time.perf_counter()
            card = schur.solve_visual_ba(*args, max_iters=VISUAL_ROUTE_ITERS,
                                         dtype=torch.float64, device=dev)
            card_ms = (time.perf_counter() - t0) * 1e3
            cpu = schur.solve_visual_ba(*args, max_iters=VISUAL_ROUTE_ITERS,
                                        dtype=torch.float64, device="cpu")
        finally:
            for k, v in saved.items():
                setattr(schur, k, v)
        e0, e1 = _rel_cost(card.cost0, cpu.cost0), _rel_cost(card.cost,
                                                            cpu.cost)
        print(f"[visual-routes] {name} (M={p.num_cams}, Q={Q}): route "
              f"{card.route} (CPU {cpu.route}); cost {card.cost0:.12g} -> "
              f"{card.cost:.12g} in {card.iters} iterations, "
              f"{card_ms:.1f} ms on the card (set-up and capture included); "
              f"rel diff from the float64 CPU run {e0:.3e} / {e1:.3e} (tol "
              f"{TOL_VISUAL_ROUTE})", flush=True)
        out[name] = dict(route=card.route, cost0=card.cost0, cost=card.cost,
                         iters=card.iters, cost_float64_cpu=cpu.cost,
                         cost0_rel=e0, cost_rel=e1, card_ms=card_ms)
        if not (card.route == cpu.route == route and e0 <= TOL_VISUAL_ROUTE
                and e1 <= TOL_VISUAL_ROUTE and card.iters == cpu.iters
                and card.cost < card.cost0):
            _fail(f"[visual-routes] {name}: route {card.route}, cost "
                  f"{card.cost} vs the CPU's {cpu.cost}")
    if not Q > VISUAL_ROUTE_CHUNK:
        _fail("[visual-routes] the chunked pair scatter has one chunk")


def _e2e_kernels(torch, kern, results, tag, bs, R, p, W, f64=False):
    """[tag]: bucketed factors of the dense route on W frames (one of
    [visual-e2e]'s LiDAR solves) through _eval_kernels (kernels 1, 2b, 4
    and 5 against their plain versions at these shapes, the evaluation
    against the plain one), then syrk_ over each bucket's chain rows
    under _syrk_check; each max abs error raises its kernels-line
    max_abs_err.  With f64 (float64 buckets) the float64 instances under
    the TOL64_* limits (_syrk_f64_check), without the evaluation."""
    from global_lvba_tpu_torch.factors.plane_eigen import (
        PlaneFactorArrays, _cost_grad_hess_buckets, buckets_frame_table,
        pose_table)
    from global_lvba_tpu_torch.kernels.selection import table_select_buckets
    from global_lvba_tpu_torch.kernels.soa import (
        soa_agg_buckets, soa_chain_entries)

    if not all(isinstance(fa, PlaneFactorArrays) for fa in bs):
        _fail(f"{tag}: the density gate does not pick the bucketed layout")
    d = torch.float64 if f64 else torch.float32
    R = torch.as_tensor(R, dtype=d, device=bs[0].n.device)
    p = torch.as_tensor(p, dtype=d, device=bs[0].n.device)
    table = buckets_frame_table(bs, W)

    def evaluate(steps, fas):
        r, g, H = _cost_grad_hess_buckets(steps, fas, R, p, W, table=table)
        return r, [g, H], []

    _eval_kernels(torch, kern, results, tag, bs, [fa.frame for fa in bs],
                  [W] * len(bs), table, R, p, W,
                  None if f64 else evaluate, f64=f64)
    sel = table_select_buckets([fa.frame.reshape(-1) for fa in bs],
                               pose_table(R, p))
    poses = [s.view(*fa.n.shape, 12) for s, fa in zip(sel, bs)]
    aggs = soa_agg_buckets([(fa.n, fa.mu, fa.Pc, ps)
                            for fa, ps in zip(bs, poses)])
    As = [soa_chain_entries(fa.n, fa.mu, fa.Pc, ps, fa.frame, pv, W)[0]
          for fa, ps, (_, pv) in zip(bs, poses, aggs)]
    if f64:
        name = "syrk_f64"
        err = _syrk_f64_check(torch, tag, As, 6 * W,
                              timed=False)["max_abs_err"]
    else:
        name, err = "syrk", _syrk_check(torch, tag, As, 6 * W)
    kern[name]["max_abs_err"] = max(kern[name]["max_abs_err"], err)


def _path_kernels(torch, np, dev, kern, results, tag, cfg, clouds, R0, p0,
                  lid):
    """The kernels at the shapes of one run_lidar_ba's solves (lid, run on
    clouds from poses R0, p0 under cfg) through _e2e_kernels: the first
    window at R0, p0 (its tiers merged into one bucket, as the window
    stage builds them) as [tag-window-kernels], and global stage 2 at the
    run's final anchor poses as [tag-global-kernels].  Returns the s
    taken."""
    from global_lvba_tpu_torch.factors.padding import buckets_to_device
    from global_lvba_tpu_torch.pipeline.lidar_ba import _build_vm

    t0 = time.time()
    Ww = cfg.window_ba.size
    vm = _build_vm(np.concatenate(clouds[:Ww]), np.concatenate(
        [np.full(len(c), j, np.int32) for j, c in enumerate(clouds[:Ww])]),
        R0[:Ww], p0[:Ww], cfg.BALM_stage1.root_voxel_size,
        cfg.window_ba.eigen_ratio_array, cfg, dev)
    _e2e_kernels(torch, kern, results, f"{tag}-window-kernels",
                 buckets_to_device(vm, W=Ww, device=dev, merge="always"),
                 R0[:Ww], p0[:Ww], Ww)
    A = lid.anchor_R.shape[0]
    st = cfg.BALM_stage2
    vm = _build_vm(np.concatenate(lid.anchor_clouds), np.concatenate(
        [np.full(len(c), j, np.int32)
         for j, c in enumerate(lid.anchor_clouds)]),
        lid.anchor_R, lid.anchor_p, st.root_voxel_size,
        st.eigen_ratio_array, cfg, dev)
    _e2e_kernels(torch, kern, results, f"{tag}-global-kernels",
                 buckets_to_device(vm, W=A, device=dev), lid.anchor_R,
                 lid.anchor_p, A)
    del vm
    torch.cuda.synchronize()
    return time.time() - t0


def _reused_depth_maps(np, visual_ba):
    """visual_ba.render_depth_maps computed by the first call on each kind
    of device and handed back to that kind's later calls with the same
    camera poses: the card's runs share the z-buffer kernel's maps, the
    CPU's runs _zbuffer_host's (numpy), so the card-vs-CPU comparison
    keeps an independent depth source; a call with other poses fails.
    Returns the function to put back and the memo ({"cuda": ..., "cpu":
    ...}, each with its "maps")."""
    import torch

    render = visual_ba.render_depth_maps
    memo = {}

    def reused(cam, gm, lidar_times, image_times, Rcw, tcw, device):
        m = memo.setdefault(torch.device(device).type, {})
        if not m:
            m.update(Rcw=Rcw, tcw=tcw, maps=render(
                cam, gm, lidar_times, image_times, Rcw, tcw, device=device))
        elif not (np.array_equal(m["Rcw"], Rcw)
                  and np.array_equal(m["tcw"], tcw)):
            _fail("[visual-e2e]: a run's camera poses differ from the "
                  "first run's")
        return m["maps"]

    visual_ba.render_depth_maps = reused
    return render, memo


def _visual_e2e(torch, np, dev, kern, results, paths):
    """Phase 16, [visual-e2e]: ladder 3 through run_lidar_ba (launch counts
    from 0: every bucketed kernel), held against the float64 CPU run and
    its kernels against their plain versions at its shapes, then
    run_visual_ba on the card from its poses in float32, against the
    float64 CPU run at the same iterations; the visual stage in float64
    on the card and on the CPU at E2E_FLOAT64_ITERS (track fusion in
    float64 in the float64 runs).  Returns the scene and its odometry
    (js, R_odom, p_odom) for phase 17."""
    from global_lvba_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    from global_lvba_tpu_torch.models.synthetic import (
        ate_rmse, make_joint_scene, perturb_poses)
    from global_lvba_tpu_torch.pipeline import visual_ba
    from global_lvba_tpu_torch.pipeline.lidar_ba import run_lidar_ba
    from global_lvba_tpu_torch.solver import schur

    t0 = time.time()
    js = make_joint_scene(E2E_FRAMES, E2E_PPF, num_landmarks=E2E_LANDMARKS,
                          seed=13, px_noise=0.3)
    sc = js.lidar
    R_odom, p_odom = perturb_poses(sc.R_true, sc.p_true, 0.003, 0.008,
                                   seed=21)
    clouds = [sc.points_body[sc.frame_ids == i] for i in range(E2E_FRAMES)]
    gen_s = time.time() - t0
    cfg = _window_config("float32")
    reset_launch_counts()
    t0 = time.time()
    lid = run_lidar_ba(clouds, R_odom, p_odom, cfg, device=dev)
    torch.cuda.synchronize()
    lidar_s = time.time() - t0
    counts = paths["visual-e2e"] = launch_counts()
    ate0, ate = ate_rmse(p_odom, sc.p_true), ate_rmse(lid.p_opt, sc.p_true)
    print(f"[visual-e2e] scene {sc.points_body.shape[0]} points, "
          f"{len(js.image_times)} images ({gen_s:.1f} s to make); "
          f"run_lidar_ba {lidar_s:.2f} s, ATE {ate0:.5f} -> {ate:.5f} m; "
          f"launches {counts}", flush=True)
    _stage_lines("visual-e2e", lid.stats)
    if not all(counts[k] > 0 for k in BUCKETED_PATH_KERNELS):
        _fail(f"[visual-e2e]: a bucketed kernel was never launched: {counts}")
    t0 = time.time()
    lid64 = run_lidar_ba(clouds, R_odom, p_odom, _window_config("float64"),
                         device="cpu")
    ate_ref = ate_rmse(lid64.p_opt, sc.p_true)
    lidar64_s = time.time() - t0
    print(f"[visual-e2e] run_lidar_ba float64 on the CPU ({lidar64_s:.1f} "
          f"s): ATE {ate_ref:.5f} m; the card's within 10%: "
          f"{abs(ate - ate_ref) <= 0.1 * ate_ref}", flush=True)
    if not (np.isfinite(lid.p_opt).all() and ate < ate0
            and abs(ate - ate_ref) <= 0.1 * ate_ref):
        _fail(f"[visual-e2e]: ATE {ate0} -> {ate} (float64 CPU {ate_ref})")
    _path_kernels(torch, np, dev, kern, results, "visual-e2e", cfg, clouds,
                  R_odom, p_odom, lid)
    kw = dict(cam=js.cam, clouds=clouds, lidar_times=sc.times,
              R_opt=lid.R_opt, p_opt=lid.p_opt, R_orig=R_odom, p_orig=p_odom,
              image_times=js.image_times, cam_R=R_odom[js.image_frame],
              cam_p=p_odom[js.image_frame], Rci=js.Rci, tci=js.tci,
              keypoints=js.keypoints, matches=js.matches)
    cfg64 = _window_config("float64")
    cfg64_n = _window_config("float64")
    cfg64_n.solver.visual_max_iters = E2E_FLOAT64_ITERS
    fuse32 = visual_ba.fuse_tracks
    render, memo = _reused_depth_maps(np, visual_ba)
    reuse = ("card-float64", "cpu-float64-short")   # the memo's maps
    runs = {}
    try:
        for name, c, d in (("card", cfg, dev), ("cpu-float64", cfg64, "cpu"),
                           ("card-float64", cfg64_n, dev),
                           ("cpu-float64-short", cfg64_n, "cpu")):
            # the float64 runs fuse their tracks in float64 too
            visual_ba.fuse_tracks = fuse32 if c is cfg else functools.partial(
                fuse32, dtype=torch.float64)
            if name == "card":
                reset_launch_counts()
            t0 = time.time()
            v = runs[name] = visual_ba.run_visual_ba(cfg=c, device=d, **kw)
            if name == "card":
                torch.cuda.synchronize()
                zc = paths["visual-e2e-stage"] = launch_counts()
                if zc["zbuffer"] != 1:
                    _fail(f"[visual-e2e]: the card run's depth maps took "
                          f"{zc['zbuffer']} z-buffer launches, not one")
            s = v.stats
            print(f"[visual-e2e] run_visual_ba {name} ({time.time() - t0:.2f} "
                  f"s): reprojection {v.mean_reproj_pre:.4f} -> "
                  f"{v.mean_reproj_post:.4f} px (the JAX package's "
                  f"{JAX_E2E_REPROJ}); {s['tracks_fused']} tracks fused, "
                  f"{s['tracks_with_plane']} with a plane, "
                  f"{s['observations']} observations; cost "
                  f"{s['cost0']:.9g} -> {s['cost']:.9g} in "
                  f"{s['solve_iters']} iterations on route "
                  f"{s['solve_route']}; stages depth {s['depth_s']:.3f} s"
                  f"{' (maps reused)' if name in reuse else ''}"
                  f", fuse {s['fuse_s']:.3f} s, planes {s['planes_s']:.3f} s, "
                  f"solve {s['solve_s']:.3f} s (set-up included)", flush=True)
    finally:
        visual_ba.fuse_tracks = fuse32
        visual_ba.render_depth_maps = render
    v, ref = runs["card"], runs["cpu-float64"]
    v64, ref_n = runs["card-float64"], runs["cpu-float64-short"]
    maps, maps_np = memo["cuda"]["maps"], memo["cpu"]["maps"]
    map_share = max(float(np.mean(np.abs(a - b) > 1e-6))
                    for a, b in zip(maps, maps_np))
    print(f"[visual-e2e] the card runs' depth maps (the kernel) against the "
          f"CPU runs' (numpy _zbuffer_host): bitwise "
          f"{bool(np.array_equal(maps, maps_np))}, worst image's share off "
          f"by > 1e-6 {map_share:.3e} (limit {ZBUF_SHARE})", flush=True)
    # the solve alone, warm, on the card run's problem: its plane priors
    # looked up again
    lookup = visual_ba.build_anchor_plane_lookup(clouds, lid.R_opt,
                                                 lid.p_opt, cfg, device=dev)
    idx = lookup.query(v.points_pre)
    obs_cam, obs_pt, obs_uv = v.track_obs
    prob = schur.VisualBAProblem(
        cam=js.cam, obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=obs_uv,
        plane_n=lookup.normals[idx],
        plane_d=-np.einsum("pi,pi->p", lookup.normals[idx],
                           lookup.centers[idx]),
        num_cams=len(js.image_times), num_pts=v.points_pre.shape[0])
    plan = schur.plan_visual(prob, v.Rcw_pre, v.tcw_pre, v.points_pre,
                             dtype=torch.float32, device=dev)
    sol, rec = _visual_loop(torch, "visual-e2e solve", plan,
                            cfg.solver.visual_max_iters, dev)
    e_counts = {k: abs(v.stats[k] - ref.stats[k]) / ref.stats[k]
                for k in ("tracks_fused", "tracks_with_plane",
                          "observations")}
    e_post = abs(v.mean_reproj_post - ref.mean_reproj_post) \
        / ref.mean_reproj_post
    e_cost = _rel_cost(v.stats["cost"], ref.stats["cost"])
    f_cost = _rel_cost(v64.stats["cost"], ref_n.stats["cost"])
    f_post = abs(v64.mean_reproj_post - ref_n.mean_reproj_post) \
        / ref_n.mean_reproj_post
    print(f"[visual-e2e] card float32 vs CPU float64 ("
          f"{cfg.solver.visual_max_iters} iterations each): counts rel diff "
          f"{e_counts} (tol {TOL_E2E_COUNT}), post-BA reprojection "
          f"{e_post:.3e} (tol {TOL_E2E_POST}), final cost {e_cost:.3e} (tol "
          f"{TOL_VISUAL_COST}); card float64 vs CPU float64 "
          f"({E2E_FLOAT64_ITERS} iterations each): cost {f_cost:.3e}, post "
          f"px {f_post:.3e} (tol {TOL_VISUAL_F64}); the warm solve "
          f"{sol.cost:.9g} (the stage's {v.stats['cost']:.9g})", flush=True)
    results["visual_e2e"] = dict(
        gen_s=gen_s, lidar_s=lidar_s, ate=[ate0, ate],
        ate_float64_cpu=ate_ref, lidar_float64_cpu_s=lidar64_s,
        launches=counts, lidar_stages=lid.stats["global"],
        runs={k: dict(reproj=[r.mean_reproj_pre, r.mean_reproj_post],
                      stats=r.stats) for k, r in runs.items()},
        solve=rec, counts_rel=e_counts, post_rel=e_post, cost_rel=e_cost,
        float64_cost_rel=f_cost, float64_post_rel=f_post,
        depth_map_share=map_share)
    if not (v.mean_reproj_post < v.mean_reproj_pre
            and v.mean_reproj_post < 1.0
            and all(e <= TOL_E2E_COUNT for e in e_counts.values())
            and e_post <= TOL_E2E_POST and e_cost <= TOL_VISUAL_COST
            and f_cost <= TOL_VISUAL_F64 and f_post <= TOL_VISUAL_F64
            and v64.stats["solve_iters"] == ref_n.stats["solve_iters"]
            and sol.cost == v.stats["cost"] and map_share < ZBUF_SHARE):
        _fail("[visual-e2e]: the visual stage misses its limits")
    KEEP["e2e"] = dict(clouds=clouds, lid=lid, cfg=cfg, maps=maps,
                       Rcw=memo["cuda"]["Rcw"], tcw=memo["cuda"]["tcw"])
    return js, R_odom, p_odom


def _write_ladder3(np, work, js, R_odom, p_odom):
    """Ladder 3 as a dataset in the reference's layout, with the port's
    own writers (scripts/ladder3_e2e.py's layout): all_pcd_body/<ts>.pcd
    (binary) + lidar_poses.txt, all_image/<ts>.png + image_poses.txt,
    match.db from the scene's keypoints and matches, and cfg.yaml with
    ladder 3's settings (_window_config: float32) and the COLMAP export
    on.  The images are 4 x 4 placeholders (save_depth_png): the db
    route reads no pixels.  Returns the config's path."""
    import dataclasses

    import yaml

    from global_lvba_tpu_torch.frontend.colmap_db import write_colmap_db
    from global_lvba_tpu_torch.io.pcd import write_pcd
    from global_lvba_tpu_torch.io.tum import write_tum_poses
    from global_lvba_tpu_torch.pipeline.outputs import save_depth_png

    sc = js.lidar
    root = work / "dataset"
    img_dir, pcd_dir = root / "all_image", root / "all_pcd_body"
    img_dir.mkdir(parents=True)
    pcd_dir.mkdir()
    names = [f"{t:.6f}.png" for t in js.image_times]
    blank = np.zeros((4, 4), np.float32)
    for name in names:
        save_depth_png(img_dir / name, blank)
    write_tum_poses(img_dir / "image_poses.txt", js.image_times,
                    R_odom[js.image_frame], p_odom[js.image_frame])
    for i, t in enumerate(sc.times):
        write_pcd(pcd_dir / f"{t:.6f}.pcd", sc.points_body[sc.frame_ids == i])
    write_tum_poses(pcd_dir / "lidar_poses.txt", sc.times, R_odom, p_odom)
    kps4 = [np.concatenate([k, np.ones((k.shape[0], 2), np.float32)], axis=1)
            for k in js.keypoints]
    write_colmap_db(root / "match.db", names, kps4, js.matches)
    cfg = _window_config("float32")
    cfg.data_config.data_path = str(root)
    cfg.data_config.colmap_db_path = "match.db"
    cfg.data_config.image_sample_step = 1
    cm, cam = cfg.cam_model, js.cam
    cm.cam_width, cm.cam_height, cm.scale = cam.width, cam.height, 1.0
    cm.cam_fx, cm.cam_fy, cm.cam_cx, cm.cam_cy = (
        float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy))
    cm.cam_d0, cm.cam_d1, cm.cam_d2, cm.cam_d3 = (
        float(cam.k1), float(cam.k2), float(cam.p1), float(cam.p2))
    cfg.extrin_calib.Rcl = [float(v) for v in js.Rci.reshape(-1)]
    cfg.extrin_calib.Pcl = [float(v) for v in js.tci]
    cfg.colmap_output.enable = True
    path = root / "cfg.yaml"
    path.write_text(yaml.safe_dump(dataclasses.asdict(cfg)))
    return path


def _cli(args, timeout=SYSTEM_CLI_TIMEOUT_S):
    """`python -m global_lvba_tpu_torch <args>` from the repository root in
    a fresh process: (exit code, stdout, stderr, wall s)."""
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "global_lvba_tpu_torch", *map(str, args)],
        capture_output=True, text=True, timeout=timeout,
        cwd=str(Path(__file__).resolve().parent))
    return proc.returncode, proc.stdout, proc.stderr, time.time() - t0


def _last_json(tag, out, err):
    lines = out.strip().splitlines()
    if not lines:
        _fail(f"[system] {tag} printed nothing: {err[-2000:]}")
    return json.loads(lines[-1])


def _same_npz(np, a, b):
    """Every array of two .npz files bitwise equal (the same keys): returns
    the keys that differ."""
    fa, fb = np.load(a), np.load(b)
    if sorted(fa.files) != sorted(fb.files):
        return ["<keys>"]
    return [k for k in fa.files if not (
        fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]))]


def _system(torch, np, dev, kern, results, paths, js, R_odom, p_odom):
    """Phase 17, [system]: ladder 3 (phase 16's scene and odometry) written
    as a reference-layout dataset, then LvbaSystem on the card in three
    runs: A in this process (launch counts from 0), held to phase 16's
    float64 CPU values, its output tree checked, and the kernels held to
    their plain versions at its own solves' shapes (_path_kernels on the
    dataset's poses as read back and A's final anchor poses); B a crash and resume
    through the CLI in a fresh process (A's lidar_ba.npz, a truncated
    visual_ba.tmp.npz), its visual_ba.npz bitwise A's; C the CLI again on
    A's tree (both stages resumed: A's numbers exactly), `info` and
    `view`."""
    import dataclasses
    import shutil

    from global_lvba_tpu_torch.config import LvbaConfig
    from global_lvba_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    from global_lvba_tpu_torch.models.synthetic import ate_rmse
    from global_lvba_tpu_torch.pipeline import system
    from global_lvba_tpu_torch.pipeline.outputs import load_depth_png

    sc = js.lidar
    ref = results["visual_e2e"]
    ref_stats = ref["runs"]["cpu-float64"]["stats"]
    ref_post = ref["runs"]["cpu-float64"]["reproj"][1]
    work = Path(__file__).resolve().parent / "build" / "system_smoke"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.time()
    cfg_path = _write_ladder3(np, work, js, R_odom, p_odom)
    write_s = time.time() - t0
    outA, outB = work / "A", work / "B"

    # ---- run A, in process ----
    spans = collections.defaultdict(float)

    def timed(name, fn):
        def run(*a, **k):
            t = time.time()
            try:
                return fn(*a, **k)
            finally:
                spans[name] += time.time() - t
        return run

    # run_lidar_ba's result (its anchor clouds and poses), for the kernels
    # at this run's shapes
    lidar_ba, lidar = system.run_lidar_ba, []

    def kept(*a, **k):
        lidar.append(lidar_ba(*a, **k))
        return lidar[-1]

    reset_launch_counts()
    t0 = time.time()
    sysA = system.LvbaSystem(LvbaConfig.from_yaml(cfg_path), out_dir=outA)
    spans["load"] = time.time() - t0
    sysA.ckpt.save = timed("checkpoints", sysA.ckpt.save)
    sysA._load_frontend = timed("frontend", sysA._load_frontend)
    sysA.export_outputs = timed("exports", sysA.export_outputs)
    sysA.metrics.dump = timed("metrics_json", sysA.metrics.dump)
    system.run_lidar_ba = kept
    try:
        resA = sysA.run_full_pipeline()
    finally:
        system.run_lidar_ba = lidar_ba
    torch.cuda.synchronize()
    wallA = time.time() - t0
    counts = paths["system"] = launch_counts()
    mA = resA["metrics"]
    v = sysA.visual_result
    vs = v.stats
    stage_keys = ("depth_s", "depth_png_s", "fuse_s", "planes_s", "solve_s")
    in_stages = mA["time/lidar_ba_s"] + mA["time/visual_ba_s"]
    outside = wallA - in_stages + vs["depth_png_s"]
    ate0 = ate_rmse(p_odom, sc.p_true)
    ate = ate_rmse(sysA.p_opt, sc.p_true)
    e_ate = abs(ate - ref["ate_float64_cpu"]) / ref["ate_float64_cpu"]
    e_post = abs(v.mean_reproj_post - ref_post) / ref_post
    e_counts = {k: abs(vs[k] - ref_stats[k]) / ref_stats[k]
                for k in ("tracks_fused", "tracks_with_plane",
                          "observations")}
    print(f"[system] ladder 3 written in {write_s:.2f} s; run A "
          f"(LvbaSystem in process) {wallA:.2f} s: stages "
          f"{ {k: round(mA[k], 3) for k in mA if k.startswith('time/')} }, "
          f"visual {({k: round(vs[k], 3) for k in stage_keys})}, outside "
          f"the stages {({k: round(t, 3) for k, t in spans.items()})}; "
          f"load, checkpoints, PNG and export writes {outside:.2f} s "
          f"({outside / wallA:.3f} of the run); launches {counts}",
          flush=True)
    print(f"[system] run A: ATE {ate0:.5f} -> {ate:.5f} m ({e_ate:.3e} "
          f"from phase 16's float64 CPU run, tol 0.1); reprojection "
          f"{v.mean_reproj_pre:.4f} -> {v.mean_reproj_post:.4f} px "
          f"({e_post:.3e} from float64, tol {TOL_E2E_POST}); counts rel "
          f"diff {e_counts} (tol {TOL_E2E_COUNT})", flush=True)
    if not all(counts[k] > 0 for k in BUCKETED_PATH_KERNELS):
        _fail(f"[system]: a bucketed kernel was never launched: {counts}")
    if counts["zbuffer"] != 1:
        _fail(f"[system]: run A's depth maps took {counts['zbuffer']} "
              f"z-buffer launches, not one")
    if not (np.isfinite(sysA.p_opt).all() and ate < ate0
            and e_ate <= 0.1 and v.mean_reproj_post < 1.0
            and v.mean_reproj_post < v.mean_reproj_pre
            and e_post <= TOL_E2E_POST
            and all(e <= TOL_E2E_COUNT for e in e_counts.values())):
        _fail("[system]: run A misses phase 16's limits")
    # the output tree
    M = len(js.image_times)
    depth = sorted((outA / "depth").glob("*.png"))
    maps = [load_depth_png(pth) for pth in depth]
    zero = sum(not m.any() for m in maps)
    shape_ok = all(m.shape == (js.cam.height, js.cam.width) for m in maps)
    ilines = (outA / "Colmap" / "sparse" / "images.txt").read_text() \
        .splitlines()
    plines = (outA / "Colmap" / "sparse" / "points3D.txt").read_text() \
        .splitlines()
    need = ["checkpoints/lidar_ba.npz", "checkpoints/visual_ba.npz",
            "viz/tracks_before.pcd", "viz/tracks_after.pcd", "metrics.json"]
    missing = [n for n in need if not (outA / n).exists()]
    metrics_ok = json.loads((outA / "metrics.json").read_text()) == \
        json.loads(json.dumps(mA, default=float))
    tree = sorted(str(pth.relative_to(outA)) for pth in outA.rglob("*")
                  if pth.is_file() and pth.parent.name != "depth")
    print(f"[system] run A's tree: {len(depth)} depth PNGs "
          f"({js.cam.width} x {js.cam.height}: {shape_ok}; empty maps: "
          f"{zero}), images.txt {len(ilines)} lines, points3D.txt "
          f"{len(plines)} points, metrics.json equal to the run's: "
          f"{metrics_ok}; the rest {tree}", flush=True)
    if not (len(depth) == M and shape_ok and zero < M
            and [pth.name for pth in depth] == sorted(
                f"{t:.6f}.png" for t in js.image_times)
            and len(ilines) == 2 * M and len(plines) == v.points.shape[0]
            and not missing and metrics_ok):
        _fail(f"[system]: run A's output tree (missing {missing})")
    ds = sysA.ds
    kernels_s = _path_kernels(torch, np, dev, kern, results, "system",
                              sysA.cfg, ds.clouds, ds.lidar_R, ds.lidar_p,
                              lidar[0])
    print(f"[system] run A's kernels at its own solves' shapes: "
          f"{kernels_s:.2f} s", flush=True)

    # ---- run B: a crash after the LiDAR checkpoint, resumed by the CLI ----
    (outB / "checkpoints").mkdir(parents=True)
    shutil.copy(outA / "checkpoints" / "lidar_ba.npz", outB / "checkpoints")
    (outB / "checkpoints" / "visual_ba.tmp.npz").write_bytes(
        b"PK\x03\x04 truncated by SIGKILL")
    rc, out, err, wallB = _cli(["run", "--config", cfg_path, "--out", outB])
    if rc != 0:
        _fail(f"[system] run B exited {rc}: {err[-3000:]}")
    resB = _last_json("run B", out, err)
    mB = json.loads((outB / "metrics.json").read_text())
    diff = _same_npz(np, outA / "checkpoints" / "visual_ba.npz",
                     outB / "checkpoints" / "visual_ba.npz")
    diff += [pth.name for pth, m in zip(depth, maps) if not np.array_equal(
        load_depth_png(outB / "depth" / pth.name), m)]
    tmp_left = (outB / "checkpoints" / "visual_ba.tmp.npz").exists()
    print(f"[system] run B (the CLI in a fresh process, resumed from A's "
          f"lidar_ba.npz past a truncated visual_ba.tmp.npz) {wallB:.2f} s: "
          f"stages { {k: round(mB[k], 3) for k in mB if k.startswith('time/')} }"
          f", reprojection {resB}; visual_ba.npz bitwise A's: {not diff} "
          f"and its depth PNGs A's (differing {diff}); tmp file left: "
          f"{tmp_left}",
          flush=True)
    if diff or tmp_left or "time/lidar_ba_s" in mB:
        _fail("[system]: run B does not reproduce run A's visual stage")

    # ---- run C: both checkpoints present; info; view ----
    rc, out, err, wallC = _cli(["run", "--config", cfg_path, "--out", outA])
    resC = _last_json("run C", out, err) if rc == 0 else None
    same_c = resC == {k: resA[k] for k in ("mean_reproj_pre",
                                           "mean_reproj_post")}
    rc_i, out_i, err_i, wall_i = _cli(["info", "--config", cfg_path])
    info_ok = rc_i == 0 and json.loads(out_i) == dataclasses.asdict(
        LvbaConfig.from_yaml(cfg_path))
    rc_v, out_v, err_v, wall_v = _cli(["view", "--out", outA])
    view_ok = rc_v == 1 and "open3d not installed" in out_v
    print(f"[system] run C (the CLI on A's tree) {wallC:.2f} s: {resC}, "
          f"run A's exactly: {same_c}; info {wall_i:.2f} s, the config's "
          f"asdict: {info_ok}; view {wall_v:.2f} s, exit {rc_v} with the "
          f"hint: {view_ok}", flush=True)
    if not (rc == 0 and same_c and info_ok and view_ok):
        _fail(f"[system]: run C / info / view ({err[-2000:]}"
              f"{err_i[-1000:]}{err_v[-1000:]})")
    results["system"] = dict(
        write_s=write_s, run_a=dict(wall_s=wallA, metrics=mA, spans=spans,
                                    visual_stages={k: vs[k]
                                                   for k in stage_keys},
                                    outside_s=outside, launches=counts,
                                    ate=[ate0, ate], ate_rel=e_ate,
                                    reproj=[v.mean_reproj_pre,
                                            v.mean_reproj_post],
                                    post_rel=e_post, counts_rel=e_counts),
        kernels_s=kernels_s,
        run_b=dict(wall_s=wallB, metrics=mB, bitwise=not diff),
        run_c=dict(wall_s=wallC, info_s=wall_i, view_s=wall_v))
    shutil.rmtree(work, ignore_errors=True)


def _mesh_dryrun(torch, dev, results, paths):
    """[mesh-dryrun]: dryrun_multichip on MESH_DRYRUN_N shards of the card
    in float64, every check sharded == local within 1e-8; its launches are
    the path "mesh-dryrun"."""
    from global_lvba_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    from global_lvba_tpu_torch.parallel.dryrun import TOL, dryrun_multichip

    reset_launch_counts()
    t0 = time.time()
    out = dryrun_multichip(MESH_DRYRUN_N, devices=[dev] * MESH_DRYRUN_N,
                           dtype=torch.float64)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = paths["mesh-dryrun"] = launch_counts()
    print(f"[mesh-dryrun] n={MESH_DRYRUN_N} on {dev} in float64 ({wall:.1f} "
          f"s): max |sharded - local| by check {out}; launches {counts}",
          flush=True)
    results["mesh_dryrun"] = dict(n=MESH_DRYRUN_N, wall_s=wall, diffs=out,
                                  launches=counts)
    bad = {k: v for k, v in out.items() if k != "spatial" and not v < TOL}
    if bad or not all(counts[k] > 0 for k in BUCKETED_F64_KERNELS):
        _fail(f"mesh-dryrun: sharded != local {bad}, or a float64 kernel "
              f"never launched: {counts}")


def _mesh_shard_kernels(torch, np, dev, kern, results):
    """[mesh-shard-kernels]: kernels 1, 2b, 3, 4 and 5 against their plain
    versions at the shapes of the last of MESH_KERNELS_N shards (its
    padding rows included) of the dry run's bucketed problem in float32;
    then their float64 instances at the shapes of every one of the dry
    run's MESH_DRYRUN_N shards in float64 (its last shards hold no live
    row), all shards' buckets in one check; both through _e2e_kernels."""
    from global_lvba_tpu_torch.parallel.dryrun import _lidar_problem
    from global_lvba_tpu_torch.parallel.mesh import make_mesh
    from global_lvba_tpu_torch.parallel.shard import shard_buckets

    for n, d, tag in ((MESH_KERNELS_N, torch.float32, "mesh-shard-kernels"),
                      (MESH_DRYRUN_N, torch.float64,
                       "mesh-shard-kernels-f64")):
        buckets, R, p, _ = _lidar_problem(d, dev)
        sb = shard_buckets(buckets, make_mesh(n, devices=[dev] * n))
        f64 = d == torch.float64
        shards = ([s.shards[i] for i in range(n) for s in sb] if f64
                  else [s.shards[-1] for s in sb])
        pad = [s.rows - fa.n.shape[0] for s, fa in zip(sb, buckets)]
        dead = [int((fa.n.sum(dim=1) == 0).sum()) for fa in shards]
        print(f"[{tag}] {'every' if f64 else 'the last'} of {n} shards in "
              f"{d}: rows {[fa.n.shape[0] for fa in shards]}, of them "
              f"without a live entry {dead}; rows the sharding padded "
              f"{pad}", flush=True)
        if not (any(dead) and (f64 or any(pad))):
            _fail(f"{tag}: the shards carry no padding row")
        _e2e_kernels(torch, kern, results, tag, shards,
                     R.double().cpu().numpy(), p.double().cpu().numpy(),
                     R.shape[0], f64=f64)


def _aligned_shard_kernels(torch, kern, tag, shards, R, p, W):
    """[tag]: kernels 1, 2 (aligned) and 3 against their plain versions at
    the shapes that each aligned shard's evaluation gives them (its voxel
    chunks, its padding rows included): soa_agg over every shard under
    _agg_check; soa_chain as the evaluation calls it on each shard
    (_chain_check: rows, g, Hd, dead cells' rows zero, bitwise repeats);
    tf32_split and syrk_ over each shard's chain rows into its gram
    (_syrk_check).  Each max abs error raises its kernels-line
    max_abs_err."""
    from global_lvba_tpu_torch.factors.plane_eigen import (
        AlignedPlaneFactorArrays, pose_table, voxel_chunks)
    from global_lvba_tpu_torch.kernels.soa import (
        soa_agg, soa_agg_plain, soa_chain)

    if not all(isinstance(s, AlignedPlaneFactorArrays) for s in shards):
        _fail(f"{tag}: a shard is not of the aligned layout")
    pose12 = pose_table(R, p)
    agg_k = [soa_agg(s.n, s.mu, s.Pc, pose12) for s in shards]
    agg_p = [soa_agg_plain(s.n, s.mu, s.Pc, pose12) for s in shards]
    spec = [_spectrum(torch, s, pose12) for s in shards]
    gap, lam0, lam2 = (torch.cat([x[i] for x in spec]) for i in range(3))
    live = torch.cat([s.n.sum(dim=1) > 0 for s in shards])
    err_agg = _agg_check(
        torch, f"soa_agg {tag}", *(torch.cat([a[i] for a in x])
                                   for i in (0, 1) for x in (agg_k, agg_p)),
        live, live & (gap >= WELL_CONDITIONED_GAP), lam0, lam2)
    del agg_p, spec
    err_chain = err_gram = 0.0
    for i, (s, (_, pv)) in enumerate(zip(shards, agg_k)):
        chunks = voxel_chunks(s.n.shape[0], W)
        ops = [(s.n[lo:hi], s.mu[lo:hi], s.Pc[lo:hi]) for lo, hi in chunks]
        pvs = [pv[lo:hi] for lo, hi in chunks]
        err_chain = max(err_chain, _chain_check(
            torch, f"soa_chain {tag} shard {i}", ops, pose12, pvs,
            TOL_ROWS_REL, TOL_SUM_REL)[3])
        As = _chain_evaluation(soa_chain, ops, pose12, pvs)[0]
        err_gram = max(err_gram, _syrk_check(torch, f"{tag} shard {i}", As,
                                             6 * W))
        del As
    for k, e in (("soa_agg", err_agg), ("soa_chain", err_chain),
                 ("syrk", err_gram)):
        kern[k]["max_abs_err"] = max(kern[k]["max_abs_err"], e)


def _mesh_w512(torch, np, dev, kern, results, paths, bench):
    """[mesh-w512]: the JAX bench's W=512 problem through
    lm_damping_iter_sharded with lu and cg on n in MESH_W512_NS shards of
    the card in float32, against the local LM: residual (the local one's
    factor count) within TOL_MESH_RESID, ATE within TOL_MESH_ATE; ms an
    iteration, host reads an iteration, idle share; then, the launches
    read, the kernels at every shard's shapes of the largest n
    (_aligned_shard_kernels)."""
    from global_lvba_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    from global_lvba_tpu_torch.models.synthetic import ate_rmse
    from global_lvba_tpu_torch.parallel.mesh import make_mesh
    from global_lvba_tpu_torch.parallel.shard import (
        lm_damping_iter_sharded, shard_buckets)
    from global_lvba_tpu_torch.solver.lm import lm_damping_iter

    fa_t, R, p, p_true = bench
    g_loc = sum(fa.n.shape[0] for fa in fa_t)

    def measure(tag, run, g_size):
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        _, syncs = _count_syncs(torch, run)
        _, busy, idle, _, _ = _idle(torch, run, wall)
        resid = float(res.residual) * g_size / g_loc
        rec = dict(route=res.route, iters=res.iters, residual=resid,
                   ate=ate_rmse(res.p.double().cpu().numpy(), p_true),
                   ms_per_iter=wall / max(res.iters, 1),
                   host_reads_per_iter=syncs / max(res.iters, 1),
                   idle_share=idle, device_busy_ms=busy)
        if idle < 0:
            # the kernels' device times overlap (cuSOLVER's LU runs on
            # streams of its own): their sum is no busy time
            rec["idle_share"] = None
        print(f"[mesh-w512] {tag}: route {rec['route']}, residual "
              f"{resid:.9g} in {res.iters} iterations, ATE {rec['ate']:.6f} "
              f"m, {rec['ms_per_iter']:.2f} ms/iter, host reads "
              f"{rec['host_reads_per_iter']:.2f} an iteration, idle share "
              f"{rec['idle_share']} (kernel device ms summed {busy:.1f} "
              f"over {wall:.1f} ms of wall)", flush=True)
        return rec

    out = results["mesh_w512"] = {}
    loc = out["local"] = measure("local", lambda: lm_damping_iter(
        fa_t, R, p, max_iters=LM_ITERS), g_loc)
    reset_launch_counts()
    for n in MESH_W512_NS:
        mesh = make_mesh(n, devices=[dev] * n)
        g_pad = sum(-(-fa.n.shape[0] // n) * n for fa in fa_t)
        for solver in ("lu", "cg"):
            rec = out[f"n{n}-{solver}"] = measure(
                f"n={n} {solver}", lambda: lm_damping_iter_sharded(
                    fa_t, R, p, mesh, max_iters=LM_ITERS,
                    reduced_solver=solver), g_pad)
            e_r = abs(rec["residual"] - loc["residual"]) / loc["residual"]
            e_a = abs(rec["ate"] - loc["ate"]) / loc["ate"]
            rec.update(residual_rel=e_r, ate_rel=e_a)
            if not (rec["route"] == "sharded-dense" and e_r <= TOL_MESH_RESID
                    and e_a <= TOL_MESH_ATE
                    and rec["host_reads_per_iter"] == 1.0):
                _fail(f"mesh-w512 n={n} {solver}: {rec} against the local "
                      f"{loc}")
    torch.cuda.synchronize()
    counts = paths["mesh-w512"] = launch_counts()
    out["launches"] = counts
    print(f"[mesh-w512] launches over the sharded runs {counts}", flush=True)
    if not all(counts[k] > 0 for k in ALIGNED_PATH_KERNELS):
        _fail(f"mesh-w512: a kernel of the path was never launched: {counts}")
    n = max(MESH_W512_NS)
    sb = shard_buckets(fa_t, make_mesh(n, devices=[dev] * n))
    shards = [s.shards[i] for i in range(n) for s in sb]
    dead = [int((fa.n.sum(dim=1) == 0).sum()) for fa in shards]
    print(f"[mesh-w512] the kernels at the {n} shards' shapes: rows "
          f"{[fa.n.shape[0] for fa in shards]}, of them without a live "
          f"entry {dead}; rows the sharding padded "
          f"{[s.rows - fa.n.shape[0] for s, fa in zip(sb, fa_t)]}",
          flush=True)
    if not any(dead):
        _fail("mesh-w512: the shards carry no padding row")
    _aligned_shard_kernels(torch, kern, "mesh-w512-kernels", shards, R, p,
                           R.shape[0])


def _mesh_w4096(torch, np, dev, kern, results, paths):
    """[mesh-w4096]: path 2c's stage-1 map (W=4096) through
    lm_damping_iter_banded_compact_sharded on MESH_W4096_N shards of the
    card (LARGE_LM_ITERS iterations, each bucket's block by the local
    route's rule: a power of two, so it divides W), against the
    float64 CPU LM's residual (path 2c's limit) and beside the local
    split-banded LM: no (6W)²-element operand in one evaluation and one
    solve's trips run eagerly; peak memory; the kernels at every shard's
    shapes, in one evaluation."""
    from torch.profiler import ProfilerActivity, profile

    from global_lvba_tpu_torch.factors.padding import buckets_to_device
    from global_lvba_tpu_torch.factors.plane_eigen import (
        banded_plan, build_banded_groups)
    from global_lvba_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    from global_lvba_tpu_torch.parallel.mesh import make_mesh, shard_bounds
    from global_lvba_tpu_torch.parallel.shard import (
        _group_shard, lm_damping_iter_banded_compact_sharded,
        pad_banded_group_stack)
    from global_lvba_tpu_torch.solver import dist_solve
    from global_lvba_tpu_torch.solver.lm import lm_damping_iter, plan_route

    vm, Rp, pp, _ = KEEP.pop("2c")
    W, n = LARGE_FRAMES, MESH_W4096_N
    ref64 = results["path_2c"]["stage1_lm"]["residual_float64_cpu"]
    bs = buckets_to_device(vm, W=W, dtype=torch.float32, device=dev)
    R = torch.as_tensor(Rp, dtype=torch.float32, device=dev)
    p = torch.as_tensor(pp, dtype=torch.float32, device=dev)
    groups = [build_banded_groups(fa, W) for fa in bs]
    blocks = [bg.inv.shape[-1] // 2 for bg in groups]
    if any(W % b for b in blocks):
        _fail(f"mesh-w4096: a block does not divide W={W}: {blocks}")
    mesh = make_mesh(n, devices=[dev] * n)
    dist_solve._GRAPHS.clear()

    def timed(run):
        run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3, \
            torch.cuda.max_memory_allocated()

    loc, loc_ms, loc_peak = timed(lambda: lm_damping_iter(
        bs, R, p, max_iters=LARGE_LM_ITERS))
    dist_solve._GRAPHS.clear()

    def run():
        return lm_damping_iter_banded_compact_sharded(
            bs, R, p, mesh, max_iters=LARGE_LM_ITERS)

    run()
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    counts = paths["mesh-w4096"] = launch_counts()
    _, syncs = _count_syncs(torch, run)
    e64 = abs(float(res.residual) - ref64) / ref64
    # one evaluation and one solve's trips run eagerly (a graph replay
    # shows no op): no operand of (6W)² elements
    route = plan_route(bs, W, "cg", "banded", split=True, mesh=mesh)
    u0 = torch.full((), 0.01, dtype=torch.float32, device=dev)
    big = (6 * W) ** 2
    solve_graph = dist_solve._solve
    dist_solve._solve = lambda kind, fn, ops, it, graph=True: fn(it, *ops)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            state = route.cgh(R, p)
            route.solve(state, u0)
            torch.cuda.synchronize()
    finally:
        dist_solve._solve = solve_graph
    largest, hits = 0, []
    for ev in prof.events():
        for shp in ev.input_shapes or ():
            if isinstance(shp, (list, tuple)) and shp and all(
                    isinstance(s, int) for s in shp):
                largest = max(largest, math.prod(shp))
                if math.prod(shp) >= big:
                    hits.append((ev.name, shp))
    del state
    ms_iter = wall / max(res.iters, 1)
    loc_iter = loc_ms / max(loc.iters, 1)
    rec = results["mesh_w4096"] = dict(
        n=n, blocks=blocks, route=res.route, iters=res.iters,
        residual=float(res.residual), residual_float64_cpu=ref64,
        rel_diff=e64, local_route=loc.route,
        local_residual=float(loc.residual), wall_ms=wall,
        ms_per_iter=ms_iter, local_ms_per_iter=loc_iter, peak_bytes=peak,
        local_peak_bytes=loc_peak, largest_operand=largest,
        host_reads=syncs, launches=counts)
    print(f"[mesh-w4096] W={W}, n={n}, blocks {blocks}: route {res.route}, "
          f"residual {float(res.residual):.9g} in {res.iters} iterations; "
          f"float64 CPU {ref64:.9g}: rel diff {e64:.3e} (tol "
          f"{TOL_RESID_LM_REL}); {ms_iter:.2f} ms/iter (with the set-up), "
          f"the local {loc.route} {loc_iter:.2f}; peak memory "
          f"{peak / 1e9:.3f} GB (local {loc_peak / 1e9:.3f}; (6W)² float32 "
          f"= {big * 4 / 1e9:.3f} GB); largest operand {largest} elements, "
          f"ops at (6W)² or above: {hits[:3]}; synchronizing calls {syncs} "
          f"(set-up and {res.iters} reads of `converged`); launches "
          f"{counts}", flush=True)
    if not (res.route == "sharded-compact" and e64 <= TOL_RESID_LM_REL
            and not hits and bool(torch.isfinite(res.p).all())):
        _fail(f"mesh-w4096: {rec}, (6W)² operands {hits[:3]}")
    if not all(counts[k] > 0 for k in BANDED_PATH_KERNELS):
        _fail(f"mesh-w4096: a kernel of the path was never launched: "
              f"{counts}")
    # the kernels at every shard's shapes (the padded groups included), in
    # one evaluation over the shards' stacks: the errors are relative to
    # the whole map's largest values, as path 2c's are (the last shard
    # alone, at the corridor's far end, holds none of them)
    shard_gs = []
    for bg in groups:
        bg = pad_banded_group_stack(bg, n)
        shard_gs += [_group_shard(bg, lo, hi, dev) for lo, hi in
                     shard_bounds(bg.fa.n.shape[0], n)]
    _plan_kernels(torch, kern, results, "mesh-w4096-kernels",
                  banded_plan(shard_gs, W), R, p, W)
    del shard_gs, groups, bs, vm


def _mesh_visual(torch, np, dev, results):
    """[mesh-visual]: the JAX bench's M=1000 problem with its observations
    and pairs sharded over MESH_VISUAL_N shards of the card in float32:
    the route _auto_solver(1000, pairs_sharded=True) names (cg, S
    row-sharded), the final cost within TOL_MESH_VISUAL of the local
    float32 solve's ([visual-m1000], the tier route), ms an iteration."""
    from global_lvba_tpu_torch.parallel.mesh import make_mesh
    from global_lvba_tpu_torch.solver import schur

    kind, iters = VISUAL_BENCH[0]
    prob, bp = _visual_problem(kind)
    counts = np.bincount(prob.obs_pt, minlength=prob.num_pts)
    want = schur._auto_solver(prob.num_cams, pairs_sharded=True,
                              Q=int((counts.astype(np.int64) ** 2).sum()))
    n = MESH_VISUAL_N
    mesh = make_mesh(n, devices=[dev] * n)
    t0 = time.perf_counter()
    plan = schur.plan_visual(prob, bp.R0, bp.t0, bp.X0, dtype=torch.float32,
                             mesh=mesh)
    setup_ms = (time.perf_counter() - t0) * 1e3
    schur.run_visual(plan, iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = schur.run_visual(plan, iters)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    loc = results["visual_bench"][kind]
    e = _rel_cost(res.cost, loc["cost"])
    rec = results["mesh_visual"] = dict(
        n=n, route=res.route, auto_solver=want, iters=res.iters,
        cost0=res.cost0, cost=res.cost, local_route=loc["route"],
        local_cost=loc["cost"], cost_rel=e, setup_ms=setup_ms,
        ms_per_iter=wall / max(res.iters, 1),
        local_ms_per_iter=loc["ms_per_iter"])
    print(f"[mesh-visual] M={prob.num_cams} on {n} shards: route "
          f"{res.route} (_auto_solver(pairs_sharded=True): {want}), cost "
          f"{res.cost0:.9g} -> {res.cost:.9g} in {res.iters} iterations; the "
          f"local {loc['route']} solve's {loc['cost']:.9g}: rel diff {e:.3e} "
          f"(tol {TOL_MESH_VISUAL}); set-up {setup_ms:.0f} ms, "
          f"{rec['ms_per_iter']:.2f} ms/iter (local "
          f"{loc['ms_per_iter']:.2f})", flush=True)
    if not (res.route == want == "cg" and e <= TOL_MESH_VISUAL
            and res.cost < res.cost0):
        _fail(f"mesh-visual: {rec}")


def _mesh_spatial(torch, np, dev, results):
    """[mesh-spatial]: distributed_voxel_moments over path 2a's clouds (2.0 M
    points, world frame at the perturbed poses) on MESH_SPATIAL_N shards
    of the card against host_voxel_moments: keys and counts exactly, Σx
    and Σxxᵀ within TOL_MESH_SPATIAL of each column's max |.|."""
    from global_lvba_tpu_torch.parallel.mesh import make_mesh
    from global_lvba_tpu_torch.parallel.spatial import (
        distributed_voxel_moments, host_voxel_moments)

    pts_b, fid, Ra, pa = KEEP["2a"]     # phase 20 reads it too
    pts = (np.einsum("nij,nj->ni", Ra[fid], pts_b) + pa[fid]).astype(
        np.float32)
    t0 = time.perf_counter()
    hk, hc, hs, hm = host_voxel_moments(pts.astype(np.float64), VOXEL)
    host_ms = (time.perf_counter() - t0) * 1e3
    n = MESH_SPATIAL_N
    mesh = make_mesh(n, devices=[dev] * n)
    args = (pts, VOXEL, mesh)
    distributed_voxel_moments(*args, capacity=hk.shape[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kk, cc, ss, mm = distributed_voxel_moments(*args, capacity=hk.shape[0])
    dev_ms = (time.perf_counter() - t0) * 1e3
    same = np.array_equal(kk, hk) and np.array_equal(cc, hc)
    e_s = float(np.abs(ss - hs).max(0).max() / np.abs(hs).max())
    e_m = float(np.abs(mm - hm).max(0).max() / np.abs(hm).max())
    results["mesh_spatial"] = dict(points=int(pts.shape[0]), n=n,
                                   voxels=int(hk.shape[0]), equal=same,
                                   sum_rel=e_s, moment_rel=e_m, ms=dev_ms,
                                   host_ms=host_ms)
    print(f"[mesh-spatial] {pts.shape[0]} points on {n} shards: "
          f"{hk.shape[0]} voxels, keys and counts equal to the host's: "
          f"{same}; Σx rel err {e_s:.3e}, Σxxᵀ {e_m:.3e} (tol "
          f"{TOL_MESH_SPATIAL}, of each column's max |.|); {dev_ms:.1f} ms "
          f"(host binning {host_ms:.1f} ms)", flush=True)
    if not (same and e_s <= TOL_MESH_SPATIAL and e_m <= TOL_MESH_SPATIAL):
        _fail("mesh-spatial: the distributed moments differ from the host's")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh_processes(results):
    """[mesh-processes]: two processes on cuda:0 joined through gloo, one
    factor-sharded LM step each == the local step; then a world of one
    NCCL process through lm_damping_iter_sharded (its reduction an NCCL
    all_reduce on the card).  Each worker is this script with
    --mesh-worker; any failure fails the phase."""
    root = Path(__file__).resolve().parent
    runs = []
    for backend, world in (("gloo", 2), ("nccl", 1)):
        port = str(_free_port())
        runs.append([(backend, subprocess.Popen(
            [sys.executable, str(root / "chip_smoke.py"), "--mesh-worker",
             str(rank), str(world), port, backend], cwd=str(root),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for rank in range(world)])
    out = results["mesh_processes"] = []
    try:
        for backend, proc in (x for r in runs for x in r):
            so, se = proc.communicate(timeout=MESH_PROC_TIMEOUT_S)
            if proc.returncode != 0:
                _fail(f"mesh-processes ({backend}): a worker exited "
                      f"{proc.returncode}: {se[-3000:]}")
            line = json.loads(so.strip().splitlines()[-1])
            out.append(line)
            print(f"[mesh-processes] {line}", flush=True)
    finally:
        for r in runs:
            for _, proc in r:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def _mesh_worker(argv) -> int:
    """One process of [mesh-processes]: join the group, then one
    factor-sharded LM step over the dry run's problem in float64 on
    cuda:0 against the local step, and a psum of the ranks."""
    import torch

    rank, world, port, backend = int(argv[0]), int(argv[1]), argv[2], argv[3]
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from global_lvba_tpu_torch.parallel.dryrun import _lidar_problem
    from global_lvba_tpu_torch.parallel.mesh import (
        initialize_distributed, make_mesh, psum)
    from global_lvba_tpu_torch.parallel.shard import lm_damping_iter_sharded
    from global_lvba_tpu_torch.solver.lm import lm_damping_iter

    dev = torch.device("cuda:0")
    initialize_distributed(f"localhost:{port}", world, rank, backend=backend)
    try:
        mesh = make_mesh(1, devices=[dev])
        tot = float(psum([torch.full((), float(rank + 1), device=dev)],
                         mesh))
        buckets, R, p, _ = _lidar_problem(torch.float64, dev)
        loc = lm_damping_iter(buckets, R, p, max_iters=1)
        res = lm_damping_iter_sharded(buckets, R, p, mesh, max_iters=1)
        dR = float((res.R - loc.R).abs().max())
        dp = float((res.p - loc.p).abs().max())
        line = dict(backend=backend, world=world, rank=rank,
                    shards=mesh.n_shards(), psum=tot, route=res.route,
                    iters=res.iters, dR=dR, dp=dp)
        print(json.dumps(line), flush=True)
        if not (tot == world * (world + 1) / 2 and dR < 1e-9 and dp < 1e-9):
            print(f"sharded step != local: {line}", file=sys.stderr)
            return 1
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _mesh(torch, np, dev, kern, results, paths, bench):
    """Phase 18, the multi-device layer on one card (each mesh lists cuda:0
    several times): [mesh-dryrun], [mesh-shard-kernels], [mesh-w512],
    [mesh-w4096], [mesh-visual], [mesh-spatial], [mesh-processes]."""
    from global_lvba_tpu_torch.solver import dist_solve

    dist_solve._GRAPHS.clear()
    for name, run in (
            ("dryrun", lambda: _mesh_dryrun(torch, dev, results, paths)),
            ("shard-kernels", lambda: _mesh_shard_kernels(
                torch, np, dev, kern, results)),
            ("w512", lambda: _mesh_w512(torch, np, dev, kern, results,
                                        paths, bench)),
            ("w4096", lambda: _mesh_w4096(torch, np, dev, kern, results,
                                          paths)),
            ("visual", lambda: _mesh_visual(torch, np, dev, results)),
            ("spatial", lambda: _mesh_spatial(torch, np, dev, results)),
            ("processes", lambda: _mesh_processes(results))):
        t0 = time.time()
        run()
        dist_solve._GRAPHS.clear()
        results[f"mesh_{name}_s"] = time.time() - t0
        print(f"[mesh-{name}] {results[f'mesh_{name}_s']:.1f} s", flush=True)

# ---- phase 19 [a3b]: the opt-in large-W evaluations ----
TOL_A3B_RESID = 1e-5       # the opt-in layout's LM residual vs the default
                           # layout's in the same call, relative
A3B_CORRIDOR = (48, 800, 4)   # the CPU tests' corridor (W, ppf, seed) and
A3B_BLOCK = 8                 # block, for the float64 group forms
A3B_ALIGNED_KERNELS = ("table_select", "soa_agg", "soa_chain",
                       "entry_reduce")


def _group_stacks(torch, groups):
    """Each aligned stack of `groups` flattened: (n, mu, Pc) of (G·Vp, 2B)
    and its window frame ids offset[g] + k (G·2B,) int32."""
    out = []
    for bg in groups:
        G, Vp, w = bg.fa.n.shape
        flat = tuple(x.reshape((G * Vp,) + tuple(x.shape[2:])) for x in bg.fa)
        ids = (bg.offset.view(G, 1) + torch.arange(
            w, dtype=torch.int32, device=bg.offset.device)).reshape(-1)
        out.append((flat, ids.to(torch.int32), (G, Vp, w)))
    return out


def _group_bounds(stacks, itemsize):
    """The group forms' bounds over `stacks` (one launch of each a stack,
    as an evaluation makes them), by the bytes the functions need:
    soa_agg n of every cell, μ and Pc's upper triangle of a live one, the
    (G, 2B, 12) windows and 17 outputs a voxel; soa_chain_groups the same
    inputs, pv's 13 used values a voxel, A's 18 values a cell written and
    the (G·2B, 30) entry rows; each against its live cells' operations."""
    cells = sum(st[0][0].numel() for st in stacks)
    live = sum(int((st[0][0] > 0).sum()) for st in stacks)
    vox = sum(st[0][0].shape[0] for st in stacks)
    slots = sum(st[2][0] * st[2][2] for st in stacks)
    rate = FP32_FLOP_PER_S if itemsize == 4 else FP64_FLOP_PER_S
    agg = _bound((cells + live * 9 + slots * 12 + vox * 17) * itemsize,
                 live * AGG_FLOPS_PER_CELL + vox * AGG_FLOPS_PER_VOXEL, rate)
    chain = _bound((cells + live * 9 + slots * 12 + vox * 13 + cells * 18
                    + slots * 30) * itemsize, live * CHAIN_FLOPS_PER_CELL,
                   rate)
    return agg, chain


def _group_kernels(torch, kern, results, tag, groups, R, p, f64=False,
                   timed=True):
    """[tag]: the group forms of kernels 1 and 2 at the aligned stacks'
    shapes against their plain versions: table_select of each stack's
    (G, 2B, 12) windows bitwise its plain version; soa_agg on the windows
    under _agg_check (phase 2's limits: λ within TOL_RESIDV_REL of
    λ_max), bitwise equal to soa_agg on the per-entry rows (the windows
    repeated a voxel) and to itself; soa_chain_groups' rows within
    TOL_ROWS_REL, its (group, slot) entry rows' jjt and diagonal extras
    within TOL_SUM_REL, dead cells' rows exactly zero, two launches
    bitwise equal.  f64: the float64 instances under the TOL64_* limits.
    With `timed`, each form's device ms over the stacks (one launch a
    stack, as an evaluation) beside its plain version and its bound.
    Each kernel's max abs error raises its kernels-line max_abs_err."""
    from global_lvba_tpu_torch.factors.plane_eigen import (
        AlignedPlaneFactorArrays, pose_table)
    from global_lvba_tpu_torch.kernels.selection import (
        table_select_buckets, table_select_buckets_plain)
    from global_lvba_tpu_torch.kernels.soa import (
        soa_agg, soa_agg_buckets, soa_agg_buckets_plain, soa_agg_plain,
        soa_chain_groups, soa_chain_groups_plain)

    if f64:
        tol_agg = (TOL64_RESIDV_REL, TOL64_RESIDV_REL_LINE, TOL64_PV)
        tol_rows, tol_sum, sfx = TOL64_ROWS_REL, TOL64_SUM_REL, "_f64"
    else:
        tol_agg = (TOL_RESIDV_REL, TOL_RESIDV_REL_LINE, TOL_PV)
        tol_rows, tol_sum, sfx = TOL_ROWS_REL, TOL_SUM_REL, ""
    pose12 = pose_table(R, p)
    stacks = _group_stacks(torch, groups)
    ids = [st[1] for st in stacks]
    sel_k = table_select_buckets(ids, pose12)
    sel_p = table_select_buckets_plain(ids, pose12)
    torch.cuda.synchronize()
    sel_ok = all(torch.equal(a, b) for a, b in zip(sel_k, sel_p))
    wins = [s_.view(G, w, 12) for s_, (_, _, (G, _, w)) in zip(sel_k, stacks)]
    out = dict(stacks=[list(st[2]) for st in stacks], select_bitwise=sel_ok)
    err_agg = err_rows = abs_rows = err_j = err_d = abs_vals = 0.0
    same_entry = rep_agg = rep_chain = dead_ok = True
    pvs = []
    for ((n, mu, Pc), _, (G, Vp, w)), win in zip(stacks, wins):
        rk, pvk = soa_agg(n, mu, Pc, win)
        rk2, pvk2 = soa_agg(n, mu, Pc, win)
        rows = win.repeat_interleave(Vp, dim=0)
        re_, pve = soa_agg(n, mu, Pc, rows)
        rp, pvp = soa_agg_plain(n, mu, Pc, win)
        torch.cuda.synchronize()
        rep_agg &= bool(torch.equal(rk, rk2) and torch.equal(pvk, pvk2))
        same_entry &= bool(torch.equal(rk, re_) and torch.equal(pvk, pve))
        gap, lam0, lam2 = _spectrum(torch, AlignedPlaneFactorArrays(
            n, mu, Pc), rows)
        live = n.sum(dim=1) > 0
        wc = live & (gap >= WELL_CONDITIONED_GAP)
        if bool(live.any()):
            err_agg = max(err_agg, _agg_check(
                torch, f"soa_agg{sfx} group form {tag} G={G} Vp={Vp} 2B={w}",
                rk, rp, pvk, pvp, live, wc, lam0, lam2, tols=tol_agg,
                ref64=not f64))
        elif bool(rk.any()):     # a stack of padding alone (no group)
            _fail(f"{tag}: soa_agg gave a residual to padded voxels")
        del rows, re_, pve, rk2, pvk2, rp, pvp, gap, lam0, lam2
        A_k, v_k = soa_chain_groups(n, mu, Pc, win, pvk)
        A_k2, v_k2 = soa_chain_groups(n, mu, Pc, win, pvk)
        A_p, v_p = soa_chain_groups_plain(n, mu, Pc, win, pvk)
        torch.cuda.synchronize()
        err_rows = max(err_rows, _rel(A_k, A_p))
        abs_rows = max(abs_rows, float((A_k - A_p).abs().max()))
        err_j = max(err_j, _rel(v_k[:, :6], v_p[:, :6]))
        err_d = max(err_d, _rel(v_k[:, 6:], v_p[:, 6:]))
        abs_vals = max(abs_vals, float((v_k - v_p).abs().max()))
        rep_chain &= bool(torch.equal(A_k, A_k2) and torch.equal(v_k, v_k2))
        dead = (n <= 0)[:, None, :, None].expand(G * Vp, 3, w, 6)
        dead_ok &= bool((A_k.view(G * Vp, 3, w, 6)[dead] == 0).all())
        pvs.append(pvk)
        del A_k, A_k2, A_p, v_k, v_k2, v_p, dead
    ok = (sel_ok and same_entry and rep_agg and rep_chain and dead_ok
          and err_rows <= tol_rows and max(err_j, err_d) <= tol_sum)
    out.update(soa_agg=dict(max_abs=err_agg, per_entry_bitwise=same_entry,
                            repeatable=rep_agg),
               soa_chain_groups=dict(rows=err_rows, jjt=err_j, extras=err_d,
                                     max_abs_rows=abs_rows,
                                     max_abs_vals=abs_vals,
                                     dead_zero=dead_ok, repeatable=rep_chain))
    print(f"[{tag}] group forms at the aligned stacks {out['stacks']} "
          f"(G, Vp, 2B): table_select{sfx} of the windows bitwise equal: "
          f"{sel_ok}; soa_agg{sfx} on the windows bitwise the per-entry "
          f"rows' {same_entry}, repeatable {rep_agg}; soa_chain{sfx} group "
          f"form rows rel err {err_rows:.3e} (tol {tol_rows}), entry rows "
          f"jjt {err_j:.3e}, extras {err_d:.3e} (tol {tol_sum}), dead "
          f"cells' rows == 0: {dead_ok}, two launches bitwise equal: "
          f"{rep_chain}", flush=True)
    if not ok:
        _fail(f"{tag}: a group form disagrees with its plain version: {out}")
    if timed:
        ops = [(n, mu, Pc, win) for ((n, mu, Pc), _, _), win in zip(stacks,
                                                                     wins)]
        agg_b, chain_b = _group_bounds(stacks, 8 if f64 else 4)
        out["soa_agg"].update(**_times(
            torch, f"soa_agg{sfx} group form {tag}",
            lambda: soa_agg_buckets(ops),
            lambda: soa_agg_buckets_plain(ops)), bound=agg_b)
        out["soa_chain_groups"].update(**_times(
            torch, f"soa_chain{sfx} group form {tag}",
            lambda: [soa_chain_groups(*o, q) for o, q in zip(ops, pvs)],
            lambda: [soa_chain_groups_plain(*o, q)
                     for o, q in zip(ops, pvs)]), bound=chain_b)
        print(f"[{tag}] bounds: soa_agg{sfx} group form {agg_b[0]:.4f} ms "
              f"({agg_b[1]}), soa_chain{sfx} group form {chain_b[0]:.4f} ms "
              f"({chain_b[1]})", flush=True)
    results.setdefault("a3b_kernels", {})[tag] = out
    for k, e in (("soa_agg", err_agg), ("soa_chain", abs_rows)):
        kern[k + sfx]["max_abs_err"] = max(kern[k + sfx]["max_abs_err"], e)
        if timed:
            kern[k + sfx]["group_form"] = {
                key: out["soa_agg" if k == "soa_agg" else "soa_chain_groups"]
                .get(key) for key in ("ms", "plain_ms", "bound")}
    return out


def _a3b_lm(torch, tag, bs, R, p, iters, ref_kw, opt_kw, ref_route,
            opt_route, setup=None):
    """[tag]: lm_damping_iter over `bs` with the default layout (ref_kw)
    and the opt-in one (opt_kw), both warmed up (their graphs captured),
    then timed in turns (default, opt-in, opt-in, default), the launch
    counts set to 0 just before the first opt-in run and read after it.
    Each must take its route; the opt-in residual within TOL_A3B_RESID of
    the default's (relative).  setup(on) switches a module constant
    around the opt-in runs.  Returns the record and the launch counts."""
    from global_lvba_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    from global_lvba_tpu_torch.solver import dist_solve
    from global_lvba_tpu_torch.solver.lm import lm_damping_iter, plan_route

    setup = setup or (lambda on: None)
    W = R.shape[0]

    def run(kw, on):
        setup(on)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            lm = lm_damping_iter(bs, R, p, max_iters=iters, **kw)
            torch.cuda.synchronize()
            return lm, (time.perf_counter() - t0) * 1e3, \
                torch.cuda.max_memory_allocated()
        finally:
            setup(False)

    dist_solve._GRAPHS.clear()
    run(ref_kw, False)
    run(opt_kw, True)
    ref, ref_ms1, ref_peak = run(ref_kw, False)
    reset_launch_counts()
    opt, opt_ms1, opt_peak = run(opt_kw, True)
    counts = launch_counts()
    opt2, opt_ms2, _ = run(opt_kw, True)
    ref2, ref_ms2, _ = run(ref_kw, False)
    # the set-up alone (plan_route) and one evaluation's launches
    setup(True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        route = plan_route(bs, W, **opt_kw)
        torch.cuda.synchronize()
        setup_ms = (time.perf_counter() - t0) * 1e3
        reset_launch_counts()
        route.cgh(R, p)
        torch.cuda.synchronize()
        per_eval = {k: v for k, v in launch_counts().items() if v}
    finally:
        setup(False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan_route(bs, W, **ref_kw)
    torch.cuda.synchronize()
    ref_setup_ms = (time.perf_counter() - t0) * 1e3
    e_res = abs(float(opt.residual) - float(ref.residual)) / abs(
        float(ref.residual))
    same = bool(torch.equal(opt.p, opt2.p) and torch.equal(ref.p, ref2.p))
    opt_ms = (opt_ms1 + opt_ms2) / 2 / max(opt.iters, 1)
    ref_ms = (ref_ms1 + ref_ms2) / 2 / max(ref.iters, 1)
    print(f"[{tag}] {W} frames, {len(bs)} buckets, {iters} LM iterations: "
          f"route {opt.route} ({opt.iters} iterations) residual "
          f"{float(opt.residual):.9g}, {opt_ms:.2f} ms/iter (runs "
          f"{opt_ms1:.1f}, {opt_ms2:.1f} ms with set-up), set-up "
          f"{setup_ms:.1f} ms, peak {opt_peak / 1e9:.3f} GB; default route "
          f"{ref.route} ({ref.iters} iterations) residual "
          f"{float(ref.residual):.9g}, {ref_ms:.2f} ms/iter (runs "
          f"{ref_ms1:.1f}, {ref_ms2:.1f} ms), set-up {ref_setup_ms:.1f} ms, "
          f"peak {ref_peak / 1e9:.3f} GB; rel diff {e_res:.3e} (tol "
          f"{TOL_A3B_RESID}); repeats bitwise equal: {same}; launches an "
          f"evaluation {per_eval}; the run's {counts}", flush=True)
    if not (opt.route == opt_route and ref.route == ref_route
            and e_res <= TOL_A3B_RESID and bool(torch.isfinite(opt.p).all())
            and same):
        _fail(f"{tag}: routes {opt.route} / {ref.route}, residual "
              f"{float(opt.residual)} vs {float(ref.residual)}, repeatable "
              f"{same}")
    rec = dict(route=opt.route, residual=float(opt.residual),
               iters=opt.iters, ms_per_iter=opt_ms, runs_ms=[opt_ms1, opt_ms2],
               setup_ms=setup_ms, peak_bytes=opt_peak,
               default=dict(route=ref.route, residual=float(ref.residual),
                            iters=ref.iters, ms_per_iter=ref_ms,
                            runs_ms=[ref_ms1, ref_ms2],
                            setup_ms=ref_setup_ms, peak_bytes=ref_peak),
               rel_diff=e_res, repeatable=same, launches_per_eval=per_eval,
               launches=counts)
    return rec, counts


def _a3b(torch, np, dev, kern, results, paths, large, kernels=True,
         aligned=True, gather=True):
    """Phase 19 [a3b], the JAX package's opt-in large-W evaluations:
    [a3b-kernels] the group forms of kernels 1 and 2 at path 2c's aligned
    stacks (float32) and at the CPU tests' corridor (float64);
    [a3b-2c-aligned] path 2c's stage-1 map with lm.BANDED_ALIGNED, against
    the gather layout in the same call, the no-(6W)²-operand check;
    [a3b-gather-2b] path 2b's map with gather_tables=True against the
    dense route.  Their launches are the paths a3b-aligned and
    a3b-gather.  kernels, aligned, gather: the parts run (all by
    default; scripts/a3b_phase.py picks)."""
    bs, R, p = large
    W = R.shape[0]
    rec = results.setdefault("a3b", {})
    if kernels:
        _a3b_kernels(torch, dev, kern, results, rec, bs, R, p, W)
    if aligned:
        _a3b_aligned(torch, dev, rec, paths, bs, R, p, W)
    if gather:
        bs2, R2, p2 = KEEP["2b"]
        rec["gather_lm"], paths["a3b-gather"] = _a3b_lm(
            torch, "a3b-gather-2b", bs2, R2, p2, LM_ITERS, {},
            dict(gather_tables=True), "dense", "gather")
        if not all(paths["a3b-gather"][k] > 0 for k in BUCKETED_PATH_KERNELS):
            _fail(f"a3b-gather-2b: a kernel of the gather path was never "
                  f"launched: {paths['a3b-gather']}")


def _a3b_kernels(torch, dev, kern, results, rec, bs, R, p, W):
    """[a3b-kernels] at path 2c's aligned stacks (float32), then the
    float64 instances at the CPU tests' corridor (A3B_CORRIDOR, block
    A3B_BLOCK, true poses)."""
    from global_lvba_tpu_torch.factors.plane_eigen import (
        banded_cost, bucket_to_device, build_banded_groups)
    from global_lvba_tpu_torch.map.voxelize import build_voxel_map
    from global_lvba_tpu_torch.models.synthetic import make_corridor_scene

    t0 = time.perf_counter()
    groups = [build_banded_groups(fa, W, aligned=True) for fa in bs]
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    banded, dense = banded_cost(groups, bs, W)
    info = _group_info(groups)
    stack_bytes = sum(sum(x.numel() for x in bg.fa) * 4 for bg in groups)
    print(f"[a3b-kernels] path 2c's aligned banded groups {info} "
          f"(built in {build_ms:.1f} ms; the stacks' n, μ, Pc "
          f"{stack_bytes / 1e6:.1f} MB); dense/banded Gram flops "
          f"{dense / banded:.1f}x", flush=True)
    rec.update(groups=info, build_ms=build_ms, stack_bytes=stack_bytes)
    rec["kernels"] = _group_kernels(torch, kern, results, "a3b-kernels",
                                    groups, R, p)
    sc = make_corridor_scene(A3B_CORRIDOR[0], A3B_CORRIDOR[1],
                             seed=A3B_CORRIDOR[2])
    vm = build_voxel_map(sc.points_body, sc.frame_ids, sc.R_true, sc.p_true,
                         VOXEL, eigen_ratios=[RATIO] * 4)
    W64 = A3B_CORRIDOR[0]
    bs64 = [bucket_to_device(b, dtype=torch.float64, device=dev)
            for b in vm.buckets]
    g64 = [build_banded_groups(fa, W64, block=A3B_BLOCK, aligned=True)
           for fa in bs64]
    rec["kernels_f64"] = _group_kernels(
        torch, kern, results, "a3b-kernels-f64", g64,
        torch.as_tensor(sc.R_true, dtype=torch.float64, device=dev),
        torch.as_tensor(sc.p_true, dtype=torch.float64, device=dev),
        f64=True)
    rec["kernels_f64"]["groups"] = _group_info(g64)


def _a3b_aligned(torch, dev, rec, paths, bs, R, p, W):
    """[a3b-2c-aligned]: stage 1's LM on path 2c's map with
    lm.BANDED_ALIGNED against the gather layout's (_a3b_lm), then the
    no-(6W)²-operand check on the aligned plan."""
    from global_lvba_tpu_torch.factors.plane_eigen import (
        banded_plan, build_banded_groups)
    from global_lvba_tpu_torch.solver import lm as lm_mod

    def switch(on):
        lm_mod.BANDED_ALIGNED = on

    rec["aligned_lm"], paths["a3b-aligned"] = _a3b_lm(
        torch, "a3b-2c-aligned", bs, R, p, LARGE_LM_ITERS, {}, {},
        "split-banded", "split-banded-aligned", setup=switch)
    if not all(paths["a3b-aligned"][k] > 0 for k in A3B_ALIGNED_KERNELS):
        _fail(f"a3b-2c-aligned: a kernel of the aligned banded path was "
              f"never launched: {paths['a3b-aligned']}")
    plan = banded_plan([build_banded_groups(fa, W, aligned=True)
                        for fa in bs], W)
    rec["aligned_largest_operand"] = _no_dense_operand(
        torch, "a3b-2c-aligned", plan, R, p, W,
        torch.full((), 0.01, dtype=R.dtype, device=dev))


# ---- phase 20 [native]: the native host runtime and the card's z-buffer ----
NATIVE_LZF_FRAMES = 10     # path 2a frames written as binary_compressed PCDs
ZBUF_SHARE = 1e-3          # pixels off _zbuffer_host by > 1e-6, per image

# phase 21, images from files: make_plane_scene's box room rendered through
# the reference camera unscaled (1280 x 1024) from a sideways path of
# IMAGES_VIEWS views (models/synthetic.room_views: IMAGES_STEP a view, 2 m
# from the wall, about 4.3 degrees of parallax a view for track fusion's
# 8-degree rule), every IMAGES_BMP_EVERY-th a 24-bit BMP (the first an RLE8
# one), two PNG views a CMYK and an arithmetic-coded JPEG, one baseline
# JPEG view cut at IMAGES_CUT of its bytes with no EOI (a killed recorder's
# file: libjpeg's recovery, its top half held to the render); IMAGES_FRAMES
# LiDAR frames of IMAGES_PPF points; the configuration at the reference
# scale 0.5 (640 x 512), float32, the COLMAP export on
IMAGES_VIEWS = 48
IMAGES_STEP = 0.15         # metres a view: 7.05 m of path, 4.3 degrees
IMAGES_TEXTURE = 32.0      # cycles/m: phase 10's 16 at its 4 m, here at 2 m
IMAGES_FRAMES = 96
IMAGES_PPF = 10000
IMAGES_BMP_EVERY = 8
IMAGES_JPEG_EVERY = 3      # of the views not BMP: 14 of the 48
IMAGES_JPEG_PSNR_DB = 40.0  # a JPEG view against the array encoded
IMAGES_CUT = 0.8           # of the cut JPEG view's bytes kept
IMAGE_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "images"
IMAGES_SETTINGS = {
    "window_ba": dict(size=6, anchor_leaf_size=0.02, use_window_ba_rel=True),
    "BALM_stage1": dict(root_voxel_size=1.0, eigen_ratio_array=[0.2] * 4),
    "BALM_stage2": dict(root_voxel_size=0.5, eigen_ratio_array=[0.08] * 4),
    "solver": dict(dtype="float32"),
    "colmap_output": dict(enable=True, filter_size_points3D=0.05),
}
TOL_TRANSFORM_REL = 1e-14  # transform_points vs einsum, of max |w|
TOL_MOMENTS_REL = 1e-12    # bin_moments vs reduceat, of each max |.|


def _lzf_compress(data: bytes) -> bytes:
    """A greedy LZF encoder (liblzf's scheme): the last earlier position of
    each 3-byte string in a table; a match of at least 3 bytes within 8,192
    back (at most 264 long) becomes a back reference, the rest literal
    runs of at most 32 bytes."""
    out = bytearray()
    last = {}
    n = len(data)
    lit = i = 0

    def literals(end):
        for a in range(lit, end, 32):
            run = data[a:min(a + 32, end)]
            out.append(len(run) - 1)
            out.extend(run)

    while i + 2 < n:
        key = data[i:i + 3]
        j = last.get(key)
        last[key] = i
        if j is None or i - j > 8192:
            i += 1
            continue
        k = 3
        while i + k < n and k < 264 and data[j + k] == data[i + k]:
            k += 1
        literals(i)
        off, ln = i - j - 1, k - 2
        if ln < 7:
            out.append((ln << 5) | (off >> 8))
        else:
            out += bytes(((7 << 5) | (off >> 8), ln - 7))
        out.append(off & 0xFF)
        i += k
        lit = i
    literals(n)
    return bytes(out)


def _write_compressed_pcd(path, pts, fields=("x", "y", "z", "intensity")):
    """A binary_compressed PCD of pts (N, len(fields)) float32 in PCL's
    layout (each field's column in turn, LZF-compressed, behind the
    compressed and the raw size): returns (payload, compressed)."""
    import numpy as np

    pts = np.asarray(pts, np.float32)
    n = pts.shape[0]
    k = len(fields)
    payload = b"".join(np.ascontiguousarray(pts[:, j]).tobytes()
                       for j in range(k))
    comp = _lzf_compress(payload)
    head = (f"# .PCD v0.7\nVERSION 0.7\nFIELDS {' '.join(fields)}\n"
            f"SIZE {' '.join(['4'] * k)}\nTYPE {' '.join(['F'] * k)}\n"
            f"COUNT {' '.join(['1'] * k)}\nWIDTH {n}\nHEIGHT 1\n"
            f"VIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary_compressed\n")
    Path(path).write_bytes(
        head.encode("ascii")
        + np.array([len(comp), len(payload)], "<u4").tobytes() + comp)
    return payload, comp


def _in_turns(fn, order=("numpy", "native", "native", "numpy")):
    """fn(host) for each host path in turn: {path: [s, s]} and the first
    result of each."""
    secs, first = collections.defaultdict(list), {}
    for host in order:
        t0 = time.time()
        out = fn(host)
        secs[host].append(time.time() - t0)
        first.setdefault(host, out)
    return dict(secs), first


def _native_zbuffer(torch, np, dev, kern, rec, js):
    """[native-zbuffer]: phase 16's depth stage on the card and in numpy:
    the numpy stage (grid map, _zbuffer_host an image on 4 threads), the
    card's (native keys, image_ranges, one launch), its parts timed; the
    kernel against zbuffer_plain on the card (a), against the numpy maps
    image by image (b), against itself (c); its kernels-line entry.
    Returns the depth stage's numbers."""
    from torch.profiler import ProfilerActivity, profile

    from global_lvba_tpu_torch.kernels.zbuffer import (
        work, zbuffer, zbuffer_plain)
    from global_lvba_tpu_torch.pipeline import depth

    e = KEEP["e2e"]
    clouds, lid, Rcw, tcw = e["clouds"], e["lid"], e["Rcw"], e["tcw"]
    sc, cam, M = js.lidar, js.cam, len(js.image_times)
    grid_s, gms = _in_turns(lambda host: depth.build_grid_map(
        clouds, lid.R_opt, lid.p_opt, device=dev if host == "native"
        else "cpu"))
    gm_np, gm = gms["numpy"], gms["native"]
    t0 = time.time()
    maps_np = depth.render_depth_maps(cam, gm_np, sc.times, js.image_times,
                                      Rcw, tcw, device="cpu")
    render_np_s = time.time() - t0
    same_grid = all(np.array_equal(getattr(gm, f), getattr(gm_np, f))
                    for f in ("keys", "starts", "counts", "points")) and all(
        np.array_equal(a, b) for a, b in zip(gm.frame_voxel_keys,
                                             gm_np.frame_voxel_keys))
    t0 = time.time()
    maps_card = depth.render_depth_maps(cam, gm, sc.times, js.image_times,
                                        Rcw, tcw, device=dev)
    render_s = time.time() - t0
    # the card stage's parts: host ranges, upload, kernel, copy back
    t0 = time.time()
    starts, counts, offsets = depth.image_ranges(gm, sc.times,
                                                 js.image_times)
    ranges_s = time.time() - t0
    t0 = time.time()
    args = [torch.as_tensor(a).to(dev) for a in (
        np.ascontiguousarray(gm.points, np.float32), starts, counts, offsets,
        np.asarray(Rcw, np.float64), np.asarray(tcw, np.float64))]
    torch.cuda.synchronize()
    upload_s = time.time() - t0
    maps = zbuffer(*args, cam)
    torch.cuda.synchronize()
    t0 = time.time()
    host = maps.cpu().numpy()
    copy_s = time.time() - t0
    same_path = (np.array_equal(maps_card, host)
                 and np.array_equal(host, e["maps"]))
    # (a) the plain version on the card, (c) the kernel again
    ref = zbuffer_plain(*args, cam)
    again = zbuffer(*args, cam)
    torch.cuda.synchronize()
    bit_a = bool(torch.equal(maps, ref))
    share_a = float((maps != ref).double().mean())
    err = float((maps - ref).abs().max())
    bit_c = bool(torch.equal(maps, again))
    # (b) the numpy maps, image by image
    shares = np.array([np.mean(np.abs(host[i] - maps_np[i]) > 1e-6)
                       for i in range(M)])
    bit_b = bool(np.array_equal(host, maps_np))
    del ref, again
    # the cull: the kernel's kept (piece, image) pairs and their points
    # against its plain mirror; a call reads nothing back
    kept = torch.zeros(2, dtype=torch.int64, device=dev)
    zbuffer(*args, cam, stats=kept)
    w = work(*args, cam)
    kept = kept.tolist()
    same_cull = kept == [w["kept"], w["kept_points"]]
    _, syncs = _count_syncs(torch, lambda: zbuffer(*args, cam))
    # a call's device time (the sort of the pairs, the launch) and its
    # kernels' under the profiler
    ms, ahead = _timed(torch, lambda: zbuffer(*args, cam))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            zbuffer(*args, cam)
        torch.cuda.synchronize()
    z_kern = [x for k_, x in _device_ms(prof).items()
              if "zbuffer" in k_ or "Memset" in k_]
    k_ms = sum(x[0] for x in z_kern) / 3 if z_kern else None
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    zbuffer_plain(*args, cam)
    ev[1].record()
    torch.cuda.synchronize()
    plain_ms = ev[0].elapsed_time(ev[1])
    n_proj, n_front, ops = w["covisible"], w["in_front"], w["ops"]
    nbytes = w["nbytes"]
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    # the Z row of every point in a (piece, image) pair the cull keeps, a
    # point in front the rest of the projection; none of it fused, so each
    # operation takes an FMA's issue slot: half the data sheet's rates,
    # which count an FMA as two
    to = max(ops[0] / (FP32_FLOP_PER_S / 2),
             ops[1] / (FP64_FLOP_PER_S / 2)) * 1e3
    bound = (tb, "bytes") if tb >= to else (to, "operations")
    kern["zbuffer"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           library_ms=None, bound=bound,
                           queued_ahead={"ms": ahead},
                           kernel_device_ms=k_ms)
    stage = dict(numpy=dict(grid_s=grid_s["numpy"], render_s=render_np_s),
                 card=dict(grid_s=grid_s["native"], render_s=render_s,
                           ranges_s=ranges_s, upload_s=upload_s,
                           kernel_ms=ms, copy_s=copy_s),
                 covisible_points=n_proj, in_front=n_front, ops=ops,
                 ranges=int(starts.shape[0]),
                 grid_points=int(gm.points.shape[0]), images=M,
                 bytes=nbytes, bound=bound, bound_ops_ms=to,
                 bound_bytes_ms=tb, l2_bytes=w["l2_bytes"],
                 pieces=w["pieces"], pairs=w["pairs"], culled=w["culled"],
                 kept_points=w["kept_points"], kernel_device_ms=k_ms,
                 syncs=syncs)
    rec["zbuffer"] = dict(stage=stage, bitwise_plain=bit_a,
                          share_plain=share_a, max_abs_err=err,
                          bitwise_numpy=bit_b, worst_share_numpy=float(
                              shares.max()), repeat_bitwise=bit_c,
                          grid_equal=same_grid, maps_equal=same_path,
                          cull_equal=same_cull)
    print(f"[native-zbuffer] {M} images, {n_proj} covisible points "
          f"({n_front} in front of the camera) in {starts.shape[0]} ranges "
          f"over {gm.points.shape[0]} grid points: "
          f"grid map in turns (numpy, native, native, numpy) {grid_s} s; "
          f"numpy maps {render_np_s:.3f} s; card maps {render_s:.3f} s "
          f"(host ranges {ranges_s:.3f} s, upload "
          f"{upload_s:.3f} s, a call {ms:.4f} ms device time (queued "
          f"ahead {ahead}), its kernels under torch.profiler "
          f"{k_ms} ms, copy back {copy_s:.3f} s); plain on the card "
          f"{plain_ms:.1f} ms", flush=True)
    print(f"[native-zbuffer] the cull: {w['pieces']} pieces, {w['pairs']} "
          f"(piece, image) pairs, {w['culled']} culled; the kernel kept "
          f"{kept[0]} pairs of {kept[1]} points, its plain mirror "
          f"{w['kept']} of {w['kept_points']} ({same_cull}); {syncs} "
          f"synchronizing calls a call; bound {bound[0]:.4f} ms "
          f"({bound[1]}): {ops[0]} float32 and {ops[1]} float64 operations "
          f"at half the data sheet's rates {to:.4f} ms, {nbytes / 1e6:.1f} "
          f"MB once {tb:.4f} ms; the design's L2 bytes "
          f"{w['l2_bytes'] / 1e6:.1f} MB", flush=True)
    print(f"[native-zbuffer] (a) kernel vs zbuffer_plain on the card: "
          f"bitwise {bit_a} (differing share {share_a:.3e}, max abs "
          f"{err:.3e}); (b) vs numpy _zbuffer_host: bitwise {bit_b}, worst "
          f"image's share off by > 1e-6 {shares.max():.3e} (limit "
          f"{ZBUF_SHARE}); (c) two launches bitwise {bit_c}; native grid map "
          f"== numpy's {same_grid}; render_depth_maps' maps == this launch's "
          f"== phase 16's {same_path}", flush=True)
    if not (same_grid and same_path and bit_c and shares.max() < ZBUF_SHARE
            and (bit_a or share_a < ZBUF_SHARE) and same_cull
            and syncs == 0):
        _fail("[native-zbuffer]: the card's depth maps miss their checks")
    return stage


def _native_host(torch, np, dev, rec, js):
    """[native-host]: each host entry point against its numpy path at path
    2a's 2.0 M points (the transform, keys, argsort, segment moments),
    build_voxel_map over path 2a's recorded builds and the plane lookup in
    turns, build_components on ladder 3's match graph, LZF on
    binary_compressed PCDs of path 2a frames.  Returns the times."""
    import shutil

    from global_lvba_tpu_torch.io import pcd
    from global_lvba_tpu_torch.map import voxelize
    from global_lvba_tpu_torch.native import runtime
    from global_lvba_tpu_torch.pipeline import visual_ba
    from global_lvba_tpu_torch.tracks import build as tbuild

    host_of = {"numpy": "cpu", "native": dev}
    pts_b, fids, Ra, pa = KEEP["2a"]
    pts = np.asarray(pts_b, np.float64)
    fid = np.asarray(fids, np.int32)
    t = {}
    t0 = time.time()
    w_np = np.einsum("nij,nj->ni", Ra[fid], pts) + pa[fid]
    t["transform"] = [time.time() - t0]
    t0 = time.time()
    w = runtime.transform_points(pts, fid, Ra, pa)
    t["transform"].append(time.time() - t0)
    e_w = float(np.abs(w - w_np).max() / np.abs(w_np).max())
    t0 = time.time()
    k_np = voxelize.pack_voxel_keys(voxelize.voxel_coords(w_np, VOXEL))
    t["keys"] = [time.time() - t0]
    t0 = time.time()
    k = runtime.voxel_keys64(w_np, VOXEL)
    t["keys"].append(time.time() - t0)
    keys_eq = bool(np.array_equal(k, k_np))
    flips = int((runtime.voxel_keys64(w, VOXEL) != k_np).sum())
    t0 = time.time()
    o_np = np.argsort(k_np, kind="stable")
    t["argsort"] = [time.time() - t0]
    t0 = time.time()
    o = runtime.radix_argsort(k_np)
    t["argsort"].append(time.time() - t0)
    sort_eq = bool(np.array_equal(o, o_np))
    sk = k_np[o_np]
    starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
    t0 = time.time()
    _, s_np, m_np = voxelize._reduceat_moments(w_np, o_np, starts)
    t["moments"] = [time.time() - t0]
    t0 = time.time()
    s_n, m_n = runtime.bin_moments(w_np, o_np, starts)
    t["moments"].append(time.time() - t0)
    e_s = max(float(np.abs(s_n[:, c] - s_np[:, c]).max()
                    / np.abs(s_np[:, c]).max()) for c in range(3))
    e_m = max(float(np.abs(m_n[:, c] - m_np[:, c]).max()
                    / np.abs(m_np[:, c]).max()) for c in range(6))
    del w, w_np, k, k_np, o, o_np, sk, s_np, m_np, s_n, m_n
    print(f"[native-host] path 2a's {pts.shape[0]} points, numpy | native s: "
          f"{ {n: [round(x, 4) for x in v] for n, v in t.items()} }; "
          f"transform {e_w:.2e} of max |w| (tol {TOL_TRANSFORM_REL}); keys "
          f"exact {keys_eq}, keys of the native transform off numpy's: "
          f"{flips}; argsort exact {sort_eq}; {starts.shape[0]} voxels' "
          f"sums {e_s:.2e}, moments {e_m:.2e} of each max (tol "
          f"{TOL_MOMENTS_REL})", flush=True)
    # build_voxel_map over path 2a's own builds (20 windows, 2 stages)
    builds = KEEP["2a_builds"]
    cfg2a = _window_config("float32")

    def voxelize_2a(host):
        return [voxelize.build_voxel_map(
            *b, min_ps=cfg2a.solver.min_ps,
            layer_limit=cfg2a.solver.layer_limit, device=host_of[host])
            for b in builds]

    vox_s, vms = _in_turns(voxelize_2a)
    same_maps = all(
        a.num_planes == b.num_planes and all(
            np.array_equal(x, y) for x, y in zip(a.lookup.plane_keys,
                                                 b.lookup.plane_keys))
        for a, b in zip(vms["numpy"], vms["native"]))
    planes = sum(v.num_planes for v in vms["native"])
    del vms
    e = KEEP["e2e"]
    lookup_s, lks = _in_turns(lambda host: visual_ba.build_anchor_plane_lookup(
        e["clouds"], e["lid"].R_opt, e["lid"].p_opt, e["cfg"],
        device=host_of[host]))
    same_lookup = all(np.array_equal(x, y) for x, y in zip(
        lks["numpy"].plane_keys + lks["numpy"].subdiv_keys,
        lks["native"].plane_keys + lks["native"].subdiv_keys))
    print(f"[native-host] path 2a's voxelization ({len(builds)} "
          f"build_voxel_map calls, in turns numpy, native, native, numpy): "
          f"{vox_s} s, {planes} planes, plane counts and keys equal "
          f"{same_maps}; the plane lookup of phase 16's stage {lookup_s} s, "
          f"keys equal {same_lookup}", flush=True)
    # the track build on ladder 3's match graph
    comp_s, ts = _in_turns(lambda host: tbuild.build_components(
        js.keypoints, js.matches, obser_thr=e["cfg"].track_fusion.obser_thr,
        device=host_of[host]), order=("numpy", "native"))

    def rows(tr):
        return sorted(map(tuple, np.concatenate(
            [tr.obs_img, tr.obs_kp], axis=1).tolist()))

    same_tracks = (rows(ts["numpy"]) == rows(ts["native"])
                   and ts["numpy"].stats == ts["native"].stats)
    # LZF: binary_compressed PCDs of path 2a's first frames
    work = Path(__file__).resolve().parent / "build" / "native_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.time()
    files = []
    for i in range(NATIVE_LZF_FRAMES):
        c = np.asarray(pts_b[fids == i], np.float32)
        ring = (np.arange(c.shape[0]) % 16).astype(np.float32)
        cloud = np.c_[c, ring]
        files.append((work / f"{i}.pcd", cloud, *_write_compressed_pcd(
            work / f"{i}.pcd", cloud)))
    enc_s = time.time() - t0
    lzf_s = 0.0
    same_lzf = True
    nbytes = 0
    for path, cloud, payload, comp in files:
        nbytes += len(payload)
        t0 = time.time()
        out = pcd._lzf_decompress(comp, len(payload))
        lzf_s += time.time() - t0
        same_lzf &= out == payload and np.array_equal(
            pcd.read_pcd(path), cloud)
    shutil.rmtree(work, ignore_errors=True)
    print(f"[native-host] build_components on ladder 3's match graph "
          f"(numpy, native) {comp_s} s, the same tracks {same_tracks}; LZF "
          f"over {len(files)} binary_compressed PCDs ({nbytes} bytes, "
          f"encoded in {enc_s:.2f} s): decoded in {lzf_s:.4f} s, the "
          f"payloads byte-equal and read_pcd's clouds equal {same_lzf}",
          flush=True)
    rec["host"] = dict(points=int(pts.shape[0]), entry_s=t,
                       transform_rel=e_w, keys_exact=keys_eq,
                       key_flips=flips, argsort_exact=sort_eq,
                       sums_rel=e_s, moments_rel=e_m,
                       voxelize_2a_s=vox_s, voxelize_2a_equal=same_maps,
                       lookup_s=lookup_s, lookup_equal=same_lookup,
                       components_s=comp_s, components_equal=same_tracks,
                       lzf_s=lzf_s, lzf_bytes=nbytes, lzf_equal=same_lzf)
    if not (keys_eq and sort_eq and e_w <= TOL_TRANSFORM_REL
            and e_s <= TOL_MOMENTS_REL and e_m <= TOL_MOMENTS_REL
            and same_maps and same_lookup and same_tracks and same_lzf):
        _fail("[native-host]: a host entry point disagrees with its numpy "
              "path")


def _native_system(torch, np, rec, js, R_odom, p_odom):
    """[native-system]: phase 17's run A again, its host paths and depth
    maps numpy (native.on_device patched to False, render_depth_maps sent
    to the CPU) and then native (the library, the z-buffer kernel), in
    one process on the card: each run's wall and stages."""
    import shutil

    from global_lvba_tpu_torch import native
    from global_lvba_tpu_torch.config import LvbaConfig
    from global_lvba_tpu_torch.pipeline import system, visual_ba

    work = Path(__file__).resolve().parent / "build" / "native_system"
    shutil.rmtree(work, ignore_errors=True)
    cfg_path = _write_ladder3(np, work, js, R_odom, p_odom)
    on_device, render = native.on_device, visual_ba.render_depth_maps
    runs = {}
    for host in ("numpy", "native"):
        if host == "numpy":
            native.on_device = lambda d: False
            visual_ba.render_depth_maps = lambda *a, **k: render(
                *a, **{**k, "device": "cpu"})
        try:
            t0 = time.time()
            s = system.LvbaSystem(LvbaConfig.from_yaml(cfg_path),
                                  out_dir=work / host)
            res = s.run_full_pipeline()
            torch.cuda.synchronize()
            wall = time.time() - t0
        finally:
            native.on_device, visual_ba.render_depth_maps = on_device, render
        m = res["metrics"]
        runs[host] = dict(
            wall_s=wall, stages={k: m[k] for k in m if k.startswith("time/")},
            visual={k: s.visual_result.stats[k] for k in (
                "depth_s", "fuse_s", "planes_s", "solve_s")},
            reproj=[s.visual_result.mean_reproj_pre,
                    s.visual_result.mean_reproj_post])
    shutil.rmtree(work, ignore_errors=True)
    rec["system"] = runs
    print(f"[native-system] LvbaSystem run A on ladder 3, its host paths "
          f"numpy then native: {runs}", flush=True)
    post = [r["reproj"][1] for r in runs.values()]
    if not (max(post) < 1.0 and abs(post[0] - post[1]) <= TOL_E2E_POST
            * post[0]):
        _fail("[native-system]: the two runs' post-BA reprojections differ")


def _native(torch, np, dev, kern, results, js, R_odom, p_odom):
    """Phase 20, [native]: the native host runtime and the card's z-buffer
    at ladder 3's and path 2a's sizes (_native_zbuffer, _native_host,
    _native_system)."""
    rec = results["native"] = {}
    _native_zbuffer(torch, np, dev, kern, rec, js)
    _native_host(torch, np, dev, rec, js)
    _native_system(torch, np, rec, js, R_odom, p_odom)



def _jpeg_size(data: bytes):
    """(width, height, baseline) from a JPEG's first SOF marker."""
    k = 2
    while k + 4 <= len(data) and data[k] == 0xFF:
        m, n = data[k + 1], data[k + 2] * 256 + data[k + 3]
        if m in (0xC0, 0xC1, 0xC2):
            h = data[k + 5] * 256 + data[k + 6]
            w = data[k + 7] * 256 + data[k + 8]
            return w, h, m == 0xC0
        k += 2 + n
    return None


def _pcd_points(path) -> int:
    for line in path.read_bytes().split(b"\n")[:12]:
        if line.startswith(b"POINTS"):
            return int(line.split()[1])
    return -1


def _image_fixtures(np):
    """The committed cv2 fixtures decoded by the port: ({file: bit for bit
    cv2's colour, gray and unchanged decodes (dtype too), load_depth_png
    the unchanged one in float32 over 2000 and over 1000, and a
    ValueError where cv2 read nothing that way}, {file: (height, width,
    ms of its first decode)}).  Every image file of the folder counts, so
    one that cv2 reads in no way (filter64.png) must raise in every way."""
    from global_lvba_tpu_torch.io.image import (
        imread_color, imread_gray, imread_unchanged)
    from global_lvba_tpu_torch.pipeline.outputs import load_depth_png

    ref = np.load(IMAGE_FIXTURES / "decodes.npz")
    names = sorted(p.name for p in IMAGE_FIXTURES.iterdir()
                   if p.suffix in (".png", ".jpg", ".bmp"))
    same, ms = {}, {}
    for name in names:
        ok = True
        for kind, read in (("color", imread_color), ("gray", imread_gray),
                           ("unchanged", imread_unchanged)):
            key = f"{name}:{kind}"
            t0 = time.perf_counter()
            try:
                img = read(IMAGE_FIXTURES / name)
            except ValueError:
                ok &= key not in ref.files
                continue
            dt = (time.perf_counter() - t0) * 1e3
            ok &= (key in ref.files and img.dtype == ref[key].dtype
                   and bool(np.array_equal(img, ref[key])))
            ms.setdefault(name, (img.shape[0], img.shape[1], dt))
        key = f"{name}:unchanged"
        for scale in (2000.0, 1000.0):
            try:
                depth = load_depth_png(IMAGE_FIXTURES / name, scale)
            except ValueError:
                ok &= key not in ref.files
                continue
            ok &= key in ref.files and bool(np.array_equal(
                depth, ref[key].astype(np.float32) / scale))
        same[name] = bool(ok)
    return same, ms


def _images(torch, np, dev, kern, results, paths):
    """Phase 21, [images]: the box room as a dataset of image files with no
    COLMAP db under build/images_smoke/ (removed after), decoded by the
    port, then LvbaSystem.run_full_pipeline on the card with the launch
    counts from 0: the SIFT fallback from the files (kernel 6), the LiDAR
    kernels, one undistort launch and two colorize launches; the output
    tree checked; undistort and colorize against their plain versions on
    the card, bitwise, and against themselves; their times and bounds."""
    import shutil

    from torch.profiler import ProfilerActivity, profile

    from global_lvba_tpu_torch.config import LvbaConfig
    from global_lvba_tpu_torch.frontend.sift import (
        SiftParams, extract_sift_batch)
    from global_lvba_tpu_torch.geometry.camera import CameraModel
    from global_lvba_tpu_torch.io.image import (
        encode_jpeg, imread_color, imread_gray, resize_linear)
    from global_lvba_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    from global_lvba_tpu_torch.kernels.colorize import (
        COLORIZE_OPS, colorize, colorize_plain)
    from global_lvba_tpu_torch.kernels.undistort import (
        staging_route, undistort, undistort_bytes, undistort_map,
        undistort_plain, undistort_plan)
    from global_lvba_tpu_torch.models.synthetic import write_room_dataset
    from global_lvba_tpu_torch.pipeline import system
    from global_lvba_tpu_torch.pipeline.sift_frontend import (
        load_gray_image, match_and_compact)

    sys.path.insert(0, str(IMAGE_FIXTURES.parents[1]))
    # the tests' writers: the port writes no Adam7 PNG, CMYK or
    # arithmetic-coded JPEG and no RLE8 BMP
    import bmp_writer as bw
    import jpeg_writer as jw
    from png_writer import png

    rec = results["images"] = {}
    cm = LvbaConfig().cam_model
    cam_full = CameraModel(fx=cm.cam_fx, fy=cm.cam_fy, cx=cm.cam_cx,
                           cy=cm.cam_cy, k1=cm.cam_d0, k2=cm.cam_d1,
                           p1=cm.cam_d2, p2=cm.cam_d3, width=cm.cam_width,
                           height=cm.cam_height)
    work = Path(__file__).resolve().parent / "build" / "images_smoke"
    shutil.rmtree(work, ignore_errors=True)
    phase_t0 = t0 = time.time()
    cfg_path, bgr, sc, _ = write_room_dataset(
        work / "dataset", cam_full, cm.scale, IMAGES_VIEWS, IMAGES_FRAMES,
        IMAGES_PPF, seed=5, bmp_every=IMAGES_BMP_EVERY,
        texture=IMAGES_TEXTURE, settings=IMAGES_SETTINGS, device=dev,
        step=IMAGES_STEP, jpeg_every=IMAGES_JPEG_EVERY)
    # view 0 again as an Adam7 PNG
    first = sorted((work / "dataset" / "all_image").glob("*.png"))[0]
    first.write_bytes(png(np.ascontiguousarray(bgr[0][:, :, ::-1]), 2, 8,
                          (1,), interlace=1))
    write_s = time.time() - t0
    # two more PNG views as a CMYK JPEG and an arithmetic-coded progressive
    # JPEG (4:2:0), a BMP view as an RLE8 BMP of its 256-colour
    # quantisation, which is what it then decodes to, and the last baseline
    # JPEG view cut at IMAGES_CUT of its bytes, no EOI
    img_dir = work / "dataset" / "all_image"
    listed = sorted(f for f in img_dir.iterdir()
                    if f.suffix in (".png", ".bmp", ".jpg"))
    pngs = [f for f in listed if f.suffix == ".png" and f != first]
    special, expect, convert_s = {}, {}, {}
    for f, kd in ((pngs[0], "jpg_cmyk"), (pngs[len(pngs) // 2], "jpg_arith"),
                  (next(f for f in listed if f.suffix == ".bmp"),
                   "bmp_rle8"),
                  ([f for f in listed if f.suffix == ".jpg"][-1], "jpg_cut")):
        k = listed.index(f)
        t0 = time.perf_counter()
        if kd == "jpg_cut":
            whole = f.read_bytes()
            data = whole[:int(len(whole) * IMAGES_CUT)]
        elif kd == "jpg_cmyk":
            data = jw.lossy(jw.cmyk_from_bgr(bgr[k]), quality=95, adobe=0)
        elif kd == "jpg_arith":
            data = jw.lossy(jw.ycc_from_bgr(bgr[k]), quality=95,
                            coding="arith", progressive=True,
                            sampling=[(2, 2), (1, 1), (1, 1)])
        else:
            idx, pal = bw.quantize(bgr[k])
            data = bw.bmp(idx, 8, palette=pal, compression=bw.BI_RLE8)
            expect[k] = pal[idx]
        out = f.with_suffix(".bmp" if kd == "bmp_rle8" else ".jpg")
        f.unlink()
        out.write_bytes(data)
        special[out.name] = kd
        convert_s[kd] = time.perf_counter() - t0
    cfg = LvbaConfig.from_yaml(cfg_path)
    W, H = int(cm.cam_width * cm.scale), int(cm.cam_height * cm.scale)

    # ---- the files decode to the arrays written; decode and resize ms ----
    files = sorted((work / "dataset" / "all_image").iterdir())
    files = [f for f in files if f.suffix in (".png", ".bmp", ".jpg")]

    def kind(f):
        return "adam7" if f == first else special.get(f.name, f.suffix[1:])

    dec = {k: [] for k in ("png", "adam7", "bmp", "bmp_rle8", "jpg",
                           "jpg_gray", "jpg_cmyk", "jpg_cmyk_gray",
                           "jpg_arith", "jpg_arith_gray", "jpg_cut",
                           "jpg_cut_gray")}
    decoded, psnr, jpeg_twice = [], {}, True
    for k, f in enumerate(files):
        kd = kind(f)
        t0 = time.perf_counter()
        img = imread_color(f)
        dec[kd].append((time.perf_counter() - t0) * 1e3)
        decoded.append(img)
        if f.suffix == ".jpg":
            t0 = time.perf_counter()
            imread_gray(f)
            dec[kd + "_gray"].append((time.perf_counter() - t0) * 1e3)
            # the cut view's top half only: its data was kept
            rows = img.shape[0] // 2 if kd == "jpg_cut" else img.shape[0]
            err = img[:rows].astype(np.float64) - bgr[k][:rows]
            psnr.setdefault(kd, []).append(
                float(10 * np.log10(255.0 ** 2 / np.mean(err ** 2))))
            jpeg_twice &= bool(np.array_equal(imread_color(f), img))
    same_files = all(np.array_equal(a, expect.get(k, bgr[k]))
                     for k, (a, f) in enumerate(zip(decoded, files))
                     if f.suffix != ".jpg")
    n_kind = {k: len(v) for k, v in dec.items()}
    fixtures, fixture_ms = _image_fixtures(np)
    t0 = time.perf_counter()
    images = [resize_linear(img, W, H) for img in decoded]
    resize_ms = (time.perf_counter() - t0) * 1e3 / len(images)
    decode = {k: float(np.mean(v)) if v else float("nan")
              for k, v in dec.items()}
    min_psnr = {k: min(v) for k, v in psnr.items()}
    print(f"[images] {len(files)} files ({n_kind['png']} PNG, "
          f"{n_kind['adam7']} Adam7 PNG, {n_kind['jpg']} baseline JPEG, "
          f"{n_kind['jpg_cmyk']} CMYK JPEG, {n_kind['jpg_arith']} "
          f"arithmetic-coded progressive JPEG, {n_kind['jpg_cut']} baseline "
          f"JPEG cut at {IMAGES_CUT:.0%} of its bytes, {n_kind['bmp']} BMP, "
          f"{n_kind['bmp_rle8']} RLE8 BMP) of {cam_full.width} x "
          f"{cam_full.height} and {IMAGES_FRAMES} LiDAR frames of "
          f"{IMAGES_PPF} points written in {write_s:.1f} s (renders on the "
          f"card), the CMYK, arithmetic-coded and RLE8 views converted by "
          f"the tests' writers in "
          f"{', '.join(f'{k} {v:.2f} s' for k, v in convert_s.items())}; "
          f"resize to {W} x {H} {resize_ms:.1f} ms an image; every PNG and "
          f"BMP decodes to the array written: {same_files}; JPEG PSNR min "
          f"{min_psnr} dB (limit {IMAGES_JPEG_PSNR_DB}), two decodes "
          f"bitwise alike: {jpeg_twice}", flush=True)
    print(f"[images] decode ms at {cam_full.width} x {cam_full.height}, "
          f"colour (gray): PNG {decode['png']:.2f}, Adam7 PNG "
          f"{decode['adam7']:.2f}, baseline JPEG {decode['jpg']:.2f} "
          f"({decode['jpg_gray']:.2f}), baseline JPEG cut at "
          f"{IMAGES_CUT:.0%} {decode['jpg_cut']:.2f} "
          f"({decode['jpg_cut_gray']:.2f}; its top half "
          f"{min_psnr['jpg_cut']:.2f} dB), CMYK JPEG {decode['jpg_cmyk']:.2f} "
          f"({decode['jpg_cmyk_gray']:.2f}), arithmetic-coded progressive "
          f"JPEG {decode['jpg_arith']:.2f} ({decode['jpg_arith_gray']:.2f}), "
          f"BMP {decode['bmp']:.2f}, RLE8 BMP {decode['bmp_rle8']:.2f}",
          flush=True)
    print(f"[images] the {len(fixtures)} cv2 fixtures bit for bit (decode "
          f"ms of the first read at its size): " + ", ".join(
              f"{n} {fixtures[n]} ({fixture_ms[n][1]} x {fixture_ms[n][0]} "
              f"{fixture_ms[n][2]:.3f} ms)" if n in fixture_ms else
              f"{n} {fixtures[n]} (refused in every mode, as by cv2)"
              for n in sorted(fixtures)), flush=True)
    if not same_files:
        _fail("[images]: a decoded file differs from the array written")
    if not (n_kind["jpg"] >= 12 and n_kind["adam7"] == 1
            and n_kind["jpg_cmyk"] == 1 and n_kind["jpg_arith"] == 1
            and n_kind["bmp_rle8"] == 1 and n_kind["jpg_cut"] == 1
            and min(min_psnr.values()) >= IMAGES_JPEG_PSNR_DB
            and jpeg_twice):
        _fail("[images]: the JPEG views miss their checks, or the file mix "
              "is not the one planned")
    if not (fixtures and all(fixtures.values())):
        _fail(f"[images]: a committed fixture does not decode as cv2 "
              f"decoded it: {fixtures}")

    # ---- the main path: the system from the files ----
    spans = collections.defaultdict(float)
    sysA = system.LvbaSystem(cfg, out_dir=work / "out")
    load_frontend = sysA._load_frontend

    def frontend():
        t = time.time()
        try:
            return load_frontend()
        finally:
            torch.cuda.synchronize()
            spans["frontend_s"] = time.time() - t

    sysA._load_frontend = frontend
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.time()
    res = sysA.run_full_pipeline(images=images)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = paths["images"] = launch_counts()
    v = sysA.visual_result
    stages = {k: v_ for k, v_ in res["metrics"].items()
              if k.startswith("time/")}
    ex = dict(sysA.export_times)
    print(f"[images] LvbaSystem.run_full_pipeline {wall:.2f} s: frontend "
          f"(SIFT from the files, all pairs) {spans['frontend_s']:.2f} s, "
          f"stages { {k: round(x, 3) for k, x in stages.items()} }, export "
          f"{ {k: round(x, 4) for k, x in ex.items()} }; reprojection "
          f"{v.mean_reproj_pre:.4f} -> {v.mean_reproj_post:.4f} px; tracks "
          f"{v.stats['tracks_fused']} (with plane "
          f"{v.stats['tracks_with_plane']}), observations "
          f"{v.stats['observations']}; launches {counts}", flush=True)
    lidar_ok = (all(counts.get(k, 0) > 0 for k in BUCKETED_PATH_KERNELS)
                or all(counts.get(k, 0) > 0 for k in ALIGNED_PATH_KERNELS))
    if not (counts.get("top2_similarity", 0) > 0 and lidar_ok
            and counts.get("undistort") == 1 and counts.get("colorize") == 2):
        _fail(f"[images]: the path's launches miss a kernel: {counts}")
    if not (v.mean_reproj_post < v.mean_reproj_pre
            and v.mean_reproj_post < 1.0):
        _fail("[images]: the post-BA reprojection is not below the pre-BA "
              "one and 1 px")

    # ---- the output tree ----
    out = work / "out"
    cdir = out / "Colmap"
    jpgs = sorted((cdir / "images").glob("*.jpg"),
                  key=lambda q: int(q.stem))
    sizes = [_jpeg_size(q.read_bytes()) for q in jpgs]
    stack = torch.from_numpy(np.stack(images)).to(dev)
    und = undistort(stack, sysA.ds.cam)
    again = encode_jpeg(und.cpu().numpy())
    jpeg_same = len(again) == len(jpgs) and all(
        a == q.read_bytes() for a, q in zip(again, jpgs))
    n_after = _pcd_points(cdir / "colored_merged_after.pcd")
    n_before = _pcd_points(cdir / "colored_merged_before.pcd")
    n_p3d = len((cdir / "sparse" / "points3D.txt").read_text().splitlines())
    pngs = sorted((out / "reproj").glob("*.png"))
    tracks = sorted((out / "track_features").glob("*.png"))
    png_ok = all(imread_color(q).shape == (H, W, 3) for q in pngs + tracks)
    tree_ok = (len(jpgs) == IMAGES_VIEWS and jpeg_same
               and all(sz == (W, H, True) for sz in sizes) and n_after > 0
               and n_before > 0 and n_p3d == n_after and len(pngs) > 0
               and len(tracks) == IMAGES_VIEWS and png_ok)
    print(f"[images] tree: {len(jpgs)} JPEGs (SOF0 {W} x {H}: "
          f"{all(sz == (W, H, True) for sz in sizes)}; a second encode "
          f"byte-equal: {jpeg_same}), colored clouds after {n_after} / "
          f"before {n_before} points, points3D.txt {n_p3d} lines, reproj "
          f"{len(pngs)} and track_features {len(tracks)} PNGs decoded at "
          f"{W} x {H}: {png_ok}", flush=True)
    if not tree_ok:
        _fail("[images]: the output tree misses its checks")

    # ---- SIFT device ms per image, all-pairs match ms ----
    params = SiftParams()
    gray = np.stack([load_gray_image(f, W, H) for f in files])
    batch = torch.as_tensor(gray[:FRONTEND_BATCH]).to(dev)
    sift_ms, _ = _timed(torch, lambda: extract_sift_batch(batch, params,
                                                          dev), reps=3)
    sift_ms /= FRONTEND_BATCH
    from global_lvba_tpu_torch.pipeline.sift_frontend import extract_images
    kps, descs, valids = extract_images(list(gray), params, device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    match_and_compact(kps, descs, valids, device=dev)
    torch.cuda.synchronize()
    match_ms = (time.time() - t0) * 1e3
    print(f"[images] SIFT {sift_ms:.2f} device ms an image at {W} x {H} "
          f"(a batch of {FRONTEND_BATCH} timed); all {len(files) * (len(files) - 1) // 2} "
          f"pairs matched in {match_ms:.1f} ms wall", flush=True)

    # ---- undistort: bitwise its plain version and itself; timed ----
    cam = sysA.ds.cam
    ref = undistort_plain(stack, cam)
    und2 = undistort(stack, cam)
    torch.cuda.synchronize()
    u_bit = bool(torch.equal(und, ref))
    u_rep = bool(torch.equal(und, und2))
    u_err = float((und.int() - ref.int()).abs().max())
    del ref, und2
    u_route = staging_route(stack)
    u_plan = undistort_plan(cam, W, H, dev)
    u_ms, u_ahead = _timed(torch, lambda: undistort(stack, cam))
    u_plain, _ = _timed(torch, lambda: undistort_plain(stack, cam), reps=2)
    # the kernel's other routes, each one launch bitwise its plain version:
    # k1 = -0.4 puts corner tiles over the box cap (their taps from global
    # memory), on the TMA route (W % 16 == 0) and on the global route (an
    # odd width and height); phase 21's stack one byte past a 16-byte
    # boundary takes the global route at full size, timed
    u_paths = {}
    strong = cam._replace(k1=-0.4)
    off = torch.empty(stack.numel() + 16, dtype=torch.uint8, device=dev)
    lead = (1 - off.data_ptr()) % 16
    off = off[lead:lead + stack.numel()].view(stack.shape)
    off.copy_(stack)
    for tag, ucam, imgs in (
            ("tma, tiles over the cap", strong, None),
            ("global, tiles over the cap",
             strong.scaled(0.5)._replace(width=333, height=257), None),
            ("global, phase 21's stack one byte off", cam, off)):
        if imgs is None:
            imgs = torch.randint(
                0, 256, (3, ucam.height, ucam.width, 3), dtype=torch.uint8,
                device=dev, generator=torch.Generator(dev).manual_seed(21))
        uplan = undistort_plan(ucam, ucam.width, ucam.height, dev)
        before = launch_counts()["undistort"]
        got = undistort(imgs, ucam)
        launches = launch_counts()["undistort"] - before
        ok = bool(torch.equal(got, undistort_plain(imgs, ucam)))
        u_paths[tag] = dict(route=staging_route(imgs), bitwise=ok,
                            launches=launches, staged=uplan.staged,
                            tiles=int(uplan.tiles.shape[0]),
                            box=(uplan.pitch, uplan.rows))
        if imgs is off:
            u_paths[tag]["ms"] = _timed(torch, lambda: undistort(off, cam))[0]
    del off, got
    print(f"[images] undistort's routes: phase 21's stack {u_route}, box "
          f"{u_plan.pitch} bytes x {u_plan.rows} rows, {u_plan.staged} of "
          f"{u_plan.tiles.shape[0]} tiles staged; {u_paths}", flush=True)
    paths_ok = all(v["bitwise"] and v["launches"] == 1
                   for v in u_paths.values()) and all(
        v["staged"] < v["tiles"] for k, v in u_paths.items()
        if "over the cap" in k)
    if not paths_ok or {v["route"] for v in u_paths.values()} | {
            u_route} != {"tma", "global"}:
        _fail("[images]: an undistort route is not bitwise its plain "
              "version in one launch, or a route did not run")
    # the nearest library call: float bilinear sampling of the same images
    # at the map's positions (grid_sample; not the same function)
    xy, frac = undistort_map(cam, W, H)
    gx = (xy[..., 0] + (frac & 31) / 32.0 + 0.5) / W * 2 - 1
    gy = (xy[..., 1] + (frac >> 5) / 32.0 + 0.5) / H * 2 - 1
    grid = torch.as_tensor(np.stack([gx, gy], -1), dtype=torch.float32,
                           device=dev)[None].expand(len(images), H, W, 2)
    fimg = stack.permute(0, 3, 1, 2).float().contiguous()
    lib_ms, _ = _timed(torch, lambda: torch.nn.functional.grid_sample(
        fimg, grid, mode="bilinear", padding_mode="zeros",
        align_corners=False))
    nbytes = undistort_bytes(len(images), H, W)
    u_bound = (nbytes / HBM_BYTES_PER_S * 1e3, "bytes")

    # ---- colorize: the run's two clouds' picks, bitwise; timed ----
    world = np.concatenate([(sysA.R_opt[i] @ sysA.ds.clouds[i].T).T
                            + sysA.p_opt[i]
                            for i in range(len(sysA.ds.clouds))]).astype(
        np.float64)
    sizes_f = np.array([c.shape[0] for c in sysA.ds.clouds], np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes_f)])
    lt, it = np.asarray(sysA.ds.lidar_times), np.asarray(
        sysA.ds.image_times)
    lo = np.searchsorted(lt, it - 0.5, side="left")
    hi = np.searchsorted(lt, it + 0.5, side="right")
    lo, hi = offs[lo], np.where(hi > lo, offs[hi], offs[lo])
    pts = torch.from_numpy(np.ascontiguousarray(world)).to(dev)
    lo_t, hi_t = torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev)
    args = (pts, lo_t, hi_t, v.Rcw, v.tcw, cam)
    a = colorize(*args)
    b = colorize(*args)
    pl = colorize_plain(*args)
    torch.cuda.synchronize()
    c_bit = all(torch.equal(x, y) for x, y in zip(a, pl))
    c_rep = all(torch.equal(x, y) for x, y in zip(a, b))
    c_err = 0.0 if c_bit else float("inf")
    picks = int(a[0].numel())
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    colorize(*args)
    ev[1].record()
    colorize_plain(*args)
    ev[2].record()
    torch.cuda.synchronize()
    c_ms, c_plain = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    # one read back a call: the pick count and the kernel's status
    _, c_syncs = _count_syncs(torch, lambda: colorize(*args))
    n_win = int((hi - lo).sum())
    c_ops = COLORIZE_OPS * n_win
    c_bytes = world.nbytes + len(it) * 112 + picks * 32
    c_to = c_ops / (FP64_FLOP_PER_S / 2) * 1e3
    c_tb = c_bytes / HBM_BYTES_PER_S * 1e3
    c_bound = (c_to, "operations") if c_to >= c_tb else (c_tb, "bytes")

    # ---- each kernel's own device time under torch.profiler ----
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            undistort(stack, cam)
            colorize(*args)
        torch.cuda.synchronize()
    dms = _device_ms(prof)
    u_kern = [x for k_, x in dms.items() if "undistort_kernel" in k_]
    c_kern = [x for k_, x in dms.items() if "colorize" in k_]
    u_dev = u_kern[0][0] / u_kern[0][1] if u_kern else None
    c_dev = sum(x[0] for x in c_kern) / 3 if c_kern else None
    print(f"[images] undistort: {len(images)} images {W} x {H} in one "
          f"launch, bitwise undistort_plain {u_bit} (max abs {u_err}), two "
          f"launches bitwise {u_rep}; {u_ms:.4f} device ms (queued ahead "
          f"{u_ahead}; the kernel under torch.profiler {u_dev}), plain "
          f"{u_plain:.3f} ms, grid_sample (float bilinear, not the same "
          f"function) {lib_ms:.4f} ms; bound {u_bound[0]:.4f} ms "
          f"({nbytes / 1e6:.1f} MB at 3.35 TB/s)", flush=True)
    print(f"[images] colorize: {len(it)} images, {n_win} window points, "
          f"{picks} picks; bitwise colorize_plain {c_bit}, two launches "
          f"bitwise {c_rep}; {c_ms:.3f} ms a call (device time with its "
          f"read back; {c_syncs} synchronizing call a call; its kernel "
          f"under torch.profiler {c_dev} ms), plain {c_plain:.1f} ms; "
          f"bound {c_bound[0]:.4f} ms "
          f"({c_bound[1]}: {c_ops} float64 operations at half the data "
          f"sheet's fp64 rate, {c_bytes / 1e6:.1f} MB)", flush=True)
    if not (u_bit and u_rep and c_bit and c_rep):
        _fail("[images]: undistort or colorize is not bitwise its plain "
              "version and itself")
    if c_syncs != 1:
        _fail(f"[images]: a colorize call synchronized {c_syncs} times, "
              f"not once")
    kern["undistort"] = dict(max_abs_err=u_err, ms=u_ms, plain_ms=u_plain,
                             library_ms=lib_ms, bound=u_bound,
                             queued_ahead={"ms": u_ahead},
                             kernel_device_ms=u_dev)
    kern["colorize"] = dict(max_abs_err=c_err, ms=c_ms, plain_ms=c_plain,
                            library_ms=None, bound=c_bound,
                            queued_ahead={"ms": False},
                            kernel_device_ms=c_dev)
    phase_s = time.time() - phase_t0
    print(f"[images] phase wall {phase_s:.1f} s", flush=True)
    rec.update(write_s=write_s, convert_s=convert_s, decode_ms=decode,
               decode_counts=n_kind, jpeg_psnr_db=psnr, fixtures=fixtures,
               fixture_decode_ms=fixture_ms, phase_s=phase_s,
               resize_ms=resize_ms,
               system_wall_s=wall, frontend_s=spans["frontend_s"],
               stages=stages, export=ex, reproj=(v.mean_reproj_pre,
                                                 v.mean_reproj_post),
               stats={k: v.stats[k] for k in (
                   "tracks_fused", "tracks_with_plane", "observations")},
               launches=counts, sift_device_ms=sift_ms, match_ms=match_ms,
               undistort=dict(bitwise=u_bit, repeat=u_rep, ms=u_ms,
                              kernel_device_ms=u_dev, plain_ms=u_plain,
                              grid_sample_ms=lib_ms, bound=u_bound,
                              bytes=nbytes, route=u_route,
                              box=(u_plan.pitch, u_plan.rows),
                              staged=u_plan.staged, routes=u_paths),
               colorize=dict(bitwise=c_bit, repeat=c_rep, ms=c_ms,
                             kernel_device_ms=c_dev, plain_ms=c_plain,
                             syncs=c_syncs,
                             bound=c_bound, window_points=n_win,
                             picks=picks, ops=c_ops),
               tree=dict(jpegs=len(jpgs), after=n_after, before=n_before,
                         points3d=n_p3d, reproj=len(pngs),
                         track_features=len(tracks)))
    del stack, und, pts, a, b, pl
    shutil.rmtree(work, ignore_errors=True)

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import global_lvba_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2

    import numpy as np

    from global_lvba_tpu_torch import resolve_device
    from global_lvba_tpu_torch.__main__ import slice_config
    from global_lvba_tpu_torch.factors.padding import (
        buckets_to_device, picks_aligned)
    from global_lvba_tpu_torch.factors.plane_eigen import (
        PLAIN_STEPS, _cost_grad_hess, plane_cost_grad_hess, pose_table,
        voxel_chunks)
    from global_lvba_tpu_torch.kernels import (
        build, launch_counts, reset_launch_counts)
    from global_lvba_tpu_torch.kernels.gram import (
        syrk_, syrk_plain_, tf32_split, tf32_split_plain)
    from global_lvba_tpu_torch.kernels.soa import (
        soa_agg, soa_agg_plain, soa_chain, soa_chain_plain)
    from global_lvba_tpu_torch.kernels.selection import table_select
    from global_lvba_tpu_torch.map.voxelize import build_voxel_map
    from global_lvba_tpu_torch.models.synthetic import (
        ate_rmse, make_plane_scene, perturb_poses)
    from global_lvba_tpu_torch.pipeline.lidar_ba import run_lidar_ba
    from global_lvba_tpu_torch.solver.lm import lm_damping_iter

    results = {}
    paths = {}      # the launch counts of each path's run

    # ---- 1. set-up ----
    card = _card_line()
    print(card, flush=True)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device {torch.cuda.get_device_name(0)}; TF32 off (matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32}); torch {torch.__version__} "
          f"CUDA {torch.version.cuda}", flush=True)
    t0 = time.time()
    for name in build.SIGNATURES:
        build.launcher(name)
    results["build_s"] = time.time() - t0
    print(f"[setup] kernels built in {results['build_s']:.1f} s", flush=True)
    from global_lvba_tpu_torch.native import runtime
    t0 = time.time()
    runtime.library()
    results["host_build_s"] = time.time() - t0
    print(f"[setup] the native host library ({build.HOST_CXX} "
          f"{' '.join(build.HOST_FLAGS)}) built in "
          f"{results['host_build_s']:.1f} s: {build.host_library().name}",
          flush=True)
    for name, log in build.build_logs().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "(reused)" in line:
                print(f"[setup] {name}: {line.strip()}", flush=True)
    n_dmma, dmma_ops = _dmma_count(build)
    results["syrk_f64_dmma"] = dict(count=n_dmma, opcodes=dmma_ops)
    print(f"[setup] syrk_f64_kernel's SASS: {n_dmma} DMMA instructions "
          f"{dmma_ops}", flush=True)
    if n_dmma == 0:
        _fail("syrk_f64_kernel's SASS holds no DMMA: the fp64 tensor cores "
              "are not used")

    # ---- the main path's problem: the W=512 scene, stage-1 voxelization ----
    W = FRAMES
    cfg = slice_config("float32")
    scene = make_plane_scene(num_frames=W, points_per_frame=PPF, seed=0)
    Rp, pp = perturb_poses(scene.R_true, scene.p_true, 0.003, 0.01, seed=1)
    vm = build_voxel_map(
        scene.points_body, scene.frame_ids, Rp, pp, VOXEL,
        eigen_ratios=[RATIO] * 4, min_ps=cfg.solver.min_ps,
        layer_limit=cfg.solver.layer_limit,
    )
    entries = sum(int((b.n > 0).sum()) for b in vm.buckets)
    bucket_cells = sum(int(np.prod(b.n.shape)) for b in vm.buckets)
    ratio = vm.num_planes * W / bucket_cells
    if not picks_aligned(vm, W):
        _fail(f"the density gate does not pick the aligned layout ({ratio})")
    fa = buckets_to_device(vm, W=W, dtype=torch.float32, device=dev)[0]
    V = fa.n.shape[0]
    R = torch.as_tensor(Rp, dtype=torch.float32, device=dev)
    p = torch.as_tensor(pp, dtype=torch.float32, device=dev)
    pose12 = pose_table(R, p)
    chunks = voxel_chunks(V, W)
    print(f"[scene] {scene.points_body.shape[0]} points, {vm.num_planes} "
          f"planar voxels padded to V={V}, {entries} live (voxel, frame) "
          f"entries, dense/bucketed cells {ratio:.3f}; chunks "
          f"{[hi - lo for lo, hi in chunks]}", flush=True)
    results["scene"] = dict(points=int(scene.points_body.shape[0]),
                            voxels=vm.num_planes, V=V, W=W, entries=entries,
                            chunks=[hi - lo for lo, hi in chunks])
    ops = [(fa.n[lo:hi], fa.mu[lo:hi], fa.Pc[lo:hi]) for lo, hi in chunks]
    live = fa.n.sum(dim=1) > 0
    gap, lam0, lam2 = _spectrum(torch, fa, pose12)
    wc = live & (gap >= WELL_CONDITIONED_GAP)
    n_ill = int((live & ~wc).sum())
    print(f"[scene] {n_ill} of {int(live.sum())} voxels line-like (λ1 − λ0 < "
          f"{WELL_CONDITIONED_GAP}·λ2)", flush=True)
    results["scene"]["line_like_voxels"] = n_ill
    kern = {}

    # ---- 2a. soa_agg: one launch over the bucket ----
    rk, pvk = soa_agg(fa.n, fa.mu, fa.Pc, pose12)
    rp, pvp = soa_agg_plain(fa.n, fa.mu, fa.Pc, pose12)
    torch.cuda.synchronize()
    line_like = live & ~wc
    err_r = _agg_check(torch, "soa_agg", rk, rp, pvk, pvp, live, wc, lam0,
                       lam2)
    # the per-entry pose operand (the bucketed layout's table_select rows)
    # with frame k at slot k must give the aligned result bit for bit
    frame = torch.arange(W, dtype=torch.int32, device=dev).expand(
        V, W).contiguous()
    rows0 = table_select(frame.reshape(-1), pose12).reshape(V, W, 12)
    same_frame = all(torch.equal(a, b) for a, b in zip(
        soa_agg(fa.n, fa.mu, fa.Pc, rows0), (rk, pvk)))
    print(f"[soa_agg] per-entry pose operand equal: {same_frame}", flush=True)
    if not same_frame:
        _fail("soa_agg on per-entry pose rows differs from the aligned one")
    del frame, rows0
    kern["soa_agg"] = dict(
        max_abs_err=err_r,
        **_times(torch, "soa_agg",
                 lambda: soa_agg(fa.n, fa.mu, fa.Pc, pose12),
                 lambda: soa_agg_plain(fa.n, fa.mu, fa.Pc, pose12)),
        **_agg_bounds("soa_agg", [fa.n], W * 12, 4))
    # the group shapes beyond the main path's: K = 1, 4, 45, 64, 1024
    _agg_k_cases(torch, np, dev)

    # ---- 2b. soa_chain (both versions take the kernel's pv) ----
    pvs = [pvk[lo:hi] for lo, hi in chunks]
    ch_k = [soa_chain(*o, pose12, q) for o, q in zip(ops, pvs)]
    ch_p = [soa_chain_plain(*o, pose12, q) for o, q in zip(ops, pvs)]
    torch.cuda.synchronize()
    err_A = max(_rel(a[0], b[0]) for a, b in zip(ch_k, ch_p))
    gk, gp = sum(a[1] for a in ch_k), sum(b[1] for b in ch_p)
    hk, hp = sum(a[2] for a in ch_k), sum(b[2] for b in ch_p)
    err_g, err_hd = _rel(gk, gp), _rel(hk, hp)
    abs_A = max(float((a[0] - b[0]).abs().max()) for a, b in zip(ch_k, ch_p))
    err_A64 = max(
        _rel(b[0].double(),
             soa_chain_plain(*(x.double() for x in o), pose12.double(),
                             q.double())[0])
        for o, q, b in zip(ops, pvs, ch_p))
    dead_rows = torch.cat([a[0].reshape(-1, 3, 6 * W) for a in ch_k])[~live]
    dead_ok = bool((dead_rows == 0).all())
    print(f"[soa_chain] rows rel err {err_A:.3e} (tol {TOL_ROWS_REL}; plain "
          f"float32 vs float64 {err_A64:.3e}); g rel "
          f"err {err_g:.3e}, Hd rel err {err_hd:.3e} (tol {TOL_SUM_REL}); "
          f"padded voxels' rows == 0: {dead_ok}", flush=True)
    if not (err_A <= TOL_ROWS_REL and err_g <= TOL_SUM_REL
            and err_hd <= TOL_SUM_REL and dead_ok):
        _fail("soa_chain disagrees with soa_chain_plain")
    # as the evaluation calls it (the running sums), bitwise repeatable,
    # dead cells' rows exact zeros; then the widths off its frame tile
    err_ev = _chain_check(torch, "soa_chain", ops, pose12, pvs,
                          TOL_ROWS_REL, TOL_SUM_REL)
    _chain_widths(torch, dev, "soa_chain", torch.float32, TOL_ROWS_REL,
                  TOL_SUM_REL)
    bound, bound_layout = _chain_bounds([o[0] for o in ops], W, 4)
    kern["soa_chain"] = dict(
        max_abs_err=max(abs_A, err_ev[3]),
        **_times(torch, "soa_chain",
                 lambda: _chain_evaluation(soa_chain, ops, pose12, pvs),
                 lambda: _chain_evaluation(soa_chain_plain, ops, pose12,
                                           pvs)),
        bound=bound, bound_layout=bound_layout)
    results["soa_chain_launches"] = _chain_launches(torch, "soa_chain", ops,
                                                    pose12, pvs)
    print(f"[soa_chain] bound {bound[0]:.4f} ms ({bound[1]}) over the live "
          f"cells' bytes; the layout's {bound_layout[0]:.4f} ms "
          f"({bound_layout[1]}); the earlier design "
          f"{CHAIN_EARLIER_MS['soa_chain'][0]} ms an evaluation", flush=True)

    # ---- 2c. syrk (3xTF32): the tf32 split, then the Gram ----
    # on the main path's operands (every voxel chunk into one gram), then
    # on ragged ones; Kr = 0 returns at once
    As = [a[0] for a in ch_k]
    N = 6 * W
    err_gram = _syrk_check(torch, "aligned W=512", As, N)
    rng = np.random.default_rng(5)
    for kr_, n_ in SYRK_RAGGED:
        A_ = torch.as_tensor(rng.normal(size=(kr_, n_)).astype(np.float32),
                             device=dev)
        _syrk_check(torch, f"ragged N={n_}", [A_], n_)
    before = launch_counts()
    g0 = torch.zeros((N, N), dtype=torch.float32, device=dev)
    out0 = syrk_(g0, torch.empty((0, N), dtype=torch.float32, device=dev))
    torch.cuda.synchronize()
    empty_ok = (out0 is g0 and launch_counts() == before
                and not bool(g0.any()))
    print(f"[syrk] Kr = 0: returns gram unchanged with no launch: "
          f"{empty_ok}", flush=True)
    if not empty_ok:
        _fail("syrk_ launched or changed gram on an empty operand")
    scratch = torch.zeros((N, N), dtype=torch.float32, device=dev)
    bound, bound_fp32, flops = _syrk_bounds(As, N)
    kern["syrk"] = dict(
        max_abs_err=err_gram,
        **_times_in_turns(torch, "syrk",
                          lambda: [syrk_(scratch, A) for A in As],
                          lambda: [syrk_plain_(scratch, A) for A in As],
                          lambda: [torch.matmul(A.T, A) for A in As]),
        bound=bound)
    kern["syrk_split"] = dict(
        max_abs_err=0.0,
        **_times(torch, "syrk_split",
                 lambda: [tf32_split(A) for A in As],
                 lambda: [tf32_split_plain(A) for A in As]),
        bound=_split_bound(As))
    print(f"[syrk] aligned: {flops / 1e9:.1f} GFLOP (fp32-equivalent) per "
          f"evaluation; bound {bound[0]:.4f} ms ({bound[1]}, 3xTF32 at "
          f"{TF32_FLOP_PER_S / 1e12:.0f} TFLOP/s; the fp32 bound it replaces "
          f"{bound_fp32[0]:.4f} ms); {flops / kern['syrk']['ms'] / 1e9:.1f} "
          f"TFLOP/s fp32-equivalent at the wrapper's {kern['syrk']['ms']:.4f} "
          f"ms, of which the split {kern['syrk_split']['ms']:.4f} ms",
          flush=True)
    del scratch, g0, As, ch_k, ch_p, rk, rp, pvk, pvp
    # ---- 2d. the float64 instances of kernels 1-3 ----
    _aligned_f64(torch, kern, results, fa, R, p, ops, pose12, live, wc,
                 lam0, lam2, W)

    # ---- 3. evaluation ----
    r1, g1, H1 = plane_cost_grad_hess(fa, R, p, W)
    r2, g2, H2 = plane_cost_grad_hess(fa, R, p, W)
    torch.cuda.synchronize()
    same = bool(torch.equal(r1, r2) and torch.equal(g1, g2)
                and torch.equal(H1, H2))
    same = same and bool(torch.isfinite(H1).all() and torch.isfinite(g1).all())
    rq = _cost_grad_hess(PLAIN_STEPS, fa, R, p, W)[0]
    # r sums λ_min over every voxel: the line-like voxels may add up to
    # their own tolerance (TOL_RESIDV_REL_LINE · λ_max each)
    r_slack = TOL_RESIDV_REL_LINE * float(lam2[line_like].abs().sum())
    e_r = max(0.0, abs(float(r1) - float(rq)) - r_slack) / abs(float(rq))
    fa_wc = fa._replace(n=fa.n * wc[:, None].to(fa.n.dtype))
    _, gk_, Hk_ = plane_cost_grad_hess(fa_wc, R, p, W)
    _, gq, Hq = _cost_grad_hess(PLAIN_STEPS, fa_wc, R, p, W)
    e_g, e_H = _rel(gk_, gq), _rel(Hk_, Hq)
    del gk_, Hk_, fa_wc
    eval_ms, ahead_e = _timed(torch, lambda: plane_cost_grad_hess(fa, R, p, W))
    plain_eval_ms, ahead_pe = _timed(
        torch, lambda: _cost_grad_hess(PLAIN_STEPS, fa, R, p, W))
    print(f"[eval] kernels vs plain: r rel err {e_r:.3e} (all voxels, beyond "
          f"the line-like voxels' {r_slack:.3e}; raw "
          f"{abs(float(r1) - float(rq)) / abs(float(rq)):.3e}), g "
          f"{e_g:.3e}, H {e_H:.3e} (well-conditioned voxels) (tol "
          f"{TOL_EVAL_REL}); full problem finite and bitwise repeatable: "
          f"{same}; eval {eval_ms:.4f} ms device time (queued ahead "
          f"{ahead_e}), plain {plain_eval_ms:.4f} ms (queued ahead "
          f"{ahead_pe})", flush=True)
    if not (e_r <= TOL_EVAL_REL and e_g <= TOL_EVAL_REL
            and e_H <= TOL_EVAL_REL and same):
        _fail("the kernel evaluation disagrees with the plain one or is "
              "not repeatable")
    Hf, gf = H1.reshape(6 * W, 6 * W), g1.reshape(-1)
    u0 = torch.full((), 0.01, dtype=Hf.dtype, device=dev)
    cg = _cg_check(torch, "eval", Hf, gf, u0, capture=True)
    cg_ms = cg["ms"]
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        plane_cost_grad_hess(fa, R, p, W)
        torch.cuda.synchronize()
    sums = _no_partial_sums(prof, "eval")
    prof_eval = _device_ms(prof)
    for name, sym in KERNEL_SYMBOLS.items():
        hits = [(k, v) for k, v in prof_eval.items() if sym in k]
        if hits:
            ms_k, calls = hits[0][1]
            kern[name]["kernel_device_ms"] = ms_k
            print(f"[eval] profiler: {sym} {ms_k:.4f} ms device time in "
                  f"{calls} launches per evaluation", flush=True)
        elif name in kern:
            print(f"[eval] profiler: {sym}: device time not measured",
                  flush=True)
    top = sorted(prof_eval.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"[eval] profiler, device time per evaluation (ms, calls): "
          f"{[(k[:48], round(v[0], 4), v[1]) for k, v in top]}", flush=True)
    results["eval"] = dict(ms=eval_ms, plain_ms=plain_eval_ms, r_rel=e_r,
                           g_rel=e_g, H_rel=e_H, bitwise_repeatable=same,
                           sum_shapes=sums,
                           cg_solve_ms=cg_ms, cg=cg, queued_ahead=ahead_e,
                           profiler_device_ms=prof_eval)
    del r1, g1, H1, r2, g2, H2, rq, gq, Hq, fa, Hf, gf

    # ---- 4. slice: run_lidar_ba on the card ----
    clouds = [scene.points_body[scene.frame_ids == i] for i in range(W)]
    reset_launch_counts()
    t0 = time.time()
    res = run_lidar_ba(clouds, Rp, pp, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = paths["aligned"] = launch_counts()
    ate0 = ate_rmse(pp, scene.p_true)
    ate = ate_rmse(res.p_opt, scene.p_true)
    stages = res.stats["global"]
    iters = sum(s.get("lm_iters", 0) for s in stages)
    lm_s = sum(s.get("lm_s", 0.0) for s in stages)
    ms_iter = lm_s / max(iters, 1) * 1e3
    print(f"[slice] run_lidar_ba {W} frames: ATE {ate0:.6f} -> {ate:.6f} m, "
          f"wall {wall:.2f} s, {iters} LM iterations in {lm_s:.3f} s "
          f"({ms_iter:.2f} ms/iter), launches {counts}", flush=True)
    for s in stages:
        print(f"[slice] stage {s}", flush=True)
    results["slice"] = dict(ate0=ate0, ate=ate, wall_s=wall, lm_iters=iters,
                            lm_s=lm_s, ms_per_iter=ms_iter, stages=stages,
                            launches=counts)
    if not all(counts[k] > 0 for k in ALIGNED_PATH_KERNELS):
        _fail(f"a kernel of the path was never launched: {counts}")
    t0 = time.time()
    ref = run_lidar_ba(clouds, Rp, pp, slice_config("float64"), device="cpu")
    ate_ref = ate_rmse(ref.p_opt, scene.p_true)
    print(f"[slice] float64 reference on the CPU: ATE {ate_ref:.6f} m "
          f"({time.time() - t0:.1f} s)", flush=True)
    results["slice"]["ate_float64_cpu"] = ate_ref
    if not (np.isfinite(res.p_opt).all() and ate <= ate0 / 5
            and abs(ate - ate_ref) <= 0.1 * ate_ref):
        _fail(f"ATE {ate0} -> {ate} (float64 reference {ate_ref})")

    # ---- 4b. float64 on the card: the kernels' double instances ----
    reset_launch_counts()
    t0 = time.time()
    res64 = run_lidar_ba(clouds, Rp, pp, slice_config("float64"),
                         device="cuda")
    torch.cuda.synchronize()
    wall64 = time.time() - t0
    counts64 = paths["float64"] = launch_counts()
    ate64 = ate_rmse(res64.p_opt, scene.p_true)
    e64 = abs(ate64 - ate_ref) / ate_ref
    st64 = res64.stats["global"]
    done64 = bool(st64) and all(s.get("lm_iters", 0) > 0 for s in st64)
    print(f"[float64] run_lidar_ba {W} frames, solver.dtype float64 on the "
          f"card: ATE {ate0:.6f} -> {ate64:.9f} m in {wall64:.2f} s, "
          f"{sum(s.get('lm_iters', 0) for s in st64)} LM iterations; the "
          f"float64 CPU run's {ate_ref:.9f} m: rel diff {e64:.3e} (tol "
          f"1e-6); launches {counts64}", flush=True)
    results["float64"] = dict(ate=ate64, ate_float64_cpu=ate_ref,
                              rel_diff=e64, wall_s=wall64, stages=st64,
                              launches=counts64)
    f64_only = all(counts64[k] > 0 for k in ALIGNED_F64_KERNELS) and not any(
        v for k, v in counts64.items() if not k.endswith("_f64"))
    if not (np.isfinite(res64.p_opt).all() and done64 and e64 <= 1e-6
            and f64_only):
        _fail(f"float64 on the card: ATE {ate64} vs the CPU's {ate_ref}, "
              f"launches {counts64}")
    del res64

    # ---- 5. the bench's W=512 problem: voxel map at the true poses ----
    vm_t = build_voxel_map(
        scene.points_body, scene.frame_ids, scene.R_true, scene.p_true,
        VOXEL, eigen_ratios=[RATIO] * 4)
    fa_t = buckets_to_device(vm_t, W=W, dtype=torch.float32, device=dev)
    lm_damping_iter(fa_t, R, p, max_iters=LM_ITERS)
    torch.cuda.synchronize()
    t0 = time.time()
    lm = lm_damping_iter(fa_t, R, p, max_iters=LM_ITERS)
    torch.cuda.synchronize()
    lm_wall = time.time() - t0
    syncs = _lm_syncs(torch, "bench-problem", lambda: lm_damping_iter(
        fa_t, R, p, max_iters=LM_ITERS))
    ate_b = ate_rmse(lm.p.double().cpu().numpy(), scene.p_true)
    print(f"[bench-problem] lm_damping_iter W={W}: ATE {ate0:.6f} -> "
          f"{ate_b:.6f} m in {lm.iters} iterations, {lm_wall * 1e3:.1f} ms "
          f"({lm_wall / max(lm.iters, 1) * 1e3:.2f} ms/iter incl. the "
          f"initial evaluation)", flush=True)
    results["bench_problem"] = dict(ate=ate_b, iters=lm.iters,
                                    wall_ms=lm_wall * 1e3,
                                    ms_per_iter=lm_wall / max(lm.iters, 1)
                                    * 1e3, host_reads=syncs)
    if not ate_b <= 1e-3:
        _fail(f"bench problem ATE {ate_b} > 1 mm")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm_damping_iter(fa_t, R, p, max_iters=LM_ITERS)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy = sum(v[0] for v in _device_ms(prof).values())
    idle = 1.0 - busy / (prof_wall * 1e3)
    # the profiler's own host cost per launch lengthens the wall it sees;
    # a cross-run estimate sets the same device time against the
    # unprofiled run's wall (two windows: not a measured share)
    idle_w = 1.0 - busy / (lm_wall * 1e3)
    print(f"[bench-problem] under torch.profiler: {prof_wall * 1e3:.1f} ms "
          f"wall, {busy:.1f} ms device busy, idle share {idle:.3f} (one "
          f"window); a cross-run estimate, that device time over the "
          f"unprofiled run's {lm_wall * 1e3:.1f} ms wall: {idle_w:.3f}",
          flush=True)
    results["bench_problem"].update(profiled_wall_ms=prof_wall * 1e3,
                                    device_busy_ms=busy, idle_share=idle,
                                    idle_share_cross_run_estimate=idle_w)

    bench = (fa_t, R, p, scene.p_true)
    # ---- 6-9. slice 2: the bucketed layout ----
    _slice2(torch, np, dev, kern, results, paths)
    # ---- 11-13. slice 4: large W (paths 2c, [banded-cg], [2c-dense]) ----
    large = _large_w(torch, np, dev, kern, results, paths)
    # ---- 10. slice 3: the SIFT frontend ----
    _frontend(torch, np, dev, kern, results, paths)
    # ---- 14-16. slice 10: the visual stage; 17. slice 11: the system ----
    scene = []
    for phase, run in (
            ("14", lambda: _visual_bench(torch, np, dev, results)),
            ("15", lambda: _visual_routes(torch, np, dev, results)),
            ("16", lambda: scene.extend(_visual_e2e(
                torch, np, dev, kern, results, paths))),
            ("17", lambda: _system(torch, np, dev, kern, results, paths,
                                   *scene)),
            ("18", lambda: _mesh(torch, np, dev, kern, results, paths,
                                 bench)),
            ("19", lambda: _a3b(torch, np, dev, kern, results, paths,
                                large)),
            ("20", lambda: _native(torch, np, dev, kern, results, *scene)),
            ("21", lambda: _images(torch, np, dev, kern, results, paths))):
        t0 = time.time()
        run()
        results[f"phase_{phase}_s"] = time.time() - t0
        print(f"[phase {phase}] {results[f'phase_{phase}_s']:.1f} s",
              flush=True)
    launches = {k: sum(c.get(k, 0) for c in paths.values()) for k in kern}
    if not all(launches.values()):
        _fail(f"a kernel was never launched on a path: {paths}")

    src = "global_lvba_tpu_torch/csrc/"
    sources = {"soa_agg": "soa_agg.cu", "soa_chain": "soa_chain.cu",
               "syrk": "syrk.cu", "syrk_split": "syrk.cu",
               "table_select": "selection.cu",
               "soa_chain_entries": "soa_chain.cu",
               "entry_reduce": "selection.cu",
               "top2_similarity": "matcher.cu", "zbuffer": "zbuffer.cu",
               "undistort": "undistort.cu", "colorize": "colorize.cu"}
    # a float64 instance lives in its float32 kernel's source and replaces
    # the same TPU kernel
    base = {k: k[:-len("_f64")] if k.endswith("_f64") else k for k in kern}
    replaces = {
        "soa_agg": "global_lvba_tpu/ops/pallas/soa_fused.py:61",
        "soa_chain": "global_lvba_tpu/ops/pallas/soa_fused.py:73",
        "syrk": "global_lvba_tpu/ops/pallas/gram.py:41",
        "syrk_split": "global_lvba_tpu/ops/pallas/gram.py:41",
        "table_select": "global_lvba_tpu/ops/pallas/selection.py:44",
        "soa_chain_entries": "global_lvba_tpu/ops/pallas/soa_fused.py:73",
        "entry_reduce": "global_lvba_tpu/ops/pallas/selection.py:84",
        "top2_similarity": "global_lvba_tpu/ops/pallas/matcher.py:30",
        # no Pallas original: the JAX package's host rasterizer
        "zbuffer": "global_lvba_tpu/native/lvba_native.cpp:688",
        # no Pallas original: the JAX package's cv2 remap and numpy
        # z-buffer of its exports
        "undistort": "global_lvba_tpu/pipeline/outputs.py:292",
        "colorize": "global_lvba_tpu/pipeline/outputs.py:81",
    }
    results["launches_by_path"] = paths
    line = {"kernels": [
        dict(name=k, route="cuda", source=f"{src}{sources[base[k]]}",
             replaces=replaces[base[k]], launches=launches[k],
             max_abs_err=v["max_abs_err"], ms=v["ms"],
             plain_ms=v["plain_ms"], bound_ms=v["bound"][0],
             bound_by=v["bound"][1], library_ms=v["library_ms"])
        for k, v in kern.items()
    ]}
    results["kernels"] = line["kernels"]
    results["kernel_timing"] = {
        k: dict(queued_ahead=v["queued_ahead"],
                kernel_device_ms=v.get("kernel_device_ms"))
        for k, v in kern.items()}
    results["card"] = card
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(results, indent=1,
                                                    default=float))
    print(json.dumps(line, default=float))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(_mesh_worker(sys.argv[2:]))
    sys.exit(main())
