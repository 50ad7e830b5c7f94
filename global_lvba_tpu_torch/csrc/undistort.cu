// Undistortion of every image of an export in one launch: cv2's remap
// (INTER_LINEAR, BORDER_CONSTANT 0) through cv2's CV_16SC2 undistortion
// map, bit for bit.
//
// Replaces no Pallas kernel: the JAX package undistorts on the host with
// cv2 (global_lvba_tpu/pipeline/outputs.py:292 undistort_image).  The map
// is computed once per camera on the host in float64 (kernels/undistort.py
// undistort_map): per output pixel the source pixel (int16 x, y) and a
// 5-bit fraction index; the table holds cv2's 15-bit bilinear weights of
// each of the 1,024 fractions (non-negative, their sum exactly 1 << 15),
// packed as two pairs of 16-bit weights (row y0, row y0 + 1).  Each
// channel is (sum w_k s_k + (1 << 14)) >> 15 over the 2x2 taps, a tap
// outside the image 0: cv2's remapBilinear with FixedPtCast, integer
// arithmetic, so the output is bitwise the plain version's
// (remap_plain) and repeatable.  The sum stays below 256 << 15 because
// the weights are non-negative and sum to 1 << 15, so no clamp is needed.
//
// Bound: bytes.  The images are read once and written once (3 bytes a
// pixel each way); the map is read once per run of images.
//
// Design.  The output is cut into tiles of kTileH rows by kTileW pixels;
// a warp takes a row of a tile, a thread kPix neighbouring pixels, whose
// 12 output bytes it stores as three 4-byte words.  On the host
// (kernels/undistort.py remap_plan, cached with the map) each tile gets
// its source box: every tap of its pixels lies in `rows` rows from its
// first row and `pitch` bytes from its start byte (a multiple of 16), the
// same box shape for every tile of a launch; a tile whose taps need more
// than the cap (LVBA_UNDISTORT_MAX_PITCH bytes by LVBA_UNDISTORT_MAX_ROWS
// rows: strong distortion, random maps) reads its taps from global memory
// (pixel_global).  The map is laid out tile by tile, so a thread loads
// its pixels' map with one 16-byte and one 8-byte load.
//
// The grid is persistent: the (tile, image) items, tile-major, are split
// evenly over the blocks the card holds at once, so a block walks one or
// a few tiles over a run of images, each tile's map and weights in
// registers once.  The launcher picks one of two routes:
//   * TMA, where an image row is a multiple of 16 bytes (W % 16 == 0) and
//     the stack is 16-byte aligned: thread 0 keeps a ring of kSlots boxes
//     in flight (cp.async.bulk.tensor of 4-byte elements; completion on a
//     "full" mbarrier a slot).  Its out-of-bounds fill is zero, exactly
//     the constant border.  TMA takes a box only at a 16-byte aligned
//     inner start (another start faults), hence the plan's start bytes.
//     A warp waits on the slot's full barrier, computes, frees the slot on
//     its "empty" mbarrier (one arrival a warp) and stores; thread 0
//     refills a slot once every warp has freed it.  No block-wide barrier
//     in the loop: warps run up to kSlots boxes apart.  The taps are read
//     from shared memory with no branch.
//   * global, at any other width or alignment (TMA needs 16-byte strides
//     and base): every tile reads its taps from global memory.
// A pixel's two tap rows are read as 4-byte words (three a row from the
// box; two, or three where the row's six bytes start at a word's last
// byte, from global memory, a border pixel's taps by checked byte loads),
// taken apart by funnel shifts and byte permutes; the three channels are
// three dp2a pairs.  The two halves of a warp read taps about 48 words
// apart (64 source pixels), so their shared loads fall in different
// banks.  A warp stores its run of an output row as whole words, also
// where the run does not start on a word (W % 4 != 0; store12).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lvba_error.cuh"

#if !defined(LVBA_UNDISTORT_TILE_W) || !defined(LVBA_UNDISTORT_TILE_H) || \
    !defined(LVBA_UNDISTORT_MAX_PITCH) || !defined(LVBA_UNDISTORT_MAX_ROWS) || \
    !defined(LVBA_UNDISTORT_SEL01) || !defined(LVBA_UNDISTORT_SEL2)
#error "undistort.cu takes its tile and box limits from kernels/undistort.py"
#endif

namespace {

constexpr int kTileW = LVBA_UNDISTORT_TILE_W;
constexpr int kTileH = LVBA_UNDISTORT_TILE_H;
constexpr int kPix = 4;                       // pixels a thread: 3 words out
constexpr int kWarps = kTileH;                // a warp a row of a tile
constexpr int kThreads = kWarps * 32;
constexpr int kSlots = 2;                     // the TMA ring's depth
constexpr int kMinBlocks = 4;                 // blocks an SM (64 registers)
constexpr int kMaxPitch = LVBA_UNDISTORT_MAX_PITCH;
constexpr int kMaxRows = LVBA_UNDISTORT_MAX_ROWS;
// byte permutes of a row's six tap bytes (x0: c0 c1 c2, x0 + 1: c0 c1 c2)
// into dp2a's operands: channels 0 and 1 (bytes 0, 3 | 1, 4), channel 2
// (bytes 2, 5)
constexpr unsigned kSel01 = LVBA_UNDISTORT_SEL01;
constexpr unsigned kSel2 = LVBA_UNDISTORT_SEL2;
static_assert(kTileW / kPix == 32, "a warp takes a row of a tile");
static_assert((kSlots & (kSlots - 1)) == 0, "a power-of-two ring");
static_assert(kMaxPitch % 16 == 0 && kMaxPitch <= 1024 && kMaxRows <= 256,
              "a TMA box: at most 256 4-byte elements a row and 256 rows");

__host__ __device__ constexpr int slot_stride(int pitch, int rows) {
  // a box and 16 bytes that a pixel's last word load may touch, at TMA's
  // 128-byte alignment
  return (pitch * rows + 16 + 127) / 128 * 128;
}

// Whether a tile's taps are read from its staged box (else from global
// memory).
__device__ __forceinline__ bool staged(const int4& tp) { return tp.z != 0; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// Spins until the phase of `parity` completes; a completion that never
// comes (a fault in the ring) traps after ~2^24 tries instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done, tries = 0;
  do {
    if (++tries == (1u << 24)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// ---- TMA: a box of the (words, rows, images) tensor into shared memory --
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y,
                                         int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(x), "r"(y), "r"(z)
      : "memory");
}

__device__ __forceinline__ uint32_t ld_word(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One pixel's three channels from its two tap rows, each as the three
// 4-byte words from the one holding the tap's first byte (a0-a2: row y0,
// b0-b2: row y0 + 1), sa and sb that byte's bit offset in its word.
__device__ __forceinline__ void pixel_words(uint32_t a0, uint32_t a1,
                                            uint32_t a2, int sa, uint32_t b0,
                                            uint32_t b1, uint32_t b2, int sb,
                                            uint32_t wa, uint32_t wb,
                                            uint32_t v[3]) {
  const uint32_t alo = __funnelshift_r(a0, a1, sa);
  const uint32_t ahi = __funnelshift_r(a1, a2, sa);
  const uint32_t blo = __funnelshift_r(b0, b1, sb);
  const uint32_t bhi = __funnelshift_r(b1, b2, sb);
  const uint32_t a01 = __byte_perm(alo, ahi, kSel01);
  const uint32_t a22 = __byte_perm(alo, ahi, kSel2);
  const uint32_t b01 = __byte_perm(blo, bhi, kSel01);
  const uint32_t b22 = __byte_perm(blo, bhi, kSel2);
  v[0] = __dp2a_lo(wa, a01, __dp2a_lo(wb, b01, 1u << 14)) >> 15;
  v[1] = __dp2a_hi(wa, a01, __dp2a_hi(wb, b01, 1u << 14)) >> 15;
  v[2] = __dp2a_lo(wa, a22, __dp2a_lo(wb, b22, 1u << 14)) >> 15;
}

// One pixel from the staged box: p0 is the 4-byte word holding the tap
// (x0, y0)'s first byte, s that byte's bit offset in it.
__device__ __forceinline__ void pixel_staged(const uint8_t* p0, int s,
                                             int pitch, uint32_t wa,
                                             uint32_t wb, uint32_t v[3]) {
  const uint8_t* p1 = p0 + pitch;
  pixel_words(ld_word(p0), ld_word(p0 + 4), ld_word(p0 + 8), s, ld_word(p1),
              ld_word(p1 + 4), ld_word(p1 + 8), s, wa, wb, v);
}

// A tap row's words from global memory: the two aligned words from the
// one that holds byte p, and the third only where the row's six bytes
// reach it (p at a word's last byte), so no word holds none of them.
__device__ __forceinline__ int row_words(const uint8_t* p, uint32_t w[3]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* q = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  const int s = static_cast<int>(a & 3) * 8;
  w[0] = __ldg(q);
  w[1] = __ldg(q + 1);
  w[2] = s == 24 ? __ldg(q + 2) : 0u;
  return s;
}

// One pixel from global memory: by words where its four taps lie in the
// image, else each tap checked against it.
__device__ __forceinline__ void pixel_global(const uint8_t* __restrict__ im,
                                             int x0, int y0, int H, int W,
                                             uint32_t wa, uint32_t wb,
                                             uint32_t v[3]) {
  if (static_cast<unsigned>(x0) < static_cast<unsigned>(W - 1) &&
      static_cast<unsigned>(y0) < static_cast<unsigned>(H - 1)) {
    const uint8_t* p = im + ((int64_t)y0 * W + x0) * 3;
    uint32_t a[3], b[3];
    const int sa = row_words(p, a), sb = row_words(p + W * 3, b);
    pixel_words(a[0], a[1], a[2], sa, b[0], b[1], b[2], sb, wa, wb, v);
    return;
  }
  const bool in_x0 = x0 >= 0 && x0 < W, in_x1 = x0 + 1 >= 0 && x0 + 1 < W;
  const bool in_y0 = y0 >= 0 && y0 < H, in_y1 = y0 + 1 >= 0 && y0 + 1 < H;
  const int64_t r0 = ((int64_t)y0 * W + x0) * 3, r1 = r0 + (int64_t)W * 3;
  const uint32_t w00 = wa & 0xffff, w01 = wa >> 16;
  const uint32_t w10 = wb & 0xffff, w11 = wb >> 16;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const uint32_t a = (in_y0 && in_x0) ? __ldg(im + r0 + c) : 0;
    const uint32_t b = (in_y0 && in_x1) ? __ldg(im + r0 + 3 + c) : 0;
    const uint32_t d = (in_y1 && in_x0) ? __ldg(im + r1 + c) : 0;
    const uint32_t e = (in_y1 && in_x1) ? __ldg(im + r1 + 3 + c) : 0;
    v[c] = (a * w00 + b * w01 + d * w10 + e * w11 + (1u << 14)) >> 15;
  }
}

// A full lane's 12 output bytes o0-o2 at dst (its kPix pixels inside the
// row; the lanes of a warp hold one run of the row, lane by lane): three
// words where dst is on a word.  Else (k = dst & 3, the same for the
// whole warp) its two inner words, and the word it shares with the lane
// before, whose last k bytes (prev: that lane's o2) come by a shuffle;
// the first lane stores its first 4 - k bytes alone, and a lane with no
// full lane after it its last k bytes.
__device__ __forceinline__ void store12(uint8_t* dst, uint32_t o0,
                                        uint32_t o1, uint32_t o2,
                                        uint32_t prev, bool first,
                                        bool last) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  const int k = static_cast<int>(a & 3);
  uint32_t* q = reinterpret_cast<uint32_t*>(a & ~uintptr_t(3));
  if (k == 0) {
    q[0] = o0;
    q[1] = o1;
    q[2] = o2;
    return;
  }
  q[1] = __funnelshift_l(o0, o1, 8 * k);
  q[2] = __funnelshift_l(o1, o2, 8 * k);
  uint8_t* b = reinterpret_cast<uint8_t*>(q);
  if (first) {
    for (int j = k; j < 4; ++j)
      b[j] = static_cast<uint8_t>(o0 >> (8 * (j - k)));
  } else {
    q[0] = __funnelshift_l(prev, o0, 8 * k);
  }
  if (last) {
    for (int j = 0; j < k; ++j)
      b[12 + j] = static_cast<uint8_t>(o2 >> (32 - 8 * k + 8 * j));
  }
}

// kTma: staged tiles' boxes by TMA into a ring of kSlots, issued by thread
// 0; else every tile's taps from global memory.
template <bool kTma>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
undistort_kernel(const __grid_constant__ CUtensorMap tm_src,
                 const uint8_t* __restrict__ src,
                 const int* __restrict__ xy, const int16_t* __restrict__ frac,
                 const int4* __restrict__ tiles,
                 const uint2* __restrict__ wtab, int tiles_x, int N, int H,
                 int W, int pitch, int rows, int64_t items,
                 uint8_t* __restrict__ dst) {
  extern __shared__ uint8_t smem_raw[];
  // aligned by an offset from the shared array, so that the compiler still
  // sees shared loads
  uint8_t* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  __shared__ __align__(8) uint64_t full_bar[kSlots];
  __shared__ __align__(8) uint64_t empty_bar[kSlots];
  const int stride = slot_stride(pitch, rows);

  // this block's items [i0, i0 + n), from tile t0's image img0
  const int64_t i0 = blockIdx.x * items / gridDim.x;
  const int n = static_cast<int>((blockIdx.x + 1) * items / gridDim.x - i0);
  const int t0 = static_cast<int>(i0 / N);
  const int img0 = static_cast<int>(i0 - (int64_t)t0 * N);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t img_bytes = (int64_t)H * W * 3;

  // thread 0's loads: the next item to look at (pi: tile pt, image pimg)
  // and whether it is staged; it skips the global ones
  int pi = 0, pt = t0, pimg = img0;
  int4 ptp = make_int4(0, 0, 0, 0);
  const uint32_t box_bytes = static_cast<uint32_t>(pitch * rows);
  auto load_next = [&](int s) {
    for (; pi < n; ++pi) {
      const bool hit = staged(ptp);
      if (hit) {
        mbar_expect_tx(&full_bar[s], box_bytes);
        tma_load(smem + s * stride, &tm_src, &full_bar[s], ptp.x / 4, ptp.y,
                 pimg);
      }
      if (++pimg == N && pi + 1 < n) {
        pimg = 0;
        ptp = __ldg(tiles + ++pt);
      }
      if (hit) {
        ++pi;
        return;
      }
    }
  };
  if (kTma) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kSlots; ++s) {
        mbar_init(&full_bar[s], 1);
        mbar_init(&empty_bar[s], kWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      ptp = __ldg(tiles + pt);
      for (int s = 0; s < kSlots; ++s) load_next(s);
    }
    __syncthreads();
  }

  // warp `warp` computes row `warp` of each item's tile
  int t = t0, img = img0, k = 0, cur = -1;
  int4 tp = make_int4(0, 0, 0, 0);
  int x = 0, y = 0;
  int pa[kPix], ps[kPix];                // staged: word offset, bit shift;
  uint32_t wa[kPix], wb[kPix];           // global: x0, y0
  for (int i = 0; i < n; ++i) {
    if (t != cur) {
      cur = t;
      tp = __ldg(tiles + t);
      const int ty = t / tiles_x;
      y = ty * kTileH + warp;
      x = (t - ty * tiles_x) * kTileW + lane * kPix;
      const int64_t q = ((int64_t)t * kTileH + warp) * kTileW + lane * kPix;
      const int4 m = __ldg(reinterpret_cast<const int4*>(xy + q));
      const int2 f = __ldg(reinterpret_cast<const int2*>(frac + q));
      const int mm[kPix] = {m.x, m.y, m.z, m.w};
      const int ff[kPix] = {f.x & 0xffff, (f.x >> 16) & 0xffff, f.y & 0xffff,
                            (f.y >> 16) & 0xffff};
#pragma unroll
      for (int p = 0; p < kPix; ++p) {
        const uint2 w = __ldg(wtab + (ff[p] & 1023));
        wa[p] = w.x;
        wb[p] = w.y;
        const int x0 = static_cast<int16_t>(mm[p] & 0xffff);
        const int y0 = mm[p] >> 16;
        if (kTma && staged(tp)) {
          const int o = (y0 - tp.y) * pitch + x0 * 3 - tp.x;
          pa[p] = o & ~3;
          ps[p] = (o & 3) * 8;
        } else {
          pa[p] = x0;
          ps[p] = y0;
        }
      }
    }
    const uint8_t* im = src + img * img_bytes;
    uint32_t v[kPix][3];
    if (kTma && staged(tp)) {
      const int s = k & (kSlots - 1);
      const uint8_t* box = smem + s * stride;
      mbar_wait(&full_bar[s], (k / kSlots) & 1);
#pragma unroll
      for (int p = 0; p < kPix; ++p)
        pixel_staged(box + pa[p], ps[p], pitch, wa[p], wb[p], v[p]);
      // this warp is done with the slot; once every warp is, thread 0
      // refills it with the next staged item's box
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_bar[s]);
      if (threadIdx.x == 0) {
        mbar_wait(&empty_bar[s], (k / kSlots) & 1);
        load_next(s);
      }
      ++k;
    } else {
#pragma unroll
      for (int p = 0; p < kPix; ++p)
        pixel_global(im, pa[p], ps[p], H, W, wa[p], wb[p], v[p]);
    }
    const uint32_t o0 = v[0][0] | v[0][1] << 8 | v[0][2] << 16 | v[1][0] << 24;
    const uint32_t o1 = v[1][1] | v[1][2] << 8 | v[2][0] << 16 | v[2][1] << 24;
    const uint32_t o2 = v[2][2] | v[3][0] << 8 | v[3][1] << 16 | v[3][2] << 24;
    // y is the warp's, so the whole warp shuffles
    const uint32_t prev = __shfl_up_sync(0xffffffffu, o2, 1);
    if (y < H) {
      const int64_t off = img * img_bytes + ((int64_t)y * W + x) * 3;
      if (x + kPix <= W) {
        store12(dst + off, o0, o1, o2, prev, lane == 0,
                lane == 31 || x + 2 * kPix > W);
      } else {
        const uint32_t o[3] = {o0, o1, o2};
        for (int b = 0; b < kPix * 3 && x + b / 3 < W; ++b)
          dst[off + b] = static_cast<uint8_t>(o[b / 4] >> (8 * (b % 4)));
      }
    }
    if (++img == N) { img = 0; ++t; }
  }
}

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once (no -lcuda needed)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// The (N, H, W, 3) uint8 stack as (W * 3 / 4 words, H rows, N images) of
// 4-byte elements, boxes of (box_w words, box_h rows, 1 image); reads
// outside it are zero.
bool make_map(EncodeTiled enc, CUtensorMap* m, const void* base, int N,
              int H, int W, int box_w, int box_h) {
  const cuuint64_t dims[3] = {(cuuint64_t)W * 3 / 4, (cuuint64_t)H,
                              (cuuint64_t)N};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 3, (cuuint64_t)H * W * 3};
  const cuuint32_t box[3] = {(cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kTma>
int launch(const CUtensorMap& ms, const uint8_t* src, const int32_t* xy,
           const int16_t* frac, const int32_t* tiles, const uint32_t* wtab,
           int N, int H, int W, int pitch, int rows, uint8_t* dst,
           cudaStream_t s) {
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const int64_t items = (int64_t)tiles_x * tiles_y * N;
  const int smem = kTma ? kSlots * slot_stride(pitch, rows) + 128 : 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, undistort_kernel<kTma>, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t resident = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
  const unsigned grid =
      static_cast<unsigned>(items < resident ? items : resident);
  undistort_kernel<kTma><<<grid, kThreads, smem, s>>>(
      ms, src, xy, frac, reinterpret_cast<const int4*>(tiles),
      reinterpret_cast<const uint2*>(wtab), tiles_x, N, H, W, pitch, rows,
      items, dst);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dst (N, H, W, 3) uint8 from src (N, H, W, 3) uint8 through the plan of
// kernels/undistort.py remap_plan: xy (T, kTileH, kTileW) int32 (int16 x,
// y packed), frac (T, kTileH, kTileW) int16, tiles (T, 4) int32 (start
// byte, a multiple of 16; first row; staged; 0), wtab (1024, 2) uint32 and
// the box shape (pitch bytes, rows).  The TMA route where W % 16 == 0 and
// src is 16-byte aligned (kernels/undistort.py staging_route mirrors
// this), else the global route.
extern "C" int lvba_undistort(const uint8_t* src, const int32_t* xy,
                              const int16_t* frac, const int32_t* tiles,
                              const uint32_t* wtab, int N, int H, int W,
                              int pitch, int rows, uint8_t* dst,
                              void* stream) {
  if (N <= 0 || H <= 0 || W <= 0) return 0;
  if (pitch <= 0 || pitch % 16 != 0 || pitch > kMaxPitch || rows <= 0
      || rows > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap ms = {};
  const bool tma =
      W % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  if (!tma)
    return launch<false>(ms, src, xy, frac, tiles, wtab, N, H, W, pitch, rows,
                         dst, s);
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (!make_map(enc, &ms, src, N, H, W, pitch / 4, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(ms, src, xy, frac, tiles, wtab, N, H, W, pitch, rows,
                      dst, s);
}
