// The depth maps' z-buffer: every image of a visual stage rasterized in
// one launch, voxel-major.
//
// Replaces no Pallas kernel: the JAX package rasterizes on the host, in
// numpy (pipeline/depth._zbuffer_host) or in its C++ runtime
// (global_lvba_tpu/native/lvba_native.cpp:688 lvba_zbuffer_ranges, body
// zbuf_accum at :634), because its TPU sat behind a remote link.  Here the
// grid map's voxel-grouped points (N, 3) are uploaded once and every image
// m reads its covisible voxels in place through CSR ranges, with its
// world->camera pose cams[m] = (Rcw row-major, tcw) cast to float32 as
// zbuf_cam does.
//
// Per point the arithmetic is zbuf_accum's, in its order: the camera-frame
// point R p + t, the Z >= 1e-3 gate, the distortion polynomial, the finite
// check, the uf <= -1 || uf >= W bounds, truncation toward zero, a min per
// pixel.  The rounding follows numpy's _zbuffer_host, the reference the
// CPU path keeps: its BLAS forms R p as the chain fma(R2, p2, fma(R1, p1,
// R0 p0)) (so does zbuf_accum, contracted by g++), then adds t; every
// other product, sum and quotient is a numpy ufunc, rounded once
// (__fmul_rn, __fadd_rn, __fdiv_rn: nvcc would fuse them).  Each fused
// multiply-add is a float64 product and sum rounded once to float32
// (fma32 below): the FMA's value but where the float64 sum itself lands on
// a float32 tie, and a form the plain torch version computes too.
//
// Layout: the wrapper (kernels/zbuffer.py sorted_pairs) sorts the images'
// (range, image) pairs by range on the card, with no read back, so each
// distinct range lists the images that see it; a block takes a chunk of
// LVBA_ZBUF_CHUNK sorted pairs and, range by range, the pairs of the
// chunk that share a range, the range cut into pieces of at most
// LVBA_ZBUF_PIECE points (range_pieces there lists the same pieces).  For
// each piece, the block reads its points once from device memory with
// 16-byte loads into shared memory, takes their bounding box, and then
// walks its pairs' images.  Where the box proves that every point fails
// the Z gate (cull_z below: the box's largest R2 p + t in float64, plus a margin of
// 2^-20 of the sum of the terms' magnitudes, far above the float32
// chain's rounding of at most 4 ulps of that sum, stays below 1e-3f), the
// image is skipped whole; the rest are compacted into a shared list and
// each warp takes an image at a time, its lanes over the piece's points
// in shared memory.  So a point crosses L2 about once a range, not once
// an image that sees it (4.8 GB at ladder 3's 200 images), and most of the
// 70% of (point, image) pairs there that lie behind the camera cost no Z
// row.
//
// The maps are filled by one cudaMemsetAsync of 0xff bytes (the unsigned
// maximum), a pixel takes the least Z by atomicMin on its bits as
// unsigned ints (Z >= 1e-3 is positive, so its bits ordered as an integer
// are its order as a float: the minimum is exact in any order, and the
// maps are bitwise repeatable and bitwise zbuffer_plain's,
// kernels/zbuffer.py), and a finish pass turns what is not finite (no
// point, or Z = +inf) into 0.  A compare-and-swap loop with 0 as "no
// point" would need no finish, but it was 2.3 times slower on an H100
// (3.40 against 1.48 ms at ladder 3, scripts/zbuffer_sweep.py): a swap
// waits for its result and the lanes that hit one pixel take turns, where
// atomicMin's result goes unused and it issues as a reduction.  A plain
// read of the pixel first skips the atomic when the map already holds a
// nearer depth (values only fall, so a stale read never skips a needed
// update).
//
// Bound: operations (the Z row of every point in a (piece, image) pair the
// cull keeps, the rest of the projection for the points in front); the
// bytes that must move (points and ranges once, maps once) take less.
// What holds it back on an H100 is fma32's float64 round trips (a
// conversion unit does 16 a clock an SM): 0.36 of the kernel's 0.92 ms at
// ladder 3, against 0.60 ms with a float32 FMA, which would round
// otherwise at double-rounding ties (scripts/zbuffer_sweep.py
// --variants).
#include <cuda_runtime.h>
#include <stdint.h>

#include "lvba_error.cuh"

#ifndef LVBA_ZBUF_PIECE
#define LVBA_ZBUF_PIECE 2048
#endif
#ifndef LVBA_ZBUF_CHUNK
#define LVBA_ZBUF_CHUNK 128
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPiece = LVBA_ZBUF_PIECE;
// the sorted pairs a block takes
constexpr int kChunk = LVBA_ZBUF_CHUNK;
// the piece's floats, plus up to 3 ahead of it for the 16-byte alignment
constexpr int kPieceVec = (3 * kPiece + 3 + 3) / 4;
// the cull's margin, a fraction of the sum of the Z row's magnitudes
constexpr double kCullMargin = 9.5367431640625e-07;   // 2^-20

static_assert(kPiece % 4 == 0, "a piece is a whole number of float4s");
static_assert(kChunk <= kThreads, "a pair of the chunk a thread");

// a * b + c rounded once to float32 (a float64 product is exact)
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(
      __dmul_rn(static_cast<double>(a), static_cast<double>(b)),
      static_cast<double>(c)));
}

// row r of R p + t as the host BLAS forms R p, then + t
__device__ __forceinline__ float rigid(float r0, float r1, float r2, float t,
                                       float px, float py, float pz) {
  return __fadd_rn(fma32(r2, pz, fma32(r1, py, __fmul_rn(r0, px))), t);
}

struct Intrinsics {
  float fx, fy, cx, cy, k1, k2, p1, p2;
  int W, H;
};

// true where every point of the box lo..hi fails Z >= 1e-3f through the
// Z row (r0, r1, r2, t): in float64, the box's largest R2 p + t, each
// product exact, summed in this order; the margin covers the float32
// chain's rounding.  A NaN pose keeps the pair (fmax passes over a NaN
// product only where the other is a number).  cull_z in
// kernels/zbuffer.py computes the same, operation by operation.
__device__ __forceinline__ bool cull_z(float r0, float r1, float r2, float t,
                                       const float* lo, const float* hi) {
  const float r[3] = {r0, r1, r2};
  double zmax = static_cast<double>(t);
  double mag = fabs(static_cast<double>(t));
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const double a = __dmul_rn(static_cast<double>(r[j]),
                               static_cast<double>(lo[j]));
    const double b = __dmul_rn(static_cast<double>(r[j]),
                               static_cast<double>(hi[j]));
    zmax = __dadd_rn(zmax, fmax(a, b));
    mag = __dadd_rn(mag, fmax(fabs(a), fabs(b)));
  }
  return __dadd_rn(zmax, __dmul_rn(mag, kCullMargin)) <
         static_cast<double>(1e-3f);
}

// the image whose ranges hold pair o of the images' CSR list: the last m
// with offsets[m] <= o (offsets[0] = 0 <= o < offsets[M])
__device__ __forceinline__ int pair_image(const int64_t* offsets, int M,
                                          int64_t o) {
  int lo = 0, hi = M;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(offsets + mid) <= o) lo = mid;
    else hi = mid;
  }
  return lo;
}

// a pose entry as zbuf_cam casts it: float64 rounded to float32
__device__ __forceinline__ float pose(const double* a, int64_t i) {
  return __double2float_rn(__ldg(a + i));
}

__global__ void __launch_bounds__(kThreads)
zbuffer_kernel(const float* __restrict__ pts, int64_t n_floats,
               const int64_t* __restrict__ key,
               const int64_t* __restrict__ order,
               const int64_t* __restrict__ offsets, int M, int64_t P,
               const double* __restrict__ Rcw,
               const double* __restrict__ tcw, Intrinsics in,
               unsigned* __restrict__ depth,
               unsigned long long* __restrict__ stats) {
  __shared__ float4 sp4[kPieceVec];
  __shared__ float red[2 * 3 * kWarps];
  __shared__ float box[6];
  __shared__ int kept[kChunk];
  __shared__ int opener[kChunk];
  __shared__ int warp_at[kWarps];
  __shared__ int n_kept, n_open;
  float* sp = reinterpret_cast<float*>(sp4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float p1x2 = __fmul_rn(2.0f, in.p1), p2x2 = __fmul_rn(2.0f, in.p2);
  const float Wf = static_cast<float>(in.W), Hf = static_cast<float>(in.H);
  const int64_t HW = (int64_t)in.H * in.W;
  // the block's chunk of kChunk sorted pairs, cut where the key changes
  // into segments: the pairs of one distinct range that lie in the chunk
  const int64_t c0 = blockIdx.x * (int64_t)kChunk;
  const int len = static_cast<int>(P - c0 < kChunk ? P - c0 : kChunk);
  const bool opens =
      tid < len && (tid == 0 || key[c0 + tid] != key[c0 + tid - 1]);
  const unsigned ball = __ballot_sync(0xffffffffu, opens);
  if (lane == 0) warp_at[warp] = __popc(ball);
  __syncthreads();
  if (tid == 0) {
    int at = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_at[w];
      warp_at[w] = at;
      at += c;
    }
    n_open = at;
  }
  __syncthreads();
  if (opens) opener[warp_at[warp] + __popc(ball & ((1u << lane) - 1))] = tid;
  __syncthreads();
  const int n_seg = n_open;
  unsigned long long kept_pairs = 0, kept_points = 0;
  for (int j = 0; j < n_seg; ++j) {
    const int s0 = opener[j], s1 = j + 1 < n_seg ? opener[j + 1] : len;
    const int64_t k = key[c0 + s0];
    const int64_t start = k >> 32, count = k & 0xffffffffLL;
    for (int64_t k0 = 0; k0 < count; k0 += kPiece) {
      const int cnt = static_cast<int>(
          count - k0 < kPiece ? count - k0 : kPiece);
      const int64_t f0 = 3 * (start + k0), f1 = f0 + 3 * (int64_t)cnt;
      const int sh = static_cast<int>(f0 & 3);
      const int64_t q0 = f0 >> 2;
      __syncthreads();   // the last piece's points and list no longer read
      // the piece's floats once, 16 bytes a thread where the array allows
      for (int64_t q = q0 + tid; 4 * q < f1; q += kThreads) {
        if (4 * q + 4 <= n_floats) {
          sp4[q - q0] = __ldg(reinterpret_cast<const float4*>(pts) + q);
        } else {
          for (int i = 0; i < 4; ++i)
            if (4 * q + i < n_floats)
              sp[4 * (q - q0) + i] = __ldg(pts + 4 * q + i);
        }
      }
      if (tid == 0) n_kept = 0;
      __syncthreads();
      // the points' box (fminf / fmaxf pass over NaN coordinates: such a
      // point fails the Z gate whatever the box says)
      float lo[3] = {INFINITY, INFINITY, INFINITY};
      float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
      for (int i = tid; i < cnt; i += kThreads) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float v = sp[sh + 3 * i + d];
          lo[d] = fminf(lo[d], v);
          hi[d] = fmaxf(hi[d], v);
        }
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        for (int o = 16; o > 0; o >>= 1) {
          lo[d] = fminf(lo[d], __shfl_xor_sync(0xffffffffu, lo[d], o));
          hi[d] = fmaxf(hi[d], __shfl_xor_sync(0xffffffffu, hi[d], o));
        }
        if (lane == 0) {
          red[3 * warp + d] = lo[d];
          red[3 * kWarps + 3 * warp + d] = hi[d];
        }
      }
      __syncthreads();
      if (tid < 3) {
        float a = INFINITY, b = -INFINITY;
        for (int w = 0; w < kWarps; ++w) {
          a = fminf(a, red[3 * w + tid]);
          b = fmaxf(b, red[3 * kWarps + 3 * w + tid]);
        }
        box[tid] = a;
        box[3 + tid] = b;
      }
      __syncthreads();
      // the segment's images that the box does not cull, a thread a pair
      if (tid >= s0 && tid < s1) {
        const int m = pair_image(offsets, M, order[c0 + tid]);
        if (!cull_z(pose(Rcw, 9 * m + 6), pose(Rcw, 9 * m + 7),
                    pose(Rcw, 9 * m + 8), pose(tcw, 3 * m + 2), box,
                    box + 3))
          kept[atomicAdd(&n_kept, 1)] = m;
      }
      __syncthreads();
      const int nk = n_kept;
      kept_pairs += nk;
      kept_points += static_cast<unsigned long long>(nk) * cnt;
      // a warp an image, its lanes over the piece's points
      for (int e = warp; e < nk; e += kWarps) {
        const int m = kept[e];
        const float R00 = pose(Rcw, 9 * m), R01 = pose(Rcw, 9 * m + 1),
                    R02 = pose(Rcw, 9 * m + 2), R10 = pose(Rcw, 9 * m + 3),
                    R11 = pose(Rcw, 9 * m + 4), R12 = pose(Rcw, 9 * m + 5),
                    R20 = pose(Rcw, 9 * m + 6), R21 = pose(Rcw, 9 * m + 7),
                    R22 = pose(Rcw, 9 * m + 8), t0 = pose(tcw, 3 * m),
                    t1 = pose(tcw, 3 * m + 1), t2 = pose(tcw, 3 * m + 2);
        unsigned* img = depth + (int64_t)m * HW;
        for (int i = lane; i < cnt; i += 32) {
          const float px = sp[sh + 3 * i], py = sp[sh + 3 * i + 1],
                      pz = sp[sh + 3 * i + 2];
          const float Z = rigid(R20, R21, R22, t2, px, py, pz);
          if (!(Z >= 1e-3f)) continue;
          const float X = rigid(R00, R01, R02, t0, px, py, pz);
          const float Y = rigid(R10, R11, R12, t1, px, py, pz);
          const float x = __fdiv_rn(X, Z), y = __fdiv_rn(Y, Z);
          const float r2 = __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
          const float radial =
              __fadd_rn(__fadd_rn(1.0f, __fmul_rn(in.k1, r2)),
                        __fmul_rn(__fmul_rn(in.k2, r2), r2));
          // x * radial + 2 p1 x y + p2 (r2 + 2 x x), left to right
          const float xd = __fadd_rn(
              __fadd_rn(__fmul_rn(x, radial),
                        __fmul_rn(__fmul_rn(p1x2, x), y)),
              __fmul_rn(in.p2,
                        __fadd_rn(r2, __fmul_rn(__fmul_rn(2.0f, x), x))));
          // y * radial + p1 (r2 + 2 y y) + 2 p2 x y, left to right
          const float yd = __fadd_rn(
              __fadd_rn(__fmul_rn(y, radial),
                        __fmul_rn(in.p1,
                                  __fadd_rn(r2, __fmul_rn(
                                                    __fmul_rn(2.0f, y), y)))),
              __fmul_rn(__fmul_rn(p2x2, x), y));
          const float uf = __fadd_rn(__fmul_rn(in.fx, xd), in.cx);
          const float vf = __fadd_rn(__fmul_rn(in.fy, yd), in.cy);
          if (!isfinite(uf) || !isfinite(vf)) continue;
          // truncation toward zero: uf in (-1, 0) lands on pixel 0
          if (uf <= -1.0f || uf >= Wf || vf <= -1.0f || vf >= Hf) continue;
          const int u = __float2int_rz(uf), v = __float2int_rz(vf);
          if (u < 0 || u >= in.W || v < 0 || v >= in.H) continue;
          unsigned* d = img + (int64_t)v * in.W + u;
          const unsigned zb = __float_as_uint(Z);
          if (zb < *d) atomicMin(d, zb);
        }
      }
    }
  }
  if (stats != nullptr && tid == 0 && kept_pairs) {
    atomicAdd(stats, kept_pairs);
    atomicAdd(stats + 1, kept_points);
  }
}

__global__ void zbuffer_finish_kernel(float* __restrict__ depth, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    if (!isfinite(depth[i])) depth[i] = 0.0f;
}

}  // namespace

// depth (M, H, W) float32 from the points (N, 3) float32 (16-byte
// aligned) and the images' ranges transposed: the keys of their P ranges
// (the range's first point << 32 | its points, int64) sorted, with each
// one's place in the images' CSR list, order (int64), whose offsets (M +
// 1, int64) give its image.  The poses Rcw (M, 9) and tcw (M, 3)
// float64.  stats, where not null,
// gains the kept (piece, image) pairs and the points in them (uint64
// each).
extern "C" int lvba_zbuffer(const float* pts, int64_t n_points,
                            const int64_t* key, const int64_t* order,
                            const int64_t* offsets, int64_t P, int M,
                            const double* Rcw,
                            const double* tcw, float fx, float fy, float cx,
                            float cy, float k1, float k2, float p1, float p2,
                            int W, int H, float* depth, int64_t* stats,
                            void* stream) {
  if (M <= 0) return 0;
  if (P >= 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = (int64_t)M * H * W;
  cudaError_t e = cudaMemsetAsync(depth, 0xff, sizeof(float) * n, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (P > 0) {
    const int64_t blocks = (P + kChunk - 1) / kChunk;
    const Intrinsics in{fx, fy, cx, cy, k1, k2, p1, p2, W, H};
    zbuffer_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        pts, 3 * n_points, key, order, offsets, M, P, Rcw, tcw, in,
        reinterpret_cast<unsigned*>(depth),
        reinterpret_cast<unsigned long long*>(stats));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t b = (n + kThreads - 1) / kThreads;
  zbuffer_finish_kernel<<<static_cast<unsigned>(b < 132 * 32 ? b : 132 * 32),
                          kThreads, 0, s>>>(depth, n);
  return static_cast<int>(cudaGetLastError());
}
