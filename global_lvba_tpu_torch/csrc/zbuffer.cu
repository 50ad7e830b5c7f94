// The depth maps' z-buffer: every image of a visual stage rasterized in
// one launch.
//
// Replaces no Pallas kernel: the JAX package rasterizes on the host, in
// numpy (pipeline/depth._zbuffer_host) or in its C++ runtime
// (global_lvba_tpu/native/lvba_native.cpp:688 lvba_zbuffer_ranges, body
// zbuf_accum at :634), because its TPU sat behind a remote link.  Here the
// grid map's voxel-grouped points (N, 3) are uploaded once and every image
// m reads its covisible voxels in place through CSR ranges
// starts[offsets[m] .. offsets[m + 1]) (int64 point offsets) and counts
// (int32), with its world->camera pose cams[m] = (Rcw row-major, tcw) cast
// to float32 as zbuf_cam does.
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
// a float32 tie, and a form the plain torch version computes too.  Z is
// positive, so its bits ordered as an int are its order as a float:
// atomicMin on the bits gives the exact minimum in any order, and the
// maps are bitwise repeatable and bitwise zbuffer_plain's (the plain torch
// version in kernels/zbuffer.py).  A plain read of the pixel first skips
// the atomic when the map already holds a nearer depth (values only fall,
// so a stale read never skips a needed update).
//
// Three kernels on the caller's stream: the fill of (M, H, W) with +inf,
// the rasterization, and the finish (inf -> 0).  Grid: blockIdx.y an image
// (at most 65,535 a launch; the launcher walks larger M in slices),
// blockIdx.x a run of kRangesPerBlock of its ranges, a warp a range at a
// time with its lanes over the range's points (a voxel holds tens to
// hundreds of points).  Bound: operations, ~50 a covisible point, twelve
// of them float64 (the points, 12 B each, are read once per image that
// sees them, but the map's 24 MB stay in the 50 MB L2); the bytes that
// must move are the points and ranges once and the maps once.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lvba_error.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRangesPerBlock = 64;
constexpr int kFillThreads = 256;
constexpr unsigned kMaxImagesPerLaunch = 65535;
constexpr int kInfBits = 0x7f800000;

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

__global__ void zbuffer_fill_kernel(int* __restrict__ depth, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    depth[i] = kInfBits;
}

__global__ void __launch_bounds__(kThreads)
zbuffer_kernel(const float* __restrict__ pts,
               const int64_t* __restrict__ starts,
               const int* __restrict__ counts,
               const int64_t* __restrict__ offsets,
               const float* __restrict__ cams, int m0, Intrinsics in,
               int* __restrict__ depth) {
  const int m = m0 + static_cast<int>(blockIdx.y);
  const int64_t r_first = offsets[m];
  const int64_t r_end = offsets[m + 1];
  const int64_t r0 = r_first + (int64_t)blockIdx.x * kRangesPerBlock;
  if (r0 >= r_end) return;
  const int64_t r1 =
      r_end < r0 + kRangesPerBlock ? r_end : r0 + kRangesPerBlock;
  const float* c = cams + 12 * (int64_t)m;
  const float R00 = __ldg(c + 0), R01 = __ldg(c + 1), R02 = __ldg(c + 2);
  const float R10 = __ldg(c + 3), R11 = __ldg(c + 4), R12 = __ldg(c + 5);
  const float R20 = __ldg(c + 6), R21 = __ldg(c + 7), R22 = __ldg(c + 8);
  const float t0 = __ldg(c + 9), t1 = __ldg(c + 10), t2 = __ldg(c + 11);
  const float p1x2 = __fmul_rn(2.0f, in.p1), p2x2 = __fmul_rn(2.0f, in.p2);
  const float Wf = static_cast<float>(in.W), Hf = static_cast<float>(in.H);
  int* img = depth + (int64_t)m * in.H * in.W;
  const int lane = threadIdx.x & 31;
  for (int64_t r = r0 + (threadIdx.x >> 5); r < r1; r += kWarps) {
    const float* q0 = pts + 3 * __ldg(starts + r);
    const int cnt = __ldg(counts + r);
    for (int i = lane; i < cnt; i += 32) {
      const float px = __ldg(q0 + 3 * i), py = __ldg(q0 + 3 * i + 1),
                  pz = __ldg(q0 + 3 * i + 2);
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
          __fadd_rn(__fmul_rn(x, radial), __fmul_rn(__fmul_rn(p1x2, x), y)),
          __fmul_rn(in.p2, __fadd_rn(r2, __fmul_rn(__fmul_rn(2.0f, x), x))));
      // y * radial + p1 (r2 + 2 y y) + 2 p2 x y, left to right
      const float yd = __fadd_rn(
          __fadd_rn(__fmul_rn(y, radial),
                    __fmul_rn(in.p1,
                              __fadd_rn(r2, __fmul_rn(__fmul_rn(2.0f, y), y)))),
          __fmul_rn(__fmul_rn(p2x2, x), y));
      const float uf = __fadd_rn(__fmul_rn(in.fx, xd), in.cx);
      const float vf = __fadd_rn(__fmul_rn(in.fy, yd), in.cy);
      if (!isfinite(uf) || !isfinite(vf)) continue;
      // truncation toward zero: uf in (-1, 0) lands on pixel 0
      if (uf <= -1.0f || uf >= Wf || vf <= -1.0f || vf >= Hf) continue;
      const int u = __float2int_rz(uf), v = __float2int_rz(vf);
      if (u < 0 || u >= in.W || v < 0 || v >= in.H) continue;
      int* d = img + (int64_t)v * in.W + u;
      const int zb = __float_as_int(Z);
      if (zb < *d) atomicMin(d, zb);
    }
  }
}

__global__ void zbuffer_finish_kernel(float* __restrict__ depth, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    if (!isfinite(depth[i])) depth[i] = 0.0f;
}

unsigned fill_blocks(int64_t n) {
  const int64_t b = (n + kFillThreads - 1) / kFillThreads;
  return static_cast<unsigned>(b < 132 * 32 ? (b > 0 ? b : 1) : 132 * 32);
}

}  // namespace

// depth (M, H, W) float32 from the points (N, 3) float32, the images'
// ranges (starts int64, counts int32, offsets (M + 1) int64; max_ranges
// the most ranges of one image) and poses cams (M, 12) float32.
extern "C" int lvba_zbuffer(const float* pts, const int64_t* starts,
                            const int* counts, const int64_t* offsets, int M,
                            int max_ranges, const float* cams, float fx,
                            float fy, float cx, float cy, float k1, float k2,
                            float p1, float p2, int W, int H, float* depth,
                            void* stream) {
  if (M <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = (int64_t)M * H * W;
  zbuffer_fill_kernel<<<fill_blocks(n), kFillThreads, 0, s>>>(
      reinterpret_cast<int*>(depth), n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const Intrinsics in{fx, fy, cx, cy, k1, k2, p1, p2, W, H};
  const unsigned bx = static_cast<unsigned>(
      (static_cast<int64_t>(max_ranges) + kRangesPerBlock - 1) /
      kRangesPerBlock);
  if (bx > 0) {
    for (int m0 = 0; m0 < M; m0 += kMaxImagesPerLaunch) {
      const unsigned by =
          static_cast<unsigned>(M - m0) < kMaxImagesPerLaunch
              ? static_cast<unsigned>(M - m0)
              : kMaxImagesPerLaunch;
      zbuffer_kernel<<<dim3(bx, by), kThreads, 0, s>>>(
          pts, starts, counts, offsets, cams, m0, in,
          reinterpret_cast<int*>(depth));
      e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  zbuffer_finish_kernel<<<fill_blocks(n), kFillThreads, 0, s>>>(depth, n);
  return static_cast<int>(cudaGetLastError());
}
