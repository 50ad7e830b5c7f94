// The colored clouds' z-buffer: each image's nearest LiDAR point per pixel,
// every image of a call in one launch.
//
// Replaces no Pallas kernel: the JAX package colorizes on the host in
// numpy (global_lvba_tpu/pipeline/outputs.py:81 colorize_clouds).  Image m
// projects the world points pts[lo[m] .. hi[m]) (its LiDAR window, a
// contiguous run of the frames' concatenated world points) through its
// pose cams[m] = (Rcw row-major, tcw) in float64, operation by operation
// as numpy rounds it: R p as numpy's BLAS forms it, the chain
// fma(R2, p2, fma(R1, p1, R0 p0)), then + t; every other product, sum and
// quotient rounded once (__dmul_rn, __dadd_rn, __ddiv_rn: nvcc would
// contract them); the Z > 1e-12 gate, the finite check, rint of the
// clipped pixel coordinates and the bounds check.  A pixel keeps the point
// of least Z, the least index among equal Z (numpy's stable lexsort of
// (Z, lin)): the first pass takes atomicMin on Z's bits (Z > 0, so its
// bits order as its value), the second, among the points at that Z,
// atomicMin on the index.  The pick map is bitwise repeatable and bitwise
// the plain version's (colorize_plain in kernels/colorize.py).
//
// Three kernels on the caller's stream: the fill of the maps, the two
// passes.  Grid: blockIdx.y an image (at most 65,535 a launch), blockIdx.x
// over its window, a thread a point (the window's points are contiguous,
// so a warp reads 768 contiguous bytes).  Bound: operations, 43 float64
// operations a window point (the second pass repeats the projection:
// storing it would move 12 bytes a point twice instead); the maps, 12
// bytes a pixel, stay in L2 for a few images at a time.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lvba_error.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxImagesPerLaunch = 65535;
constexpr int kNone = 0x7fffffff;
constexpr int kMaxBlocksX = 1024;   // a window walks its points in strides

struct Intrinsics {
  double fx, fy, cx, cy, k1, k2, p1, p2;
  int W, H;
};

// row r of R p + t as numpy's BLAS forms R p, then + t
__device__ __forceinline__ double rigid(const double* c, int r, double px,
                                        double py, double pz) {
  return __dadd_rn(
      __fma_rn(c[3 * r + 2], pz,
               __fma_rn(c[3 * r + 1], py, __dmul_rn(c[3 * r], px))),
      c[9 + r]);
}

// the pixel lin and depth Z of point p in image pose c; false where the
// point lands on no pixel
__device__ __forceinline__ bool project(const double* p, const double* c,
                                        const Intrinsics& in, int* lin,
                                        double* Zout) {
  const double px = p[0], py = p[1], pz = p[2];
  const double Z = rigid(c, 2, px, py, pz);
  if (!(Z > 1e-12)) return false;
  const double X = rigid(c, 0, px, py, pz);
  const double Y = rigid(c, 1, px, py, pz);
  const double x = __ddiv_rn(X, Z), y = __ddiv_rn(Y, Z);
  const double r2 = __dadd_rn(__dmul_rn(x, x), __dmul_rn(y, y));
  const double radial = __dadd_rn(__dadd_rn(1.0, __dmul_rn(in.k1, r2)),
                                  __dmul_rn(__dmul_rn(in.k2, r2), r2));
  // x radial + 2 p1 x y + p2 (r2 + 2 x x), left to right
  const double xd = __dadd_rn(
      __dadd_rn(__dmul_rn(x, radial),
                __dmul_rn(__dmul_rn(__dmul_rn(2.0, in.p1), x), y)),
      __dmul_rn(in.p2, __dadd_rn(r2, __dmul_rn(__dmul_rn(2.0, x), x))));
  // y radial + p1 (r2 + 2 y y) + 2 p2 x y, left to right
  const double yd = __dadd_rn(
      __dadd_rn(__dmul_rn(y, radial),
                __dmul_rn(in.p1,
                          __dadd_rn(r2, __dmul_rn(__dmul_rn(2.0, y), y)))),
      __dmul_rn(__dmul_rn(__dmul_rn(2.0, in.p2), x), y));
  if (!isfinite(xd) || !isfinite(yd)) return false;
  double uf = __dadd_rn(__dmul_rn(in.fx, xd), in.cx);
  double vf = __dadd_rn(__dmul_rn(in.fy, yd), in.cy);
  uf = fmin(fmax(uf, -1.0), static_cast<double>(in.W));
  vf = fmin(fmax(vf, -1.0), static_cast<double>(in.H));
  const int u = static_cast<int>(rint(uf)), v = static_cast<int>(rint(vf));
  if (u < 0 || u >= in.W || v < 0 || v >= in.H) return false;
  *lin = v * in.W + u;
  *Zout = Z;
  return true;
}

__global__ void colorize_fill_kernel(unsigned long long* __restrict__ zbits,
                                     int* __restrict__ idx, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    zbits[i] = ~0ULL;
    idx[i] = kNone;
  }
}

template <bool kSecond>
__global__ void __launch_bounds__(kThreads)
colorize_kernel(const double* __restrict__ pts, const int64_t* __restrict__ lo,
                const int64_t* __restrict__ hi,
                const double* __restrict__ cams, int m0, Intrinsics in,
                unsigned long long* __restrict__ zbits,
                int* __restrict__ idx) {
  const int m = m0 + static_cast<int>(blockIdx.y);
  const int64_t a = lo[m], b = hi[m];
  double c[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) c[k] = __ldg(cams + 12 * (int64_t)m + k);
  const int64_t HW = (int64_t)in.H * in.W;
  unsigned long long* zm = zbits + m * HW;
  int* im = idx + m * HW;
  for (int64_t i = a + blockIdx.x * (int64_t)kThreads + threadIdx.x; i < b;
       i += (int64_t)gridDim.x * kThreads) {
    int lin;
    double Z;
    if (!project(pts + 3 * i, c, in, &lin, &Z)) continue;
    const unsigned long long zb =
        static_cast<unsigned long long>(__double_as_longlong(Z));
    if (!kSecond) {
      if (zb < zm[lin]) atomicMin(zm + lin, zb);
    } else if (zb == zm[lin]) {
      atomicMin(im + lin, static_cast<int>(i));
    }
  }
}

unsigned fill_blocks(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < 132 * 32 ? (b > 0 ? b : 1) : 132 * 32);
}

}  // namespace

// idx (M, H * W) int32: each pixel's picked point (kNone where none), with
// zbits (M, H * W) as scratch, from pts (N, 3) float64, the windows lo, hi
// (M,) int64 (max_n at least the longest: it sizes the grid) and the poses
// cams (M, 12) float64.
extern "C" int lvba_colorize(const double* pts, const int64_t* lo,
                             const int64_t* hi, const double* cams, int M,
                             int max_n, double fx, double fy, double cx,
                             double cy, double k1, double k2, double p1,
                             double p2, int W, int H, int64_t* zbits,
                             int* idx, void* stream) {
  if (M <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = (int64_t)M * H * W;
  unsigned long long* zb = reinterpret_cast<unsigned long long*>(zbits);
  colorize_fill_kernel<<<fill_blocks(n), kThreads, 0, s>>>(zb, idx, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (max_n <= 0) return 0;
  const Intrinsics in{fx, fy, cx, cy, k1, k2, p1, p2, W, H};
  int64_t bx = ((int64_t)max_n + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  for (int pass = 0; pass < 2; ++pass) {
    for (int m0 = 0; m0 < M; m0 += kMaxImagesPerLaunch) {
      const unsigned by = static_cast<unsigned>(M - m0) < kMaxImagesPerLaunch
                              ? static_cast<unsigned>(M - m0)
                              : kMaxImagesPerLaunch;
      const dim3 grid(static_cast<unsigned>(bx), by);
      if (pass == 0)
        colorize_kernel<false><<<grid, kThreads, 0, s>>>(pts, lo, hi, cams,
                                                         m0, in, zb, idx);
      else
        colorize_kernel<true><<<grid, kThreads, 0, s>>>(pts, lo, hi, cams,
                                                        m0, in, zb, idx);
      e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  return 0;
}
