// Kernel 3: gram (N, N) += AᵀA for A (Kr, N) row-major, float32
// (replaces global_lvba_tpu/ops/pallas/gram.py:41 `_syrk_kernel`).
//
// One block of 16x16 threads per lower-triangle 64x64 output tile
// (ti >= tj).  The block loops over the whole contraction in chunks of 16
// rows of A staged in shared memory, in a fixed order (no split-K, no
// atomics), each thread holding a 4x4 register tile of sums over plain
// fp32 FMAs.  The block adds its tile to gram and, off the diagonal, the
// transposed tile too: the mirror is written by the same launch, and the
// diagonal tiles are exactly symmetric (the same products summed in the
// same order), so the result is the full symmetric matrix.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lvba_error.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kDepth = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
syrk_kernel(const float* __restrict__ A, int Kr, int N,
            float* __restrict__ G) {
  // block -> lower-triangle tile (ti, tj), ti >= tj, row-major over ti
  const int b = blockIdx.x;
  int ti = static_cast<int>((sqrtf(8.0f * b + 1.0f) - 1.0f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= b) ++ti;
  while (ti * (ti + 1) / 2 > b) --ti;
  const int tj = b - ti * (ti + 1) / 2;
  const int i0 = ti * kTile, j0 = tj * kTile;

  __shared__ float As[kDepth][kTile];  // A[k, i0 + c]
  __shared__ float Bs[kDepth][kTile];  // A[k, j0 + c]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  for (int k0 = 0; k0 < Kr; k0 += kDepth) {
#pragma unroll
    for (int l = threadIdx.x; l < kDepth * kTile; l += kThreads) {
      const int kk = l / kTile, c = l % kTile;
      const int k = k0 + kk;
      const bool krow = k < Kr;
      const float* row = A + (int64_t)k * N;
      As[kk][c] = (krow && i0 + c < N) ? row[i0 + c] : 0.f;
      Bs[kk][c] = (krow && j0 + c < N) ? row[j0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float a[4], bb[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = As[kk][ty + 16 * q];
        bb[q] = Bs[kk][tx + 16 * q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], bb[q], acc[p][q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = i0 + ty + 16 * p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx + 16 * q;
      if (i < N && j < N) {
        G[(int64_t)i * N + j] += acc[p][q];
        if (ti != tj) G[(int64_t)j * N + i] += acc[p][q];
      }
    }
  }
}

}  // namespace

extern "C" int lvba_syrk(const float* A, int Kr, int N, float* G,
                         void* stream) {
  const int nt = (N + kTile - 1) / kTile;
  const int blocks = nt * (nt + 1) / 2;
  syrk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, Kr, N, G);
  return static_cast<int>(cudaGetLastError());
}
