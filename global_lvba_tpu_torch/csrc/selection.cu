// Kernels 4 and 5: the selections of the bucketed factor layout.
//
// table_select_kernel replaces global_lvba_tpu/ops/pallas/selection.py:44
// `_table_select_kernel`: out[e, c] = tbl[frame[e], c], a zero row for an
// id outside [0, P).  The TPU kernel built a one-hot tile in VMEM and
// multiplied three bf16 mantissa splits of the table to stay exact; on the
// card the selection is a plain copy, exact by construction.  Bound: bytes
// — 4 B of id in and 4·C B out per entry, no arithmetic.  One thread per
// output value (grid-stride): neighbouring threads write neighbouring
// floats (coalesced stores) and read the same or the next id; the small
// table is read through the read-only cache (__ldg).
//
// entry_reduce_kernel replaces selection.py:84 `_entry_reduce_kernel`:
// out[w, c] = Σ_j vals[tbl[w, j], c] over the frame-major (W, Kf) table of
// plane_eigen.buckets_frame_table.  The TPU kernel accumulated over a
// sequential grid in VMEM; blocks here run in no order, so each block owns
// one frame w.  A bucketed evaluation launches it once over all of its
// buckets: their entries share one vals buffer and one table.  The block's
// 512 threads are S = 512 / C entry slots of C threads (17 slots of 30 for
// the g/Hd channels: 510 busy threads, each warp's lanes on neighbouring
// values of one or two entries).  The block first copies a run of up to 512
// table indices to shared memory (coalesced), then slot s takes the run's
// entries s, s + S, ... in order, thread c of the slot channel c, with the
// loads unrolled four deep; the slots' sums are added in slot order by C
// threads.  Each output is one fixed-order sum, no atomics: bitwise
// repeatable.  An index outside [0, E) — the sentinel E — adds nothing.
// C above 512 goes in passes of 512 channels.  Bound: bytes — every live
// entry's C values read once, the table and the output.
//
// Both are templated on the value type: the launchers without a suffix
// take float (float32 solves), the _f64 ones double (float64 solves).
#include <cuda_runtime.h>
#include <stdint.h>

#include "lvba_error.cuh"

namespace {

constexpr int kSelectThreads = 256;
constexpr int kReduceThreads = 512;

template <typename T>
__global__ void __launch_bounds__(kSelectThreads)
table_select_kernel(const int* __restrict__ frame,
                    const T* __restrict__ tbl, int64_t E, int P, int C,
                    T* __restrict__ out) {
  const int64_t total = E * C;
  for (int64_t i = (int64_t)blockIdx.x * kSelectThreads + threadIdx.x;
       i < total; i += (int64_t)gridDim.x * kSelectThreads) {
    const int64_t e = i / C;
    const int c = static_cast<int>(i - e * C);
    const int f = __ldg(frame + e);
    out[i] = (f >= 0 && f < P) ? __ldg(tbl + (int64_t)f * C + c) : T(0.0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
entry_reduce_kernel(const T* __restrict__ vals,
                    const int* __restrict__ tbl, int64_t E, int C, int Kf,
                    T* __restrict__ out) {
  __shared__ int idx[kReduceThreads];
  __shared__ T red[kReduceThreads];
  const int t = threadIdx.x;
  const int* __restrict__ row = tbl + (int64_t)blockIdx.x * Kf;
  for (int c0 = 0; c0 < C; c0 += kReduceThreads) {
    const int cw = min(C - c0, kReduceThreads);  // channels this pass
    const int S = kReduceThreads / cw;           // entry slots
    const int slot = t / cw;
    const int c = c0 + t - slot * cw;
    T s = T(0.0);
    for (int j0 = 0; j0 < Kf; j0 += kReduceThreads) {
      const int nj = min(Kf - j0, kReduceThreads);
      __syncthreads();
      if (t < nj) idx[t] = __ldg(row + j0 + t);
      __syncthreads();
      if (slot < S) {
#pragma unroll 4
        for (int j = slot; j < nj; j += S) {
          const int e = idx[j];
          if (e >= 0 && e < E) s += vals[(int64_t)e * C + c];
        }
      }
    }
    red[t] = s;
    __syncthreads();
    if (t < cw) {
      T o = red[t];
      for (int k = 1; k < S; ++k) o += red[k * cw + t];
      out[(int64_t)blockIdx.x * C + c0 + t] = o;
    }
    __syncthreads();
  }
}

template <typename T>
int launch_select(const int* frame, const T* tbl, int64_t E, int P, int C,
                  T* out, void* stream) {
  const int64_t total = E * C;
  if (total == 0) return 0;
  int64_t blocks = (total + kSelectThreads - 1) / kSelectThreads;
  if (blocks > 65536) blocks = 65536;  // grid-stride beyond
  table_select_kernel<T><<<static_cast<unsigned>(blocks), kSelectThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(frame, tbl,
                                                                E, P, C, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_reduce(const T* vals, const int* tbl, int64_t E, int C, int W,
                  int Kf, T* out, void* stream) {
  if (W == 0 || C == 0) return 0;
  entry_reduce_kernel<T><<<W, kReduceThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(vals, tbl, E,
                                                                C, Kf, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lvba_table_select(const int* frame, const float* tbl,
                                 int64_t E, int P, int C, float* out,
                                 void* stream) {
  return launch_select(frame, tbl, E, P, C, out, stream);
}

extern "C" int lvba_table_select_f64(const int* frame, const double* tbl,
                                     int64_t E, int P, int C, double* out,
                                     void* stream) {
  return launch_select(frame, tbl, E, P, C, out, stream);
}

extern "C" int lvba_entry_reduce(const float* vals, const int* tbl, int64_t E,
                                 int C, int W, int Kf, float* out,
                                 void* stream) {
  return launch_reduce(vals, tbl, E, C, W, Kf, out, stream);
}

extern "C" int lvba_entry_reduce_f64(const double* vals, const int* tbl,
                                     int64_t E, int C, int W, int Kf,
                                     double* out, void* stream) {
  return launch_reduce(vals, tbl, E, C, W, Kf, out, stream);
}
