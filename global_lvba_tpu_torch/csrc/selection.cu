// Kernels 4 and 5: the selections of the bucketed factor layout.
//
// table_select_kernel replaces global_lvba_tpu/ops/pallas/selection.py:44
// `_table_select_kernel`: out[e, c] = tbl[frame[e], c], a zero row for an
// id outside [0, P).  The TPU kernel built a one-hot tile in VMEM and
// multiplied three bf16 mantissa splits of the table to stay exact; on the
// card the selection is a plain copy, exact by construction.  Bound: bytes
// — 4 B of id in and 4·C (8·C) B out per entry, no arithmetic.  One launch
// takes all of an evaluation's buckets (up to kMaxSelectBuckets) through
// a table passed by value as the kernel's parameter, as soa_agg's does:
// each bucket's id pointer, entry count and first row in the one output
// (ΣE, C); a block finds its bucket from the buckets' first blocks.  One
// thread per 16-byte chunk of an output row (a pose row is 48 B in float,
// 96 in double, so every row starts 16-byte aligned): its id once, one
// 16-byte load of the table through the read-only path (the (P, C) table,
// 24 KB at P = 512, stays in the L1 and L2), one 16-byte store, in 32-bit
// index arithmetic with no 64-bit division.
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
constexpr int kMaxSelectBuckets = 16;
constexpr int kReduceThreads = 512;

struct SelectLaunch {
  const int* frame[kMaxSelectBuckets];
  int E[kMaxSelectBuckets];
  int row0[kMaxSelectBuckets];       // the bucket's first output row
  int first[kMaxSelectBuckets + 1];  // its first block; first[nb]: grid
  int nb;
};

template <typename T>
__global__ void __launch_bounds__(kSelectThreads)
table_select_kernel(const SelectLaunch L, const T* __restrict__ tbl, int P,
                    int C, T* __restrict__ out) {
  int b = 0;
  while (b + 1 < L.nb && static_cast<int>(blockIdx.x) >= L.first[b + 1]) ++b;
  const int q = C * static_cast<int>(sizeof(T)) / 16;  // chunks a row
  const int i =
      (static_cast<int>(blockIdx.x) - L.first[b]) * kSelectThreads +
      static_cast<int>(threadIdx.x);
  if (i >= L.E[b] * q) return;
  const int e = i / q;
  const int j = i - e * q;
  const int f = __ldg(L.frame[b] + e);
  int4 v = make_int4(0, 0, 0, 0);
  if (f >= 0 && f < P)
    v = __ldg(reinterpret_cast<const int4*>(tbl + f * C) + j);
  reinterpret_cast<int4*>(out + (L.row0[b] + e) * C)[j] = v;
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

// nb <= kMaxSelectBuckets buckets, bucket i given by the i-th entry of
// each array; C·sizeof(T) a multiple of 16, tbl and out 16-byte aligned,
// (Σ E)·C < 2^31.
template <typename T>
int launch_select(int nb, const int* const* frame, const int* E,
                  const int* row0, const T* tbl, int P, int C, T* out,
                  void* stream) {
  if (nb < 1 || nb > kMaxSelectBuckets || C < 1 ||
      (C * sizeof(T)) % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(tbl) | reinterpret_cast<uintptr_t>(out)) &
          15)
    return static_cast<int>(cudaErrorInvalidValue);
  SelectLaunch L;
  L.nb = nb;
  const int q = C * static_cast<int>(sizeof(T)) / 16;
  int blocks = 0;
  for (int i = 0; i < nb; ++i) {
    L.frame[i] = frame[i];
    L.E[i] = E[i];
    L.row0[i] = row0[i];
    L.first[i] = blocks;
    blocks += (E[i] * q + kSelectThreads - 1) / kSelectThreads;
  }
  L.first[nb] = blocks;
  if (blocks == 0) return 0;
  table_select_kernel<T><<<blocks, kSelectThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(L, tbl, P, C,
                                                                out);
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

// The selection of nb buckets' ids into one (Σ E, C) output (bucket i's
// rows from row0[i]), one launch.
extern "C" int lvba_table_select(int nb, const int* const* frame,
                                 const int* E, const int* row0,
                                 const float* tbl, int P, int C, float* out,
                                 void* stream) {
  return launch_select(nb, frame, E, row0, tbl, P, C, out, stream);
}

extern "C" int lvba_table_select_f64(int nb, const int* const* frame,
                                     const int* E, const int* row0,
                                     const double* tbl, int P, int C,
                                     double* out, void* stream) {
  return launch_select(nb, frame, E, row0, tbl, P, C, out, stream);
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
