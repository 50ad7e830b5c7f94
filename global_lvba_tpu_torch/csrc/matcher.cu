// Kernel 6: the descriptor matcher's running top-2 similarity.
//
// top2_pass_kernel replaces global_lvba_tpu/ops/pallas/matcher.py:30
// `_top2_kernel` (via `_top2_pass`, :65, and `top2_similarity`, :104).
// For each pair p of a list, rows of A[ia[p]] (K1, D) against rows of
// B[ib[p]] (K2, D): sim = a·b in fp32 FMA, set to -2 where the row or the
// column is invalid; per row the top-2 values and the argmax column, per
// column the argmax row (the mutual-best test).  The TPU ran the kernel
// twice with the roles swapped; here one pass computes each product once:
// every block also writes, per column, the best row among its own rows
// (a per-row-tile partial), and col_reduce_kernel reduces the partials.
//
// Design.  A block owns kTile rows of one pair and walks every column tile
// in a loop (the TPU's sequential grid axis j, whose carry lived in the
// output block): nothing is carried between blocks.  The tile product is a
// plain register-tiled SGEMM: 256 threads as 16 x 16, each thread kMicro x
// kMicro outputs (rows ty + 16·i, columns tx + 16·j), the k dimension in
// slices of kK staged through shared memory.  Every dot product is one
// sequential FMA chain over k = 0..D-1, symmetric in its two operands, so
// the swapped pass sees exactly the transposed matrix.
//
// Ties.  A state (best, index, second) merges with another by: the larger
// best wins, on equal values the lower index; second = max(min(best1,
// best2), max(second1, second2)), so a value equal to the best becomes the
// second.  The merge is associative and commutative, so the per-thread
// scan, the shuffle butterfly over the 16 threads of a row and the carry
// across column tiles (a later tile has higher indices, so it wins only on
// a strict >) all give the global lowest index, as argmax and lax.top_k.
//
// The column side keeps the same rules: within a tile a column's best row
// is merged by (value, lower row); col_reduce_kernel walks the row tiles
// in order and takes a later tile only on a strict >.
//
// Ragged edges are masked: rows >= K1 are not written and take no part in
// a column's argmax, columns >= K2 take no part; any K1, K2 >= 1 and any
// D.
//
// Invalid tails.  Only valid slots need a product.  Each block scans the
// two masks of its pair for the last valid row and column (extraction
// ranks valid slots first, so invalid ones trail), walks the column tiles
// up to the last valid column only, and a block whose rows all lie past
// the last valid row computes nothing.  What they skip is all -2, so it is
// merged in closed form: the skipped columns as one (-2 at their lowest
// index, second -2 if there are two or more), the skipped rows as -2 at
// the row tile's first row in every column partial.  The outputs are those
// of the full walk, bit for bit, for any masks.
//
// A pair whose index lies outside its stack (ia >= N1 or ib >= N2, or
// < 0) reads nothing: its rows get vals NaN and idx -1, its columns
// colarg -1.
//
// Bound: operations — 2·D FLOP per (valid row, valid column) at the fp32
// rate; the inputs are read once per column tile from L2, the outputs are
// 12 B per row, 4 B per column and 8 B per (row tile, column) partial.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lvba_error.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 16;               // threads per tile side
constexpr int kMicro = 8;               // outputs per thread per side
constexpr int kTile = kSide * kMicro;   // 128 rows x 128 columns
constexpr int kK = 8;                   // k slice staged in shared memory
constexpr int kWarps = kThreads / 32;
constexpr float kInvalid = -2.0f;       // below any dot of unit vectors
constexpr int kReduceThreads = 256;

struct Top2 {
  float best, second;
  int idx;
};

// (value, index) of a single best: the larger value, on ties the lower
// index
__device__ __forceinline__ void take_best(float& b, int& bi, float v, int i) {
  if (v > b || (v == b && i < bi)) {
    b = v;
    bi = i;
  }
}

__device__ __forceinline__ void merge(Top2& s, float ob, int oi, float os) {
  const bool take = ob > s.best || (ob == s.best && oi < s.idx);
  const float second = fmaxf(fminf(s.best, ob), fmaxf(s.second, os));
  if (take) {
    s.best = ob;
    s.idx = oi;
  }
  s.second = second;
}

// 1 + the last index k < K with v[k] != 0 (0 if none), over the block
__device__ int valid_end(const uint8_t* __restrict__ v, int K, int* red) {
  int m = 0;
  for (int k = threadIdx.x; k < K; k += kThreads)
    if (v[k] != 0) m = k + 1;
  m = __reduce_max_sync(0xffffffffu, m);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  int out = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) out = max(out, red[w]);
  __syncthreads();
  return out;
}

// this block's partials for columns [c_begin, K2): every row of the tile
// gives (value, row0), as for a column of one value
__device__ void fill_partials(float* part_val, int* part_idx, int64_t o0,
                              int c_begin, int K2, float value, int row0) {
  for (int c = c_begin + threadIdx.x; c < K2; c += kThreads) {
    part_val[o0 + c] = value;
    part_idx[o0 + c] = row0;
  }
}

// at most 128 registers a thread: two blocks per SM, so a chunk of 16
// pairs at K = 2,048 (256 blocks) runs in one wave on 132 SMs
__global__ void __launch_bounds__(kThreads, 2)
top2_pass_kernel(const float* __restrict__ A, const uint8_t* __restrict__ vA,
                 const int* __restrict__ ia, int N1,
                 const float* __restrict__ B, const uint8_t* __restrict__ vB,
                 const int* __restrict__ ib, int N2, int K1, int K2, int D,
                 float* __restrict__ vals, int* __restrict__ idx,
                 float* __restrict__ part_val, int* __restrict__ part_idx) {
  // rows padded by 4 floats: the transposed stores hit 32 distinct banks
  __shared__ float As[kK][kTile + 4];
  __shared__ float Bs[kK][kTile + 4];
  // per warp, per column of the tile: the best of the warp's rows
  __shared__ float cs_val[kWarps][kTile];
  __shared__ int cs_idx[kWarps][kTile];
  __shared__ int red[kWarps];
  const int p = blockIdx.y;
  const int row0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % kSide;
  const int ty = tid / kSide;
  const int64_t a_img = ia[p];
  const int64_t b_img = ib[p];
  const int64_t part0 = ((int64_t)p * gridDim.x + blockIdx.x) * K2;
  const int row_hi = min(row0 + kTile, K1);

  if (a_img < 0 || a_img >= N1 || b_img < 0 || b_img >= N2) {
    for (int r = row0 + tid; r < row_hi; r += kThreads) {
      const int64_t o = (int64_t)p * K1 + r;
      idx[o] = -1;
      vals[2 * o] = NAN;
      vals[2 * o + 1] = NAN;
    }
    fill_partials(part_val, part_idx, part0, 0, K2, NAN, -1);
    return;
  }
  const int a_end = vA == nullptr ? K1 : valid_end(vA + a_img * K1, K1, red);
  const int b_end = vB == nullptr ? K2 : valid_end(vB + b_img * K2, K2, red);
  if (row0 > 0 && row0 >= a_end) {
    // every row of this tile is invalid: its whole row is -2
    for (int r = row0 + tid; r < row_hi; r += kThreads) {
      const int64_t o = (int64_t)p * K1 + r;
      idx[o] = 0;
      vals[2 * o] = kInvalid;
      vals[2 * o + 1] = K2 > 1 ? kInvalid : -INFINITY;
    }
    fill_partials(part_val, part_idx, part0, 0, K2, kInvalid, row0);
    return;
  }
  // column tiles up to the last valid column (at least one tile); the
  // columns [col_stop, K2) are all invalid
  const int col_stop = min(K2, (max(b_end, 1) + kTile - 1) / kTile * kTile);
  const float* Ap = A + a_img * K1 * D;
  const float* Bp = B + b_img * K2 * D;

  const int lane = tid % 32;
  const int warp = tid / 32;
  bool rin[kMicro], rvalid[kMicro];
  Top2 st[kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int r = row0 + ty + kSide * i;
    rin[i] = r < K1;
    rvalid[i] = rin[i] && (vA == nullptr || vA[a_img * K1 + r] != 0);
    st[i].best = -INFINITY;
    st[i].second = -INFINITY;
    st[i].idx = 0;
  }

  for (int col0 = 0; col0 < col_stop; col0 += kTile) {
    float acc[kMicro][kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < D; k0 += kK) {
      // stage a (kTile x kK) slice of each operand, transposed
#pragma unroll
      for (int e = tid; e < kTile * kK; e += kThreads) {
        const int m = e / kK;
        const int kk = e % kK;
        const int k = k0 + kk;
        const int r = row0 + m;
        const int c = col0 + m;
        As[kk][m] = (r < K1 && k < D) ? Ap[(int64_t)r * D + k] : 0.0f;
        Bs[kk][m] = (c < K2 && k < D) ? Bp[(int64_t)c * D + k] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        float a[kMicro], b[kMicro];
#pragma unroll
        for (int i = 0; i < kMicro; ++i) a[i] = As[kk][ty + kSide * i];
#pragma unroll
        for (int j = 0; j < kMicro; ++j) b[j] = Bs[kk][tx + kSide * j];
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // this tile's top-2 per row: the thread's own columns, then a
    // butterfly over the 16 threads (lanes) that share the row
    bool cin[kMicro], cvalid[kMicro];
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int c = col0 + tx + kSide * j;
      cin[j] = c < K2;
      cvalid[j] = cin[j] && (vB == nullptr || vB[b_img * K2 + c] != 0);
    }
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      Top2 t;
      t.best = -INFINITY;
      t.second = -INFINITY;
      t.idx = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        if (!cin[j]) continue;
        const float v = (rvalid[i] && cvalid[j]) ? acc[i][j] : kInvalid;
        merge(t, v, col0 + tx + kSide * j, -INFINITY);
      }
#pragma unroll
      for (int off = kSide / 2; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, t.best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, t.idx, off);
        const float os = __shfl_xor_sync(0xffffffffu, t.second, off);
        merge(t, ob, oi, os);
      }
      merge(st[i], t.best, t.idx, t.second);
    }

    // this tile's best row per column: the thread's own rows, the other
    // half-warp (same columns, the next ty), then the 8 warps through
    // shared memory
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      float cb = -INFINITY;
      int ci = 0x7fffffff;
#pragma unroll
      for (int i = 0; i < kMicro; ++i) {
        if (!rin[i]) continue;
        const float v = (rvalid[i] && cvalid[j]) ? acc[i][j] : kInvalid;
        take_best(cb, ci, v, row0 + ty + kSide * i);
      }
      const float ob = __shfl_xor_sync(0xffffffffu, cb, 16);
      const int oi = __shfl_xor_sync(0xffffffffu, ci, 16);
      take_best(cb, ci, ob, oi);
      if (lane < 16) {
        cs_val[warp][tx + kSide * j] = cb;
        cs_idx[warp][tx + kSide * j] = ci;
      }
    }
    __syncthreads();
    if (tid < kTile && col0 + tid < K2) {
      float cb = cs_val[0][tid];
      int ci = cs_idx[0][tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) take_best(cb, ci, cs_val[w][tid], cs_idx[w][tid]);
      part_val[part0 + col0 + tid] = cb;
      part_idx[part0 + col0 + tid] = ci;
    }
    __syncthreads();
  }

  if (col_stop < K2) {
    // the skipped columns: -2 for every row, lowest index col_stop
    const float second = K2 - col_stop > 1 ? kInvalid : -INFINITY;
#pragma unroll
    for (int i = 0; i < kMicro; ++i) merge(st[i], kInvalid, col_stop, second);
    fill_partials(part_val, part_idx, part0, col_stop, K2, kInvalid, row0);
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int r = row0 + ty + kSide * i;
      if (r >= K1) continue;
      const int64_t o = (int64_t)p * K1 + r;
      idx[o] = st[i].idx;
      vals[2 * o] = st[i].best;
      vals[2 * o + 1] = st[i].second;
    }
  }
}

// colarg[p, c] from the (P, R, K2) partials: row tiles in order, a later
// tile only on a strict > (its rows have higher indices).
__global__ void __launch_bounds__(kReduceThreads)
col_reduce_kernel(const float* __restrict__ part_val,
                  const int* __restrict__ part_idx, int R, int K2,
                  int64_t total, int* __restrict__ colarg) {
  const int64_t t = (int64_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (t >= total) return;
  const int64_t p = t / K2;
  const int64_t c = t - p * K2;
  const int64_t base = p * R * K2 + c;
  float b = part_val[base];
  int bi = part_idx[base];
  for (int r = 1; r < R; ++r) {
    const float v = part_val[base + (int64_t)r * K2];
    if (v > b) {
      b = v;
      bi = part_idx[base + (int64_t)r * K2];
    }
  }
  colarg[t] = bi;
}

}  // namespace

// P pairs: rows of A[ia[p]] (K1, D) against B[ib[p]] (K2, D), A a stack
// of N1 sets and B of N2.  vA / vB (uint8 validity, (N1, K1) / (N2, K2))
// may be null (all valid).  Outputs vals (P, K1, 2), idx (P, K1), colarg
// (P, K2); part_val / part_idx are the caller's (P, ceil(K1 / 128), K2)
// scratch.  A pair index outside [0, N1) or [0, N2) gives NaN values and
// index -1 for that pair.
extern "C" int lvba_top2_similarity(const float* A, const uint8_t* vA,
                                    const int* ia, int N1, const float* B,
                                    const uint8_t* vB, const int* ib, int N2,
                                    int P, int K1, int K2, int D, float* vals,
                                    int* idx, int* colarg, float* part_val,
                                    int* part_idx, void* stream) {
  if (P == 0 || K1 == 0 || K2 == 0) return 0;
  const int R = (K1 + kTile - 1) / kTile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  top2_pass_kernel<<<dim3(R, P), kThreads, 0, s>>>(
      A, vA, ia, N1, B, vB, ib, N2, K1, K2, D, vals, idx, part_val, part_idx);
  const int64_t total = (int64_t)P * K2;
  col_reduce_kernel<<<static_cast<unsigned>((total + kReduceThreads - 1) /
                                            kReduceThreads),
                      kReduceThreads, 0, s>>>(part_val, part_idx, R, K2,
                                              total, colarg);
  return static_cast<int>(cudaGetLastError());
}
