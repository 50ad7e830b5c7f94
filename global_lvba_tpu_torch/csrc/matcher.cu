// Kernel 6: the descriptor matcher's running top-2 similarity.
//
// top2_unit_kernel + top2_reduce_kernel replace
// global_lvba_tpu/ops/pallas/matcher.py:30 `_top2_kernel` (via `_top2_pass`,
// :65, and `top2_similarity`, :104).  For each pair p of a list, rows of
// A[ia[p]] (K1, D) against rows of B[ib[p]] (K2, D): sim = a·b, set to -2
// where the row or the column is invalid; per row the top-2 values and the
// argmax column, per column the argmax row (the mutual-best test).  The
// TPU ran the kernel twice with the roles swapped; here each product is
// computed once and feeds both the row and the column side.
//
// Products: 3xTF32 on the tensor cores, the counterpart of fp32.  Each
// operand value a is split in registers into hi = tf32(a) and lo =
// tf32(a - hi) (round to nearest, ties away, bit for bit cvt.rna as
// kernels/gram.tf32_split; done by two integer ops, which issue faster
// than the conversion), and a·b ≈ lo·hi + hi·lo + hi·hi by
// mma.sync.m16n8k8.tf32; the dropped lo·lo and lo's own rounding are
// ~2^-22 of |a|·|b|.  Each k8 step's three products go into a fresh
// accumulator that is added to the running sum in fp32: the tensor cores'
// own accumulation does not round to nearest, and summed over a whole
// contraction it lands far above fp32's error (csrc/syrk.cu).  Both
// operands are K-major as stored (descriptors (K, D), D contiguous), so a
// k-slice of 32 of each is copied by cp.async into a 3-stage ring of
// shared memory, rows padded to 36 floats so every ldmatrix row lands on
// its own banks; one ldmatrix.x4 gives an A fragment or two B fragments.
//
// Work units.  A block takes one unit: (pair, row tile of 128, column range
// of 256), walking the range's column tiles of 64 with 8 warps (4 x 2,
// 32 x 32 outputs each), two blocks per SM under a 128-register cap: the
// mma.sync chains wait on latency, and one block per SM of the same tile
// ran slower.  A chunk of 16 pairs at K = 2,048 is 2,048 units of equal
// size, against the 256 unequal blocks of a one-wave grid that each walked
// every column tile of a pair.  Each unit writes row partials (best,
// second, index over its columns) and column partials (best row over its
// rows); top2_reduce_kernel merges them in a fixed order (column ranges in
// order per row, row tiles in order per column).  Every product is
// computed by one unit in the same k order whatever else shares the
// launch, so the outputs are bitwise repeatable and a pair's outputs do
// not depend on its chunk.
//
// Ties.  A state (best, index, second) merges with another by: the larger
// best wins, on equal values the lower index; second = max(min(best1,
// best2), max(second1, second2)), so a value equal to the best becomes the
// second.  The merge computes the top-2 of the union of what the two
// states have seen, so it is associative and commutative and every order
// of merging gives the global lowest index, as argmax and lax.top_k.  The
// column side takes the best (value, lower row) the same way.
//
// Ragged edges are masked: rows >= K1 are not written and take no part in
// a column's argmax, columns >= K2 take no part; any K1, K2 >= 1 and any
// D (D % 4 != 0 or an unaligned stack loads by 4 bytes instead of 16).
//
// Invalid tails.  Only valid slots need a product.  Each unit scans the
// two masks of its pair for the last valid row and column (extraction
// ranks valid slots first, so invalid ones trail).  A unit whose rows or
// columns all lie past them computes nothing, and a live unit stops at
// the column tile holding the last valid column.  What they skip is all
// -2, so it is merged in closed form: a row over skipped columns as one
// (-2 at their lowest index, second -2 if there are two or more), a
// column over skipped rows as -2 at the unit's first row.  The outputs are
// those of a full walk, bit for bit, for any masks.
//
// A pair whose index lies outside its stack (ia >= N1 or ib >= N2, or
// < 0) reads nothing: its rows get vals NaN and idx -1, its columns
// colarg -1.
//
// Bound: operations — 3 TF32 products of 2·D flops per (valid row, valid
// column) at the TF32 rate (the fp32 bound, 2·D flops at the fp32 rate,
// is printed beside it); the inputs are read once per unit from L2, the
// partials are 12 B per (row, column range) and 8 B per (row tile,
// column).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lvba_error.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 128;                 // rows of a unit
constexpr int kBN = 64;                  // columns of a column tile
constexpr int kUnitCols = 4 * kBN;       // columns of a unit
constexpr int kBK = 32;                  // k slice of a ring stage
constexpr int kLd = kBK + 4;             // padded row of a stage, floats
constexpr int kStages = 3;
constexpr int kStageFloats = (kBM + kBN) * kLd;
constexpr int kSmemBytes = kStages * kStageFloats * 4;   // 82,944
constexpr int kWarpsM = 4;               // warps along rows
constexpr int kWarpsN = 2;               // warps along columns
constexpr int kFragM = 2;                // m16 fragments of a warp
constexpr int kFragN = 4;                // n8 fragments of a warp
constexpr int kWarpRows = kFragM * 16;
constexpr int kWarpCols = kFragN * 8;
constexpr int kMinBlocks = 2;            // blocks per SM: 128 registers
static_assert(kWarpsM * kWarpRows == kBM && kWarpsN * kWarpCols == kBN &&
                  kWarpsM * kWarpsN == kWarps && kBM <= kThreads &&
                  kBN <= kThreads && kUnitCols % kBN == 0,
              "tile shape");
constexpr float kInvalid = -2.0f;        // below any dot of unit vectors
constexpr int kReduceThreads = 256;

struct Top2 {
  float best, second;
  int idx;
};

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

// cvt.rna.tf32.f32 of a finite value by two integer ops: the magnitude
// rounded to 10 explicit mantissa bits, ties away from zero (the
// conversion instruction itself costs more issue time than the mma.sync)
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// x (as bits) -> hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__float_as_uint(__uint_as_float(x) - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a·b with a zero accumulator
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 4 fp32 tiles of shared memory into fragments: lane l gives the
// address of row l % 8 of tile l / 8 and receives word (l / 4, l % 4) of
// each tile, the m16n8k8 tf32 fragment layout
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16 bytes, zero-filled where src_bytes == 0
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
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

// one operand's (kRows x kBK) k-slice, rows [row0, row0 + kRows) of a
// (K, D) set, into a stage; rows >= K and k >= D are zero-filled
template <bool kVec, int kRows>
__device__ __forceinline__ void load_slice(float* dst,
                                           const float* __restrict__ src,
                                           int row0, int K, int D, int k0) {
  if (kVec) {
#pragma unroll
    for (int i = 0; i < kRows * kBK / 4 / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int m = e / (kBK / 4);
      const int k = k0 + (e % (kBK / 4)) * 4;
      const bool in = row0 + m < K && k < D;
      const float* s = in ? src + (int64_t)(row0 + m) * D + k : src;
      cp_async16(dst + m * kLd + (k - k0), s, in ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kRows * kBK / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int m = e / kBK;
      const int k = k0 + e % kBK;
      const bool in = row0 + m < K && k < D;
      const float* s = in ? src + (int64_t)(row0 + m) * D + k : src;
      cp_async4(dst + m * kLd + (k - k0), s, in ? 4 : 0);
    }
  }
}

// One work unit per block: (pair p, row tile rt, column range cu).
// Partials: row_val (P, C, K1, 2) [best, second], row_idx (P, C, K1);
// col_val / col_idx (P, R, K2).
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
top2_unit_kernel(const float* __restrict__ A, const uint8_t* __restrict__ vA,
                 const int* __restrict__ ia, int N1,
                 const float* __restrict__ B, const uint8_t* __restrict__ vB,
                 const int* __restrict__ ib, int N2, int K1, int K2, int D,
                 int R, int C, float* __restrict__ row_val,
                 int* __restrict__ row_idx, float* __restrict__ col_val,
                 int* __restrict__ col_idx) {
  extern __shared__ __align__(16) float ring[];
  __shared__ float cs_val[kWarpsM][kBN];
  __shared__ int cs_idx[kWarpsM][kBN];
  __shared__ float rs_best[kWarpsN][kBM];
  __shared__ float rs_second[kWarpsN][kBM];
  __shared__ int rs_idx[kWarpsN][kBM];
  __shared__ int red[kWarps];

  const int tid = threadIdx.x;
  const int unit = blockIdx.x;
  const int p = unit / (R * C);
  const int rt = unit / C % R;
  const int cu = unit % C;
  const int r_lo = rt * kBM;
  const int r_hi = min(r_lo + kBM, K1);
  const int c_lo = cu * kUnitCols;
  const int c_hi = min(c_lo + kUnitCols, K2);
  const int64_t row_o = ((int64_t)p * C + cu) * K1;   // + r
  const int64_t col_o = ((int64_t)p * R + rt) * K2;   // + c
  const int64_t a_img = ia[p];
  const int64_t b_img = ib[p];

  if (a_img < 0 || a_img >= N1 || b_img < 0 || b_img >= N2) {
    for (int r = r_lo + tid; r < r_hi; r += kThreads) {
      row_val[2 * (row_o + r)] = NAN;
      row_val[2 * (row_o + r) + 1] = NAN;
      row_idx[row_o + r] = -1;
    }
    for (int c = c_lo + tid; c < c_hi; c += kThreads) {
      col_val[col_o + c] = NAN;
      col_idx[col_o + c] = -1;
    }
    return;
  }
  const uint8_t* va = vA == nullptr ? nullptr : vA + a_img * K1;
  const uint8_t* vb = vB == nullptr ? nullptr : vB + b_img * K2;
  const int a_end = va == nullptr ? K1 : valid_end(va, K1, red);
  const int b_end = vb == nullptr ? K2 : valid_end(vb, K2, red);

  if (r_lo >= a_end || c_lo >= b_end) {
    // every entry of the unit is -2
    const float second = c_hi - c_lo > 1 ? kInvalid : -INFINITY;
    for (int r = r_lo + tid; r < r_hi; r += kThreads) {
      row_val[2 * (row_o + r)] = kInvalid;
      row_val[2 * (row_o + r) + 1] = second;
      row_idx[row_o + r] = c_lo;
    }
    for (int c = c_lo + tid; c < c_hi; c += kThreads) {
      col_val[col_o + c] = kInvalid;
      col_idx[col_o + c] = r_lo;
    }
    return;
  }
  // column tiles up to the one holding the last valid column; the
  // columns [c_stop, c_hi) are all invalid
  const int n_ct = (min(c_hi, b_end) - c_lo + kBN - 1) / kBN;
  const int c_stop = min(c_hi, c_lo + n_ct * kBN);
  const int n_kt = max(1, (D + kBK - 1) / kBK);
  const int n_stages = n_ct * n_kt;
  const float* Ap = A + a_img * K1 * D;
  const float* Bp = B + b_img * K2 * D;

  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp % kWarpsM;
  const int wn = warp / kWarpsM;
  const int g = lane / 4;
  const int t = lane % 4;
  // this lane's ldmatrix row in a stage: an A fragment is the tiles (rows
  // +0 / +8) x (k +0 / +4), a pair of B fragments (n8 +0 / +8) x (k +0 /
  // +4)
  const int a_lane = (wm * kWarpRows + lane % 8 + 8 * (lane / 8 % 2)) * kLd +
                     4 * (lane / 16);
  const int b_lane = (wn * kWarpCols + lane % 8 + 8 * (lane / 16)) * kLd +
                     4 * (lane / 8 % 2);

  // this thread's rows: r_lo + wm·kWarpRows + i·16 + g + 8h, bit 2i + h
  uint32_t rin = 0, rvalid = 0;
#pragma unroll
  for (int s = 0; s < 2 * kFragM; ++s) {
    const int r = r_lo + wm * kWarpRows + (s / 2) * 16 + g + 8 * (s % 2);
    if (r < K1) {
      rin |= 1u << s;
      if (va == nullptr || va[r] != 0) rvalid |= 1u << s;
    }
  }
  // the running row state of row r_lo + tid (threads tid < kBM), merged
  // from each column tile's per-row top-2
  Top2 run{-INFINITY, -INFINITY, 0x7fffffff};

  float acc[kFragM][kFragN][4];
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  auto issue = [&](int s) {
    if (s < n_stages) {
      float* As = ring + (s % kStages) * kStageFloats;
      const int col0 = c_lo + (s / n_kt) * kBN;
      const int k0 = (s % n_kt) * kBK;
      load_slice<kVec, kBM>(As, Ap, r_lo, K1, D, k0);
      load_slice<kVec, kBN>(As + kBM * kLd, Bp, col0, K2, D, k0);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(s + kStages - 1);
    const float* As = ring + (s % kStages) * kStageFloats;
    const float* Bs = As + kBM * kLd;
#pragma unroll
    for (int k8 = 0; k8 < kBK / 8; ++k8) {
      uint32_t bhi[kFragN][2], blo[kFragN][2];
#pragma unroll
      for (int j = 0; j < kFragN; j += 2) {
        uint32_t w[4];
        ldsm_x4(w, Bs + b_lane + j * 8 * kLd + k8 * 8);
        split(w[0], bhi[j][0], blo[j][0]);
        split(w[1], bhi[j][1], blo[j][1]);
        split(w[2], bhi[j + 1][0], blo[j + 1][0]);
        split(w[3], bhi[j + 1][1], blo[j + 1][1]);
      }
#pragma unroll
      for (int i = 0; i < kFragM; ++i) {
        uint32_t ahi[4], alo[4], w[4];
        ldsm_x4(w, As + a_lane + i * 16 * kLd + k8 * 8);
#pragma unroll
        for (int c = 0; c < 4; ++c) split(w[c], ahi[c], alo[c]);
#pragma unroll
        for (int j = 0; j < kFragN; ++j) {
          float f[4];
          mma_tf32_zero(f, alo, bhi[j][0], bhi[j][1]);
          mma_tf32(f, ahi, blo[j][0], blo[j][1]);
          mma_tf32(f, ahi, bhi[j][0], bhi[j][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += f[e];
        }
      }
    }

    if (s % n_kt != n_kt - 1) continue;
    // ---- epilogue of column tile s / n_kt ----
    const int col0 = c_lo + (s / n_kt) * kBN;
    uint32_t cin = 0, cvalid = 0;   // bit 2j + e
#pragma unroll
    for (int q = 0; q < 2 * kFragN; ++q) {
      const int c = col0 + wn * kWarpCols + (q / 2) * 8 + 2 * t + (q % 2);
      if (c < K2) {
        cin |= 1u << q;
        if (vb == nullptr || vb[c] != 0) cvalid |= 1u << q;
      }
    }
    // rows: the tile's top-2 of each of the thread's rows over its
    // columns, scanned in column order (a strict > keeps the lowest index,
    // a value equal to the best becomes the second), then merged over the
    // 4 lanes that share the row (xor over t)
#pragma unroll
    for (int i = 0; i < kFragM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int sidx = 2 * i + h;
        Top2 x{-INFINITY, -INFINITY, 0x7fffffff};
#pragma unroll
        for (int j = 0; j < kFragN; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = 2 * j + e;
            if (!((cin >> q) & 1u)) continue;
            const bool ok = ((rvalid >> sidx) & 1u) && ((cvalid >> q) & 1u);
            const float v = ok ? acc[i][j][2 * h + e] : kInvalid;
            if (v > x.best) {
              x.second = x.best;
              x.best = v;
              x.idx = col0 + wn * kWarpCols + j * 8 + 2 * t + e;
            } else {
              x.second = fmaxf(x.second, v);
            }
          }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, x.best, off);
          const int oi = __shfl_xor_sync(0xffffffffu, x.idx, off);
          const float os = __shfl_xor_sync(0xffffffffu, x.second, off);
          merge(x, ob, oi, os);
        }
        if (t == 0) {
          const int m = wm * kWarpRows + i * 16 + g + 8 * h;
          rs_best[wn][m] = x.best;
          rs_second[wn][m] = x.second;
          rs_idx[wn][m] = x.idx;
        }
      }
    // columns: the thread's rows in row order, then the 8 lanes that
    // share the column (xor over g), then the row warps through shared
    // memory
#pragma unroll
    for (int j = 0; j < kFragN; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 2 * j + e;
        float cb = -INFINITY;
        int ci = 0x7fffffff;
#pragma unroll
        for (int i = 0; i < kFragM; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int sidx = 2 * i + h;
            if (!((rin >> sidx) & 1u)) continue;
            const bool ok = ((rvalid >> sidx) & 1u) && ((cvalid >> q) & 1u);
            const float v = ok ? acc[i][j][2 * h + e] : kInvalid;
            if (v > cb) {
              cb = v;
              ci = r_lo + wm * kWarpRows + i * 16 + g + 8 * h;
            }
          }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, cb, off);
          const int oi = __shfl_xor_sync(0xffffffffu, ci, off);
          take_best(cb, ci, ob, oi);
        }
        if (g == 0) {
          cs_val[wm][wn * kWarpCols + j * 8 + 2 * t + e] = cb;
          cs_idx[wm][wn * kWarpCols + j * 8 + 2 * t + e] = ci;
        }
      }
#pragma unroll
    for (int i = 0; i < kFragM; ++i)
#pragma unroll
      for (int j = 0; j < kFragN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    __syncthreads();
    if (tid < kBN && col0 + tid < K2) {
      float cb = cs_val[0][tid];
      int ci = cs_idx[0][tid];
#pragma unroll
      for (int w = 1; w < kWarpsM; ++w)
        take_best(cb, ci, cs_val[w][tid], cs_idx[w][tid]);
      col_val[col_o + col0 + tid] = cb;
      col_idx[col_o + col0 + tid] = ci;
    }
    if (tid < kBM) {
#pragma unroll
      for (int w = 0; w < kWarpsN; ++w)
        merge(run, rs_best[w][tid], rs_idx[w][tid], rs_second[w][tid]);
    }
  }
  cp_async_wait<0>();

  if (c_stop < c_hi) {
    // the skipped columns: -2 for every row, lowest index c_stop
    merge(run, kInvalid, c_stop, c_hi - c_stop > 1 ? kInvalid : -INFINITY);
    for (int c = c_stop + tid; c < c_hi; c += kThreads) {
      col_val[col_o + c] = kInvalid;
      col_idx[col_o + c] = r_lo;
    }
  }
  if (tid < kBM && r_lo + tid < K1) {
    const int64_t o = row_o + r_lo + tid;
    row_val[2 * o] = run.best;
    row_val[2 * o + 1] = run.second;
    row_idx[o] = run.idx;
  }
}

// vals / idx per (p, row) from the C column-range partials in order;
// colarg per (p, column) from the R row-tile partials in order
__global__ void __launch_bounds__(kReduceThreads)
top2_reduce_kernel(const float* __restrict__ row_val,
                   const int* __restrict__ row_idx,
                   const float* __restrict__ col_val,
                   const int* __restrict__ col_idx, int64_t rows, int K1,
                   int K2, int R, int C, int64_t total,
                   float* __restrict__ vals, int* __restrict__ idx,
                   int* __restrict__ colarg) {
  const int64_t tix = (int64_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (tix >= total) return;
  if (tix < rows) {
    const int64_t p = tix / K1;
    const int64_t r = tix - p * K1;
    int64_t o = p * C * K1 + r;
    Top2 s{row_val[2 * o], row_val[2 * o + 1], row_idx[o]};
    for (int c = 1; c < C; ++c) {
      o += K1;
      merge(s, row_val[2 * o], row_idx[o], row_val[2 * o + 1]);
    }
    vals[2 * tix] = s.best;
    vals[2 * tix + 1] = s.second;
    idx[tix] = s.idx;
    return;
  }
  const int64_t u = tix - rows;
  const int64_t p = u / K2;
  const int64_t c = u - p * K2;
  int64_t o = p * R * K2 + c;
  float b = col_val[o];
  int bi = col_idx[o];
  for (int r = 1; r < R; ++r) {
    o += K2;
    take_best(b, bi, col_val[o], col_idx[o]);
  }
  colarg[u] = bi;
}

template <bool kVec>
cudaError_t launch_units(unsigned units, cudaStream_t s, const float* A,
                         const uint8_t* vA, const int* ia, int N1,
                         const float* B, const uint8_t* vB, const int* ib,
                         int N2, int K1, int K2, int D, int R, int C,
                         float* row_val, int* row_idx, float* col_val,
                         int* col_idx) {
  cudaError_t e = cudaFuncSetAttribute(
      top2_unit_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return e;
  top2_unit_kernel<kVec><<<units, kThreads, kSmemBytes, s>>>(
      A, vA, ia, N1, B, vB, ib, N2, K1, K2, D, R, C, row_val, row_idx,
      col_val, col_idx);
  return cudaGetLastError();
}

}  // namespace

// P pairs: rows of A[ia[p]] (K1, D) against B[ib[p]] (K2, D), A a stack
// of N1 sets and B of N2.  vA / vB (uint8 validity, (N1, K1) / (N2, K2))
// may be null (all valid).  Outputs vals (P, K1, 2), idx (P, K1), colarg
// (P, K2).  Scratch of the caller: row_val (P, C, K1, 2), row_idx (P, C,
// K1), col_val / col_idx (P, R, K2), R = ceil(K1 / 128), C = ceil(K2 /
// 256).  A pair index outside [0, N1) or [0, N2) gives NaN values and
// index -1 for that pair.
extern "C" int lvba_top2_similarity(const float* A, const uint8_t* vA,
                                    const int* ia, int N1, const float* B,
                                    const uint8_t* vB, const int* ib, int N2,
                                    int P, int K1, int K2, int D, float* vals,
                                    int* idx, int* colarg, float* row_val,
                                    int* row_idx, float* col_val,
                                    int* col_idx, void* stream) {
  if (P == 0 || K1 == 0 || K2 == 0) return 0;
  const int R = (K1 + kBM - 1) / kBM;
  const int C = (K2 + kUnitCols - 1) / kUnitCols;
  const int64_t units = (int64_t)P * R * C;
  if (units > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = D % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(A) |
                     reinterpret_cast<uintptr_t>(B)) % 16) == 0;
  cudaError_t e =
      vec ? launch_units<true>(static_cast<unsigned>(units), s, A, vA, ia, N1,
                               B, vB, ib, N2, K1, K2, D, R, C, row_val,
                               row_idx, col_val, col_idx)
          : launch_units<false>(static_cast<unsigned>(units), s, A, vA, ia,
                                N1, B, vB, ib, N2, K1, K2, D, R, C, row_val,
                                row_idx, col_val, col_idx);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t rows = (int64_t)P * K1;
  const int64_t total = rows + (int64_t)P * K2;
  top2_reduce_kernel<<<static_cast<unsigned>((total + kReduceThreads - 1) /
                                             kReduceThreads),
                       kReduceThreads, 0, s>>>(row_val, row_idx, col_val,
                                               col_idx, rows, K1, K2, R, C,
                                               total, vals, idx, colarg);
  return static_cast<int>(cudaGetLastError());
}
