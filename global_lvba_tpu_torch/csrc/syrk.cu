// Kernel 3: gram (N, N) += AᵀA for A (Kr, N) row-major, float32
// (replaces global_lvba_tpu/ops/pallas/gram.py:41 `_syrk_kernel`); its
// float64 counterpart, syrk_f64_kernel, is described where it stands.
//
// Precision: 3xTF32 on the tensor cores, the counterpart of the TPU
// kernel's default precision="highest" (six bf16 passes, fp32-faithful).
// Each operand is split as a = hi + lo with hi = tf32(a) and lo = tf32(a −
// hi), both rounded to nearest with ties away from zero (cvt.rna), and
// AᵀA ≈ loᵀhi + hiᵀlo + hiᵀhi: the dropped loᵀlo and lo's own rounding
// are ~2⁻²² of |a|·|b|, below the fp32 sums' error.
//
// Bound: operations — 3·Kr·N·(N+1) flops (the lower triangle, three TF32
// products) at the card's 495 TFLOP/s TF32 rate; the bytes (A once, the
// gram read and written) are a third of that time at W=512.
//
// Two launches behind one wrapper (kernels/gram.py):
//
// syrk_split_kernel, memory-bound: reads A once and writes hi and lo
// TRANSPOSED, as (Np, Krp) fp32 containers zero-padded to the 128-column
// tile in N and to the 32-row k-tile in Kr.  wgmma takes TF32 operands
// only K-major (the transpose immediates exist for 16-bit types alone),
// and both operands of AᵀA are column panels of A, so one transposed copy
// serves both; the padding makes every TMA row stride a multiple of 16 B
// whatever N is.  Zeros are exact, and padded rows and columns are dropped.
//
// syrk_kernel: one 128 x 128 output tile of the lower triangle (ti >= tj)
// per block, or a part of its contraction (waves, below).  Warp 8, the
// producer, keeps a ring of kStages stages of TMA loads in flight
// (cp.async.bulk.tensor, 128-byte swizzle, completion on mbarriers); a
// stage holds the 128 x 32 hi and lo tiles of both panels (64 KB), one
// panel on a diagonal tile.  Warps 0-7 are two consumer warpgroups of 64
// rows each; per k8 slice each issues wgmma.m64n128k8.f32.tf32.tf32 three
// times (loᵀhi, hiᵀlo, hiᵀhi) into 64 fp32 accumulators a thread, then
// frees the stage and adds the k-tile's sum to a second set of 64 in fp32
// (the tensor cores' own accumulation does not round to nearest).
//
// Waves.  One block per SM (192 KB of ring).  The tiles of whole waves
// take one block each; each tile of the last, partial wave takes up to 4
// blocks over parts of its contraction, as many as fill that wave (the
// wrapper chooses: N = 3,072 gives 300 tiles, two waves of 132 and 36
// tiles in 3 parts).  The parts store their sums to scratch; the last to
// finish (a counter per tile) adds them in the order of the parts and
// writes the tile.  No atomics touch the sums, and every sum runs in one
// fixed order, so the result is bitwise repeatable.
//
// Epilogue.  The tile is staged in shared memory (odd stride: rows and
// columns read without bank conflicts), then gram is read, added to and
// written with coalesced accesses, 16 loads in flight a thread: the tile
// itself and, off the diagonal, its transpose at (tj, ti).  On a diagonal
// tile element (r, c), r >= c, is added at (r, c) and at (c, r), so the
// result is exactly symmetric (the hardware's order of the three products
// would not guarantee it).
//
// Measured by scripts/syrk_sweep.py on an H100 SXM at N = 3,072: the
// mainloop runs a k-tile in ~0.92 µs a wave (~92% of the TF32 rate), and
// each launch adds ~0.06 ms of wave ramps and epilogues.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lvba_error.cuh"

namespace {

constexpr int kBM = 128;                  // output tile, both sides
constexpr int kBK = 32;                   // k-tile: one 128-byte row of fp32
constexpr int kStages = 3;
constexpr int kConsumerWarps = 8;         // two warpgroups
constexpr int kThreads = (kConsumerWarps + 1) * 32;
constexpr int kTileBytes = kBM * kBK * 4;           // 16 KB
constexpr int kStageBytes = 4 * kTileBytes;         // hi_i, lo_i, hi_j, lo_j
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + alignment
constexpr int kLd = kBM + 1;              // staged tile's row stride
constexpr int kCThreads = kConsumerWarps * 32;
constexpr int kBatch = 16;                // epilogue loads in flight a thread
static_assert(kBM * kLd * 4 <= kStages * kStageBytes, "staging fits");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
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

// ---- TMA: one (kBK, kBM) box at (k, row) into 128-byte-swizzled smem ----
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(k), "r"(row)
      : "memory");
}

// ---- wgmma ----
// Descriptor of a K-major operand in the 128-byte swizzle: rows of 128 B,
// 8-row groups 1,024 B apart (SBO); the leading offset is unused for a
// swizzled K-major operand.  Advancing along k inside the 128-byte row is
// a plain start-address offset (32 B per k8 slice of fp32).
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads across a wgmma wait
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 128, fp32) = a (64 x 8) · b (128 x 8)ᵀ + (scale_d ? d : 0), both
// tf32 K-major
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kConsumerWarps * 32) : "memory");
}

// G[at(idx)] += val(idx) over a tile's elements idx = 0 .. 128·128 − 1 by
// kThr threads (at < 0: outside gram).  Each thread loads kB elements
// before it stores any: loads of gram cannot pass a store to gram, so one
// at a time they would wait on memory in series.
template <int kThr, int kB, typename T, class At, class Val>
__device__ __forceinline__ void add_to_gram(T* G, int tid, At at, Val val) {
  for (int base = tid; base < kBM * kBM; base += kThr * kB) {
    int64_t o[kB];
    T g[kB];
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      o[q] = at(base + q * kThr);
      g[q] = o[q] >= 0 ? G[o[q]] : T(0);
    }
#pragma unroll
    for (int q = 0; q < kB; ++q)
      if (o[q] >= 0) G[o[q]] = g[q] + val(base + q * kThr);
  }
}

// lower-triangle tile p -> (ti, tj), ti >= tj, row-major over ti
__device__ __forceinline__ void tile_of(int p, int& ti, int& tj) {
  ti = static_cast<int>((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= p) ++ti;
  while (ti * (ti + 1) / 2 > p) --ti;
  tj = p - ti * (ti + 1) / 2;
}

// hi, lo (Np, Krp) = tf32 split of A (Kr, N), transposed and zero-padded.
// A 32 x 32 tile per block through shared memory: coalesced both ways.
__global__ void __launch_bounds__(256)
syrk_split_kernel(const float* __restrict__ A, int Kr, int N, int Krp,
                  float* __restrict__ hi, float* __restrict__ lo) {
  __shared__ float sh[32][33], sl[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = ty + 8 * q;
    const int k = k0 + r, n = n0 + tx;
    const float a = (k < Kr && n < N) ? A[(int64_t)k * N + n] : 0.f;
    const float h = tf32_rna(a);
    sh[r][tx] = h;
    sl[r][tx] = tf32_rna(a - h);
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = ty + 8 * q;
    const int64_t o = (int64_t)(n0 + r) * Krp + k0 + tx;
    hi[o] = sh[tx][r];
    lo[o] = sl[tx][r];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
syrk_kernel(const __grid_constant__ CUtensorMap tm_hi,
            const __grid_constant__ CUtensorMap tm_lo, int nk, int full,
            int splits, int N, float* __restrict__ G,
            float* __restrict__ part, int* __restrict__ count) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  __shared__ int last_part;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  // block -> lower-triangle tile p = (ti, tj), ti >= tj, row-major over ti.
  // Tiles p < full take one block each; each later (tail) tile takes
  // `splits` blocks, part s over k-tiles [s·nk/splits, (s+1)·nk/splits).
  const int b = blockIdx.x;
  const bool tail = b >= full;
  const int p = tail ? full + (b - full) / splits : b;
  const int s = tail ? (b - full) % splits : 0;
  const int nparts = tail ? splits : 1;
  int ti, tj;
  tile_of(p, ti, tj);
  const bool diag = ti == tj;
  const int i0 = ti * kBM, j0 = tj * kBM;
  const int kt0 = s * nk / nparts, kt1 = (s + 1) * nk / nparts;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full_bar[st], 1);
      mbar_init(&empty_bar[st], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: one thread issues the TMA ring ----
    if (lane == 0) {
      const uint32_t bytes = (diag ? 2 : 4) * kTileBytes;
      int st = 0;
      uint32_t phase = 0;
      for (int kt = kt0; kt < kt1; ++kt) {
        mbar_wait(&empty_bar[st], phase ^ 1);
        uint8_t* buf = smem + st * kStageBytes;
        mbar_expect_tx(&full_bar[st], bytes);
        tma_load(buf, &tm_hi, &full_bar[st], kt * kBK, i0);
        tma_load(buf + kTileBytes, &tm_lo, &full_bar[st], kt * kBK, i0);
        if (!diag) {
          tma_load(buf + 2 * kTileBytes, &tm_hi, &full_bar[st], kt * kBK, j0);
          tma_load(buf + 3 * kTileBytes, &tm_lo, &full_bar[st], kt * kBK, j0);
        }
        if (++st == kStages) { st = 0; phase ^= 1; }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64·wg .. 64·wg + 63 ----
  // The tensor cores' fp32 accumulation does not round to nearest, so its
  // error grows with the depth summed in one accumulator: over a whole
  // W=512 contraction it lies far above fp32 FMA's.  Each k-tile's twelve
  // products go into a fresh accumulator t, which is then added to d in
  // fp32 (round to nearest): the tensor cores sum 32 rows at a time.
  const int wg = warp / 4;
  float d[64], t[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = t[i] = 0.f;
  fence_acc(t);
  int st = 0;
  uint32_t phase = 0;
  for (int kt = kt0; kt < kt1; ++kt) {
    mbar_wait(&full_bar[st], phase);
    const uint8_t* buf = smem + st * kStageBytes;
    const uint8_t* a_hi = buf + wg * 64 * kBK * 4;
    const uint8_t* a_lo = a_hi + kTileBytes;
    const uint8_t* b_hi = buf + (diag ? 0 : 2) * kTileBytes;
    const uint8_t* b_lo = b_hi + kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int k8 = 0; k8 < kBK / 8; ++k8) {
      const int o = k8 * 32;
      wgmma_tf32(t, desc_sw128(a_lo + o), desc_sw128(b_hi + o), k8 > 0);
      wgmma_tf32(t, desc_sw128(a_hi + o), desc_sw128(b_lo + o), 1);
      wgmma_tf32(t, desc_sw128(a_hi + o), desc_sw128(b_hi + o), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(t);
    if (lane == 0) mbar_arrive(&empty_bar[st]);
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] += t[i];
    if (++st == kStages) { st = 0; phase ^= 1; }
  }

  // ---- stage the tile: S[r][c], r, c in [0, 128) ----
  consumer_sync();  // both warpgroups are done reading the ring
  float* S = reinterpret_cast<float*>(smem);
  {
    const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;
    const int c0 = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float* row = S + r0 * kLd + 8 * j + c0;
      row[0] = d[4 * j];
      row[1] = d[4 * j + 1];
      row[8 * kLd] = d[4 * j + 2];
      row[8 * kLd + 1] = d[4 * j + 3];
    }
  }
  consumer_sync();
  const int tid = threadIdx.x;

  if (nparts > 1) {
    // store this part's sums; the last part to finish adds all of them in
    // the order s = 0, 1, ..., whichever it is
    float* parts = part + (int64_t)(p - full) * nparts * kBM * kBM;
    float* mine = parts + (int64_t)s * kBM * kBM;
    for (int idx = tid; idx < kBM * kBM; idx += kCThreads)
      mine[idx] = S[(idx / kBM) * kLd + idx % kBM];
    __threadfence();
    consumer_sync();
    if (tid == 0) {
      const int before = atomicAdd(&count[p - full], 1);
      last_part = before == nparts - 1;
      if (last_part) count[p - full] = 0;
    }
    consumer_sync();
    if (!last_part) return;
    __threadfence();
    for (int base = tid; base < kBM * kBM; base += kCThreads * kBatch) {
      float x[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) x[q] = __ldcg(parts + base + q * kCThreads);
      for (int t = 1; t < nparts; ++t) {
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          x[q] += __ldcg(parts + (int64_t)t * kBM * kBM + base + q * kCThreads);
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int idx = base + q * kCThreads;
        S[(idx / kBM) * kLd + idx % kBM] = x[q];
      }
    }
    consumer_sync();
  }

  // ---- gram += tile at (ti, tj), rows along threadIdx ----
  add_to_gram<kCThreads, kBatch>(G, tid, [&](int idx) -> int64_t {
    const int gi = i0 + idx / kBM, gj = j0 + idx % kBM;
    return gi < N && gj < N ? (int64_t)gi * N + gj : -1;
  }, [&](int idx) {
    const int r = idx / kBM, c = idx % kBM;
    return (diag && c > r) ? S[c * kLd + r] : S[r * kLd + c];
  });
  if (diag) return;
  // ---- and its transpose at (tj, ti) ----
  add_to_gram<kCThreads, kBatch>(G, tid, [&](int idx) -> int64_t {
    const int gj = j0 + idx / kBM, gi = i0 + idx % kBM;
    return gi < N && gj < N ? (int64_t)gj * N + gi : -1;
  }, [&](int idx) { return S[(idx % kBM) * kLd + idx / kBM]; });
}

// syrk_f64_kernel: gram (N, N) += AᵀA in float64, for float64 solves
// (the float64 instance of the same TPU kernel).
//
// Bound: operations — Kr·N·(N+1) fp64 flops (the lower triangle) at the
// card's 67 TFLOP/s on the fp64 tensor cores (0.87 ms for the W=512 aligned
// evaluation's 6,144 rows x 3,072 columns); A once and the gram read and
// written take a sixth of that time there.
//
// The fp64 tensor cores: wgmma has no fp64 form, so every product is
// mma.sync.aligned.m16n8k4.f64 (DMMA.16x8x4 in the SASS), accumulated in
// fp64 registers.  One 128 x 128 tile of the lower triangle (ti >= tj) per
// block of 16 warps; warp w owns rows 32·(w / 4) and columns 32·(w % 4) of
// it, 2 x 4 m16n8 accumulators (32 doubles a thread, 128 registers, no
// spill).  Measured on an H100 SXM at 6,144 x 3,072 (scripts/syrk_sweep.py
// --f64 times it): 1.55 ms; 8 warps of 64 x 32 tiles took 1.75 (four warps
// a scheduler hide more of the fragment loads' latency), and the k8 and k16
// shapes, 32-row stages and prefetched fragments were no faster.  The
// products alone, on register operands, reach 66 TFLOP/s there: the
// kernel's 39 TFLOP/s of products is held by feeding them (the fragment
// loads from shared memory, and the panels' 3.6 GB a launch from the L2,
// 2.3 TB/s at that time), not by the tensor cores.
//
// Operands.  Row k of A holds the k-slice of both operands of the tile
// (columns i0.. and j0..), so a stage is 16 rows of A over the tile's two
// 128-column panels (one panel on a diagonal tile), copied by cp.async
// straight from A's rows (16 B, or 8 B where N is odd), zero past Kr and
// N, into a ring of 4 stages: the copies of the next three stages run while
// one is multiplied.  The panels' row stride, 132 doubles (≡ 4 mod 16),
// puts the 4 k-rows x 8 columns of a fragment load on distinct banks.
//
// Waves and the epilogue as syrk_kernel: one block per SM (132 KB of ring);
// the tiles of the last, partial wave split over the contraction
// (tile_schedule), each part's sums stored and added in the order of the
// parts by the last to finish; the tile staged in shared memory (odd
// stride) and added to gram at (r, c) and, off the diagonal, at (c, r) with
// coalesced read-modify-writes.  On a diagonal tile element (r, c), r >= c,
// is added at (r, c) and at (c, r): exactly symmetric whatever order the
// tensor cores sum in.  No atomics touch the sums: bitwise repeatable.
constexpr int k64Threads = 512;              // 16 warps, 4 x 4 over the tile
constexpr int k64WarpsN = 4;                 // warps along the columns
constexpr int k64MT = 2;                     // m16 tiles a warp: 32 rows
constexpr int k64NT = 4;                     // n8 tiles a warp: 32 columns
constexpr int k64BK = 16;                    // k rows a stage (F64_KTILE)
constexpr int k64Ld = kBM + 4;               // panel row stride, doubles
constexpr int k64Panel = k64BK * k64Ld;      // doubles
constexpr int k64StageBytes = 2 * k64Panel * 8;
constexpr int k64Stages = 4;
constexpr int k64LdS = kBM + 1;              // staged tile's row stride
constexpr int k64Batch = 8;                  // epilogue loads in flight
constexpr int k64SmemBytes = k64Stages * k64StageBytes;
static_assert(k64SmemBytes <= 232448, "the ring fits in shared memory");
static_assert(kBM * k64LdS * 8 <= k64SmemBytes, "staging fits");

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// d (16 x 8) += a (16 x 4) · b (4 x 8) in fp64.  Lane 4g + t holds a[0]
// at row g and a[1] at row g + 8, both at column t; b at row t, column g;
// d[0], d[1] at row g and d[2], d[3] at row g + 8, columns 2t and 2t + 1.
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[2],
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

__global__ void __launch_bounds__(k64Threads, 1)
syrk_f64_kernel(const double* __restrict__ A, int Kr, int N, int full,
                int splits, double* __restrict__ G,
                double* __restrict__ part, int* __restrict__ count) {
  extern __shared__ __align__(16) double smem64[];
  __shared__ int last_part;
  // block -> tile p and part s of its contraction, as in syrk_kernel
  const int b = blockIdx.x;
  const bool tail = b >= full;
  const int p = tail ? full + (b - full) / splits : b;
  const int s = tail ? (b - full) % splits : 0;
  const int nparts = tail ? splits : 1;
  int ti, tj;
  tile_of(p, ti, tj);
  const bool diag = ti == tj;
  const int i0 = ti * kBM, j0 = tj * kBM;
  const int nk = (Kr + k64BK - 1) / k64BK;
  const int kt0 = s * nk / nparts, kt1 = (s + 1) * nk / nparts;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / k64WarpsN, wn = warp % k64WarpsN;
  // 16-byte copies need even N (a row's pairs stay pairs) and an aligned A
  const bool vec = (N % 2 == 0)
                   && (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  const int npanels = diag ? 1 : 2;

  // stage st <- rows k-tile kt of A over the panels (i0.., j0..)
  auto load_stage = [&](int st, int kt) {
    double* ring = smem64 + st * 2 * k64Panel;
    const int k0 = kt * k64BK;
    if (vec) {
      constexpr int per = k64BK * kBM / 2;   // 16-byte chunks a panel
#pragma unroll
      for (int q = 0; q < 2 * per / k64Threads; ++q) {
        const int c = tid + q * k64Threads;
        const int pn = c / per, kr = (c % per) / (kBM / 2);
        const int col = 2 * (c % (kBM / 2));
        const int k = k0 + kr, n = (pn ? j0 : i0) + col;
        const bool ok = pn < npanels && k < Kr && n < N;
        if (pn < npanels)
          cp_async16(ring + pn * k64Panel + kr * k64Ld + col,
                     ok ? A + (int64_t)k * N + n : A, ok ? 16 : 0);
      }
    } else {
      constexpr int per = k64BK * kBM;
#pragma unroll 4
      for (int q = 0; q < 2 * per / k64Threads; ++q) {
        const int c = tid + q * k64Threads;
        const int pn = c / per, kr = (c % per) / kBM, col = c % kBM;
        const int k = k0 + kr, n = (pn ? j0 : i0) + col;
        const bool ok = pn < npanels && k < Kr && n < N;
        if (pn < npanels)
          cp_async8(ring + pn * k64Panel + kr * k64Ld + col,
                    ok ? A + (int64_t)k * N + n : A, ok ? 8 : 0);
      }
    }
  };

  double acc[k64MT][k64NT][4];
#pragma unroll
  for (int mt = 0; mt < k64MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < k64NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0;
    }
  }
#pragma unroll
  for (int st = 0; st < k64Stages - 1; ++st) {
    if (kt0 + st < kt1) load_stage(st, kt0 + st);
    cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int it = kt - kt0;
    cp_async_wait<k64Stages - 2>();   // stage it has landed
    __syncthreads();                  // and every warp is done with it − 1
    if (kt + k64Stages - 1 < kt1)
      load_stage((it + k64Stages - 1) % k64Stages, kt + k64Stages - 1);
    cp_async_commit();
    const double* Pi = smem64 + (it % k64Stages) * 2 * k64Panel;
    const double* Pj = diag ? Pi : Pi + k64Panel;
    const double* pa = Pi + t * k64Ld + wm * 16 * k64MT + g;
    const double* pb = Pj + t * k64Ld + wn * 32 + g;
#pragma unroll
    for (int kk = 0; kk < k64BK; kk += 4) {
      double bf[k64NT];
#pragma unroll
      for (int nt = 0; nt < k64NT; ++nt) bf[nt] = pb[kk * k64Ld + nt * 8];
#pragma unroll
      for (int mt = 0; mt < k64MT; ++mt) {
        const double af[2] = {pa[kk * k64Ld + mt * 16],
                              pa[kk * k64Ld + mt * 16 + 8]};
#pragma unroll
        for (int nt = 0; nt < k64NT; ++nt) mma_f64(acc[mt][nt], af, bf[nt]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                    // the ring is free

  // ---- stage the tile: S[r][c], r, c in [0, 128) ----
  double* S = smem64;
#pragma unroll
  for (int mt = 0; mt < k64MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < k64NT; ++nt) {
      double* row = S + (wm * 16 * k64MT + mt * 16 + g) * k64LdS + wn * 32
                    + nt * 8 + 2 * t;
      row[0] = acc[mt][nt][0];
      row[1] = acc[mt][nt][1];
      row[8 * k64LdS] = acc[mt][nt][2];
      row[8 * k64LdS + 1] = acc[mt][nt][3];
    }
  }
  __syncthreads();

  if (nparts > 1) {
    // store this part's sums; the last part to finish adds all of them in
    // the order s = 0, 1, ..., whichever it is
    double* parts = part + (int64_t)(p - full) * nparts * kBM * kBM;
    double* mine = parts + (int64_t)s * kBM * kBM;
    for (int idx = tid; idx < kBM * kBM; idx += k64Threads)
      mine[idx] = S[(idx / kBM) * k64LdS + idx % kBM];
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int before = atomicAdd(&count[p - full], 1);
      last_part = before == nparts - 1;
      if (last_part) count[p - full] = 0;
    }
    __syncthreads();
    if (!last_part) return;
    __threadfence();
    for (int base = tid; base < kBM * kBM; base += k64Threads * k64Batch) {
      double x[k64Batch];
#pragma unroll
      for (int q = 0; q < k64Batch; ++q)
        x[q] = __ldcg(parts + base + q * k64Threads);
      for (int u = 1; u < nparts; ++u) {
#pragma unroll
        for (int q = 0; q < k64Batch; ++q)
          x[q] += __ldcg(parts + (int64_t)u * kBM * kBM + base
                         + q * k64Threads);
      }
#pragma unroll
      for (int q = 0; q < k64Batch; ++q) {
        const int idx = base + q * k64Threads;
        S[(idx / kBM) * k64LdS + idx % kBM] = x[q];
      }
    }
    __syncthreads();
  }

  // ---- gram += tile at (ti, tj), and off the diagonal at (tj, ti) ----
  add_to_gram<k64Threads, k64Batch>(G, tid, [&](int idx) -> int64_t {
    const int gi = i0 + idx / kBM, gj = j0 + idx % kBM;
    return gi < N && gj < N ? (int64_t)gi * N + gj : -1;
  }, [&](int idx) {
    const int r = idx / kBM, c = idx % kBM;
    return (diag && c > r) ? S[c * k64LdS + r] : S[r * k64LdS + c];
  });
  if (diag) return;
  add_to_gram<k64Threads, k64Batch>(G, tid, [&](int idx) -> int64_t {
    const int gj = j0 + idx / kBM, gi = i0 + idx % kBM;
    return gi < N && gj < N ? (int64_t)gj * N + gi : -1;
  }, [&](int idx) { return S[(idx % kBM) * k64LdS + idx / kBM]; });
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

// (Np, Krp) fp32 row-major, boxes of kBM rows x kBK columns
bool make_map(EncodeTiled enc, CUtensorMap* m, const float* base, int Np,
              int Krp) {
  const cuuint64_t dims[2] = {(cuuint64_t)Krp, (cuuint64_t)Np};
  const cuuint64_t strides[1] = {(cuuint64_t)Krp * 4};
  const cuuint32_t box[2] = {kBK, kBM};
  const cuuint32_t elem[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// hi, lo (Np, Krp): the split pre-pass.  Np % 32 == 0, Krp % 32 == 0.
extern "C" int lvba_syrk_split(const float* A, int Kr, int N, int Np,
                               int Krp, float* hi, float* lo, void* stream) {
  const dim3 grid(Krp / kBK, Np / 32);
  syrk_split_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      A, Kr, N, Krp, hi, lo);
  return static_cast<int>(cudaGetLastError());
}

// gram += AᵀA from the split (Np, Krp), Np % 128 == 0, Krp % 32 == 0.
// Tiles p < full take one block each, the others `splits` blocks each
// (1-4); part holds (tiles − full)·splits·128·128 floats and count
// tiles − full ints, all 0 (the kernel leaves them 0).
extern "C" int lvba_syrk(const float* hi, const float* lo, int Np, int Krp,
                         int N, int full, int splits, float* G, float* part,
                         int* count, void* stream) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap m_hi, m_lo;
  if (!make_map(enc, &m_hi, hi, Np, Krp) || !make_map(enc, &m_lo, lo, Np, Krp))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      syrk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nt = Np / kBM;
  const int blocks = full + (nt * (nt + 1) / 2 - full) * splits;
  syrk_kernel<<<blocks, kThreads, kSmemBytes,
                static_cast<cudaStream_t>(stream)>>>(
      m_hi, m_lo, Krp / kBK, full, splits, N, G, part, count);
  return static_cast<int>(cudaGetLastError());
}

// gram (N, N) += AᵀA for A (Kr, N) row-major, float64 (syrk_f64_kernel).
// Tiles p < full take one block each, the others `splits` blocks each
// (1-4); part holds (tiles − full)·splits·128·128 doubles and count
// tiles − full ints, all 0 (the kernel leaves them 0).
extern "C" int lvba_syrk_f64(const double* A, int Kr, int N, int full,
                             int splits, double* G, double* part,
                             int* count, void* stream) {
  if (Kr == 0 || N == 0) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      syrk_f64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      k64SmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nt = (N + kBM - 1) / kBM;
  const int blocks = full + (nt * (nt + 1) / 2 - full) * splits;
  syrk_f64_kernel<<<blocks, k64Threads, k64SmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(
      A, Kr, N, full, splits, G, part, count);
  return static_cast<int>(cudaGetLastError());
}
