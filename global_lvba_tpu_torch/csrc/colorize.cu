// The colored clouds' z-buffer: each image's nearest LiDAR point per pixel,
// every image of a call in one persistent launch.
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
// (Z, lin)).
//
// One pass a point: a pixel's cell is 16 bytes, (Z's bits, the point's
// index), and a point takes it by the 16-byte atomicCAS that CUDA 12.9's
// headers declare for sm_90 (a compare-and-swap loop on the pair's order,
// Z first: Z > 0, so its bits order as its value), so each window point is
// projected once and the picks are bitwise repeatable and bitwise the
// plain version's (colorize_plain in kernels/colorize.py).
//
// The maps stay in L2: the call's pixels (image-major, image by image) are
// walked in slabs of S pixels, S cells at most 32 MiB of the card's 50 MB
// L2 (kernels/colorize.py slab_pixels: whole images where an image fits).
// One cooperative launch, LVBA_COLORIZE_THREADS threads a block and a few
// blocks an SM, walks the slabs; each slab in three phases split by grid
// syncs:
//   1. every window point of the slab's images is projected, and the ones
//      that land in the slab take their cell; the first to take an empty
//      cell sets the cell's bit in a bitmap of the slab;
//   2. block b owns the slab's pixels [b * kStash, (b + 1) * kStash): it
//      scans their bitmap words, a word a thread, and compacts its picks
//      in pixel order into shared memory (a block scan of the words' bit
//      counts), resetting each cell and word it read;
//   3. each block adds up the counts of the blocks before it and copies its
//      picks to the output, behind the slabs before.
// So the picks come out image by image in ascending pixel order, the JAX
// function's row order, each packed as (image * H * W + pixel) << 32 |
// point.  The cells and the bitmap are made empty once, when the wrapper
// allocates them, and each launch leaves them empty.  Block 0 checks every
// window (0 <= lo <= hi <= N) and a window that fails is read as empty;
// the launch ends by writing the pick count and a status word (1: a
// window outside the points; 2: more picks than the output holds) that
// the wrapper reads back once.
//
// Bound: operations, 43 float64 operations a window point; the bytes, the
// points and poses once and the picks once (the cells stay in L2).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lvba_error.cuh"

#ifndef LVBA_COLORIZE_THREADS
#define LVBA_COLORIZE_THREADS 256
#endif
#ifndef LVBA_COLORIZE_STASH
#define LVBA_COLORIZE_STASH 8192
#endif
#ifndef LVBA_COLORIZE_SLAB_IMAGES
#define LVBA_COLORIZE_SLAB_IMAGES 64
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = LVBA_COLORIZE_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kStash = LVBA_COLORIZE_STASH;      // pixels a block owns
constexpr int kSlabImages = LVBA_COLORIZE_SLAB_IMAGES;
constexpr size_t kSmem = sizeof(unsigned long long) * kStash;
constexpr unsigned long long kEmpty = ~0ULL;

static_assert(kStash == 32 * kThreads, "a bitmap word a thread");

struct __align__(16) Cell {
  unsigned long long z, i;
};

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

__device__ __forceinline__ bool before(unsigned long long z,
                                       unsigned long long i, const Cell& c) {
  return z < c.z || (z == c.z && i < c.i);
}

__device__ __forceinline__ bool same(const Cell& a, const Cell& b) {
  return a.z == b.z && a.i == b.i;
}

// cell = min(cell, (z, i)) in (Z, index) order; the first to fill an empty
// cell sets its bit.  Within a slab a cell only falls, so a Z read from L2
// (not L1, which may hold another slab's line) at least the cell's Z
// proves a loss when below z; every other decision rests on a value the
// CAS returned.
__device__ __forceinline__ void take(Cell* cell, unsigned* word, int bit,
                                     unsigned long long z,
                                     unsigned long long i) {
  Cell exp;
  exp.z = __ldcg(&cell->z);
  if (exp.z < z) return;
  exp.i = __ldcg(&cell->i);   // a guess: the two halves are read apart
  const Cell want{z, i};
  bool known = false;
  for (;;) {
    if (!before(z, i, exp)) {
      if (known) return;
      const Cell old = atomicCAS(cell, exp, exp);   // an atomic read
      if (same(old, exp)) return;
      exp = old;
      known = true;
      continue;
    }
    const Cell old = atomicCAS(cell, exp, want);
    if (same(old, exp)) {
      if (exp.z == kEmpty && exp.i == kEmpty) atomicOr(word, 1u << bit);
      return;
    }
    exp = old;
    known = true;
  }
}

// exclusive prefix of v over the block, and the block's total
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int t = warp_sums[w];
      warp_sums[w] = s;
      s += t;
    }
    warp_sums[kWarps] = s;
  }
  __syncthreads();
  const int ex = x - v + warp_sums[warp];
  *total = warp_sums[kWarps];
  __syncthreads();
  return ex;
}

__global__ void __launch_bounds__(kThreads, 3)
colorize_kernel(const double* __restrict__ pts, int64_t N,
                const int64_t* __restrict__ lo, const int64_t* __restrict__ hi,
                const double* __restrict__ cams, int M, Intrinsics in,
                int64_t S, Cell* __restrict__ cells,
                unsigned* __restrict__ words,
                long long* __restrict__ block_counts,
                unsigned long long* __restrict__ out, int64_t cap,
                long long* __restrict__ meta) {
  extern __shared__ unsigned long long stash[];
  __shared__ int64_t img_lo[kSlabImages + 2];
  __shared__ int64_t img_at[kSlabImages + 2];   // item prefix
  __shared__ int warp_sums[kWarps + 1];
  __shared__ long long red[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int nb = gridDim.x, b = blockIdx.x;
  const int64_t HW = (int64_t)in.H * in.W;
  const int64_t total_px = (int64_t)M * HW;

  auto valid = [&](int m, int64_t* a, int64_t* e) {
    const int64_t x = lo[m], y = hi[m];
    *a = x;
    *e = y;
    return x >= 0 && x <= y && y <= N;
  };
  if (b == 0) {
    for (int m = tid; m < M; m += kThreads) {
      int64_t a, e;
      if (!valid(m, &a, &e)) atomicOr(reinterpret_cast<unsigned long long*>(
                                           meta + 1), 1ULL);
    }
  }

  long long running = 0;
  for (int64_t g0 = 0; g0 < total_px; g0 += S) {
    const int64_t g1 = g0 + S < total_px ? g0 + S : total_px;
    const int ma = static_cast<int>(g0 / HW);
    const int n_img = static_cast<int>((g1 - 1) / HW) + 1 - ma;
    // ---- 1: the slab's images' window points take their cells ----
    if (tid == 0) {
      int64_t at = 0;
      for (int j = 0; j < n_img; ++j) {
        int64_t a, e;
        img_at[j] = at;
        img_lo[j] = 0;
        if (valid(ma + j, &a, &e)) {
          img_lo[j] = a;
          at += e - a;
        }
      }
      img_at[n_img] = at;
    }
    __syncthreads();
    const int64_t items = img_at[n_img];
    int j = 0;
    double c[12];
    int cm = -1;
    for (int64_t t = (int64_t)b * kThreads + tid; t < items;
         t += (int64_t)nb * kThreads) {
      while (t >= img_at[j + 1]) ++j;
      const int m = ma + j;
      if (m != cm) {
#pragma unroll
        for (int k = 0; k < 12; ++k) c[k] = __ldg(cams + 12 * (int64_t)m + k);
        cm = m;
      }
      const int64_t i = img_lo[j] + (t - img_at[j]);
      int lin;
      double Z;
      if (!project(pts + 3 * i, c, in, &lin, &Z)) continue;
      const int64_t rel = (int64_t)m * HW + lin - g0;
      if (rel < 0 || rel >= g1 - g0) continue;
      take(cells + rel, words + (rel >> 5), static_cast<int>(rel & 31),
           static_cast<unsigned long long>(__double_as_longlong(Z)),
           static_cast<unsigned long long>(i));
    }
    grid.sync();
    // ---- 2: compact the block's pixels in order, reset what was read ----
    const int64_t w = (int64_t)b * kThreads + tid;   // this thread's word
    const unsigned bits =
        32 * w < g1 - g0 ? __ldcg(words + w) : 0u;
    int n_blk;
    int pos = block_scan(__popc(bits), warp_sums, &n_blk);
    for (unsigned rest = bits; rest; rest &= rest - 1) {
      const int bit = __ffs(rest) - 1;
      const int64_t rel = 32 * w + bit;
      Cell* cell = cells + rel;
      const unsigned long long idx = __ldcg(&cell->i);
      stash[pos++] = (static_cast<unsigned long long>(g0 + rel) << 32) | idx;
      cell->z = kEmpty;
      cell->i = kEmpty;
    }
    if (bits) words[w] = 0u;
    if (tid == 0) block_counts[b] = n_blk;
    grid.sync();
    // ---- 3: the picks behind the blocks and slabs before ----
    long long before_b = 0, all = 0;
    for (int k = tid; k < nb; k += kThreads) {
      const long long v = __ldcg(block_counts + k);
      all += v;
      if (k < b) before_b += v;
    }
    for (int o = 16; o > 0; o >>= 1) {
      all += __shfl_xor_sync(0xffffffffu, all, o);
      before_b += __shfl_xor_sync(0xffffffffu, before_b, o);
    }
    if ((tid & 31) == 0) red[tid >> 5] = all;
    __syncthreads();
    all = 0;
    for (int k = 0; k < kWarps; ++k) all += red[k];
    __syncthreads();
    if ((tid & 31) == 0) red[tid >> 5] = before_b;
    __syncthreads();
    before_b = 0;
    for (int k = 0; k < kWarps; ++k) before_b += red[k];
    const long long base = running + before_b;
    if (base + n_blk <= cap) {
      for (int k = tid; k < n_blk; k += kThreads) out[base + k] = stash[k];
    } else if (tid == 0) {
      atomicOr(reinterpret_cast<unsigned long long*>(meta + 1), 2ULL);
    }
    running += all;
    __syncthreads();
  }
  if (b == 0 && tid == 0) meta[0] = running;
}

}  // namespace

// The blocks of colorize_kernel one SM holds at once (for the cooperative
// grid: the wrapper launches this times the SMs).
extern "C" int lvba_colorize_occupancy(int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(
      colorize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, colorize_kernel, kThreads, kSmem));
}

// The picks, packed (image * H * W + pixel) << 32 | point, into out (cap
// int64), and meta (2,) int64 = (picks, status), from pts (N, 3) float64,
// the windows lo, hi (M,) int64, the poses cams (M, 12) float64, in slabs
// of S pixels over `blocks` blocks (at most the occupancy times the SMs;
// S at most blocks * LVBA_COLORIZE_STASH and LVBA_COLORIZE_SLAB_IMAGES
// images), with the empty cells (S, 16
// bytes of 0xff) and bitmap (ceil(S / 32) words of 0) as scratch.
extern "C" int lvba_colorize(const double* pts, int64_t N, const int64_t* lo,
                             const int64_t* hi, const double* cams, int M,
                             double fx, double fy, double cx, double cy,
                             double k1, double k2, double p1, double p2,
                             int W, int H, int64_t S, int blocks, void* cells,
                             void* words, int64_t* block_counts, int64_t* out,
                             int64_t cap, int64_t* meta, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(meta, 0, 2 * sizeof(int64_t), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (M <= 0) return 0;
  if (blocks <= 0 || S <= 0 || S > (int64_t)blocks * kStash ||
      S > (int64_t)kSlabImages * W * H)
    return static_cast<int>(cudaErrorInvalidValue);
  e = cudaFuncSetAttribute(colorize_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  Intrinsics in{fx, fy, cx, cy, k1, k2, p1, p2, W, H};
  Cell* c = static_cast<Cell*>(cells);
  unsigned* wd = static_cast<unsigned*>(words);
  long long* bc = reinterpret_cast<long long*>(block_counts);
  unsigned long long* o = reinterpret_cast<unsigned long long*>(out);
  long long* mt = reinterpret_cast<long long*>(meta);
  void* args[] = {&pts, &N, &lo, &hi, &cams, &M, &in, &S, &c, &wd, &bc, &o,
                  &cap, &mt};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(colorize_kernel),
                                  dim3(blocks), dim3(kThreads), args, kSmem,
                                  s);
  return static_cast<int>(e);
}
