// Kernel 1: per-voxel aggregation of the plane factor + fused 3x3
// eigensolve (replaces global_lvba_tpu/ops/pallas/soa_fused.py:61
// `_agg_kernel` and the XLA `_soa_eig` beside it).
//
// Per voxel it forms N = Σ n, v̄ = Σ n·(R μ + p) / N and the world scatter
// S = Σ mask·R Pc Rᵀ + n·d dᵀ with d = R μ + p − v̄ (the parallel-axis
// form of _soa_agg), then solves the 3x3 eigenproblem of S / N and writes
//   residv[v] = N > 0 ? λ0 : 0
//   pv[v]     = [u(3), B1(3), B2(3), v̄(3), 1/N, 0, 0, 0]
// with B_i = sqrt(2 / max(λi − λ0, 1e-9·max(|λ2|, 1e-20)))·u_i.
//
// Bound: bytes.  A dead cell (n ≤ 0) adds exactly zero, so the function
// needs n of every cell and μ, Pc and the pose row of the live ones only;
// ~150 flops per live cell stay far below the card's FLOP/byte balance.
//
// Design:
//  * A voxel has a group of G threads, the least power of two >= K up to a
//    warp, each holding EPT entries a round (agg_group in kernels/soa.py:
//    one entry a thread up to K = 32, then up to 16: K <= 512, every tier
//    of the slice, is one round; K above 16·32 takes rounds), so every
//    thread holds an entry at any K and a warp holds 32 / G voxels: 8 of
//    the corridor's K = 4 tier, one from K = 32 on.  A block is 8 warps
//    and nothing in it waits on another warp: no barrier, no shared
//    memory.
//  * A thread reads n of its entries, then μ, Pc and the pose row of the
//    live ones only (the pose row as 16-byte loads where the operand is
//    16-byte aligned), all EPT at once, computes R μ + p and R Pc Rᵀ and
//    keeps n·(R μ + p) in registers: pass 2 (d dᵀ about the round's mean)
//    reads no memory again.
//  * Sums over a group are xor-butterfly warp shuffles (every lane gets the
//    total, each step adding a + b or b + a: the same bits).  A round's
//    (N, mean, scatter) joins the running one by the parallel-axis (Chan)
//    rule, in round order.  No atomics: bitwise repeatable, and a single
//    round is the two-pass sums of _soa_agg.
//  * The eigensolves run on parallel lanes: each group's first thread
//    solves its voxel, so a warp of 8 voxels solves 8 at once, and the
//    warps of a block solve theirs independently.
//  * A voxel past V (the grid's last block) loads nothing and writes
//    nothing; a padded voxel (N = 0) gets residv 0 and the finite pv the
//    plain version gives (the eigensolve of the zero matrix).
//
//  * One launch takes up to kMaxBuckets buckets (an evaluation's tiers),
//    each with its own V, K and group, all of one EPT, through a table
//    of them passed by value as the kernel's parameter (no copy to the
//    device): a block finds its bucket from the buckets' first blocks.
//    The wrapper launches the buckets of one EPT together: an instance
//    compiled for more entries may fuse another product into an FMA, so
//    a bucket's bits would depend on its companions' K (seen on the
//    card at K = 1 in float32).
//
// The pose operand is read at poses + (v / vper)·vstride + 12·k: the
// (K, 12) pose table with vstride 0 on the aligned layout (entry (v, k)
// takes pose k), per-entry pose rows (V, K, 12) with vper 1 and vstride
// K·12 on the bucketed layout (table_select's output), and the group form
// of aligned banded groups: a (G, 2B, 12) table of pose windows, one a
// group of vper = Vp voxels of a (G·Vp, 2B) stack, vstride 2B·12 (voxel
// v's slot k takes window v / Vp's pose k).
//
// Templated on the scalar: lvba_soa_agg launches the float instances
// (float32 solves), lvba_soa_agg_f64 the double ones (float64 solves).
#include "soa_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBuckets = 16;

template <typename T>
struct AggBucket {
  const T* n;
  const T* mu;
  const T* Pc;
  const T* poses;
  T* residv;
  T* pv;
  int64_t vstride;
  int vper;  // voxels a pose block: poses + (v / vper)·vstride
  int V, K, lg;
};

template <typename T>
struct AggLaunch {
  AggBucket<T> b[kMaxBuckets];
  int first[kMaxBuckets + 1];  // each bucket's first block; first[nb]: grid
  int nb;
};

// The sum over a voxel's G = 1 << lg lanes (G <= 32) of each x[i]; every
// lane of the group gets the totals.
template <typename T, int NV>
__device__ __forceinline__ void group_sum(T (&x)[NV], int lg) {
#pragma unroll
  for (int i = 0; i < NV; ++i)
    for (int off = (1 << lg) >> 1; off > 0; off >>= 1)
      x[i] += __shfl_xor_sync(0xffffffffu, x[i], off);
}

// Pose row f of a (., 12) operand; `vec`: the operand is 16-byte aligned
// (rows of 48 or 96 bytes), so the row goes as 16-byte loads.
__device__ __forceinline__ lvba::Pose<float> pose_row(const float* q,
                                                      bool vec) {
  if (!vec) return lvba::load_pose(q, 0);
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4 a = __ldg(q4), b = __ldg(q4 + 1), c = __ldg(q4 + 2);
  return {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
}

__device__ __forceinline__ lvba::Pose<double> pose_row(const double* q,
                                                       bool vec) {
  if (!vec) return lvba::load_pose(q, 0);
  const double2* q2 = reinterpret_cast<const double2*>(q);
  const double2 a = __ldg(q2), b = __ldg(q2 + 1), c = __ldg(q2 + 2);
  const double2 d = __ldg(q2 + 3), e = __ldg(q2 + 4), f = __ldg(q2 + 5);
  return {a.x, a.y, b.x, b.y, c.x, c.y, d.x, d.y, e.x, e.y, f.x, f.y};
}

template <typename T, int EPT>
__global__ void __launch_bounds__(kThreads)
soa_agg_kernel(const AggLaunch<T> L) {
  using namespace lvba;
  int b = 0;
  while (b + 1 < L.nb && (int)blockIdx.x >= L.first[b + 1]) ++b;
  const T* __restrict__ n = L.b[b].n;
  const T* __restrict__ mu = L.b[b].mu;
  const T* __restrict__ Pc = L.b[b].Pc;
  const T* __restrict__ poses = L.b[b].poses;
  const int V = L.b[b].V, K = L.b[b].K, lg = L.b[b].lg;
  const int t = threadIdx.x;
  const int G = 1 << lg;
  const int j = t & (G - 1);       // the thread in its voxel's group
  const int64_t v = (int64_t)(blockIdx.x - L.first[b]) * (kThreads >> lg)
                    + (t >> lg);
  const bool vok = v < V;
  const int64_t row = vok ? v * K : 0;
  const T* __restrict__ pose_v =
      poses + (vok ? (int64_t)((int)v / L.b[b].vper) * L.b[b].vstride : 0);
  const bool vec = (reinterpret_cast<uintptr_t>(poses) & 15) == 0;

  // the running (N, mean, scatter) over the rounds so far
  T Nacc = T(0.), m[3] = {T(0.), T(0.), T(0.)};
  T S[6] = {T(0.), T(0.), T(0.), T(0.), T(0.), T(0.)};
  for (int k0 = 0; k0 < K; k0 += G * EPT) {
    T en[EPT], w1[EPT], w2[EPT], w3[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int k = k0 + e * G + j;
      en[e] = (vok && k < K) ? n[row + k] : T(0.);
    }
    T s1[4] = {T(0.), T(0.), T(0.), T(0.)};        // N, Σ n·wm (3)
    T q[6] = {T(0.), T(0.), T(0.), T(0.), T(0.), T(0.)};  // Σ R Pc Rᵀ
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int64_t c = row + k0 + e * G + j;
      w1[e] = w2[e] = w3[e] = T(0.);
      if (en[e] > T(0.)) {
        Cell<T> x;
        x.mask = T(1.);
        x.n = en[e];
        const T* mk = mu + 3 * c;
        x.m1 = mk[0]; x.m2 = mk[1]; x.m3 = mk[2];
        const T* Pk = Pc + 9 * c;
        x.P11 = Pk[0]; x.P12 = Pk[1]; x.P13 = Pk[2];
        x.P22 = Pk[4]; x.P23 = Pk[5]; x.P33 = Pk[8];
        const Pose<T> P = pose_row(pose_v + 12 * (c - row), vec);
        T Rm1, Rm2, Rm3, RP[9];
        rot_mean(P, x, Rm1, Rm2, Rm3);
        rot_scatter(P, x, RP);
        w1[e] = Rm1 + P.p1;
        w2[e] = Rm2 + P.p2;
        w3[e] = Rm3 + P.p3;
        s1[0] += en[e];
        s1[1] += en[e] * w1[e];
        s1[2] += en[e] * w2[e];
        s1[3] += en[e] * w3[e];
        q[0] += RP[0] * P.R11 + RP[1] * P.R12 + RP[2] * P.R13;
        q[1] += RP[0] * P.R21 + RP[1] * P.R22 + RP[2] * P.R23;
        q[2] += RP[0] * P.R31 + RP[1] * P.R32 + RP[2] * P.R33;
        q[3] += RP[3] * P.R21 + RP[4] * P.R22 + RP[5] * P.R23;
        q[4] += RP[3] * P.R31 + RP[4] * P.R32 + RP[5] * P.R33;
        q[5] += RP[6] * P.R31 + RP[7] * P.R32 + RP[8] * P.R33;
      } else {
        en[e] = T(0.);
      }
    }
    group_sum(s1, lg);
    const T Nr = s1[0];
    const T invr = T(1.0) / (Nr > T(0.) ? Nr : T(1.0));
    const T mr1 = s1[1] * invr, mr2 = s1[2] * invr, mr3 = s1[3] * invr;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {  // a dead slot adds n·d dᵀ = 0
      const T d1 = w1[e] - mr1, d2 = w2[e] - mr2, d3 = w3[e] - mr3;
      q[0] += en[e] * d1 * d1;
      q[1] += en[e] * d1 * d2;
      q[2] += en[e] * d1 * d3;
      q[3] += en[e] * d2 * d2;
      q[4] += en[e] * d2 * d3;
      q[5] += en[e] * d3 * d3;
    }
    group_sum(q, lg);
    if (Nacc == T(0.)) {
      Nacc = Nr;
      m[0] = mr1; m[1] = mr2; m[2] = mr3;
#pragma unroll
      for (int i = 0; i < 6; ++i) S[i] = q[i];
    } else if (Nr > T(0.)) {  // parallel-axis merge of two centred sums
      const T Nn = Nacc + Nr;
      const T f = Nr / Nn;
      const T c = Nacc * f;
      const T d1 = mr1 - m[0], d2 = mr2 - m[1], d3 = mr3 - m[2];
      m[0] += d1 * f; m[1] += d2 * f; m[2] += d3 * f;
      S[0] += q[0] + c * d1 * d1;
      S[1] += q[1] + c * d1 * d2;
      S[2] += q[2] + c * d1 * d3;
      S[3] += q[3] + c * d2 * d2;
      S[4] += q[4] + c * d2 * d3;
      S[5] += q[5] + c * d3 * d3;
      Nacc = Nn;
    }
  }

  if (j == 0 && vok) {
    const T invN = T(1.0) / (Nacc > T(0.) ? Nacc : T(1.0));
    T cov[6], lam[3], u[3], e1[3], e2[3];
#pragma unroll
    for (int i = 0; i < 6; ++i) cov[i] = S[i] * invN;
    eigh3(cov, lam, u, e1, e2);
    L.b[b].residv[v] = Nacc > T(0.) ? lam[0] : T(0.0);
    const T scale = mmax(mabs(lam[2]), T(1e-20));
    const T sc1 = msqrt(T(2.0) / mmax(lam[1] - lam[0], T(1e-9) * scale));
    const T sc2 = msqrt(T(2.0) / mmax(lam[2] - lam[0], T(1e-9) * scale));
    T* o = L.b[b].pv + 16 * v;
    o[0] = u[0]; o[1] = u[1]; o[2] = u[2];
    o[3] = sc1 * e1[0]; o[4] = sc1 * e1[1]; o[5] = sc1 * e1[2];
    o[6] = sc2 * e2[0]; o[7] = sc2 * e2[1]; o[8] = sc2 * e2[2];
    o[9] = m[0]; o[10] = m[1]; o[11] = m[2];
    o[12] = invN; o[13] = T(0.); o[14] = T(0.); o[15] = T(0.);
  }
}

// Launches soa_agg_kernel<T, ept> once over nb <= kMaxBuckets buckets,
// bucket i given by the i-th entry of each array.  A bucket's group is the
// least power of two G >= K / ept threads, at most a warp.  vper >= 1.
template <typename T>
int launch_agg(int nb, const T* const* n, const T* const* mu,
               const T* const* Pc, const T* const* poses, const int* vstride,
               const int* vper, const int* V, const int* K, int ept,
               T* const* residv, T* const* pv, void* stream) {
  if (nb < 1 || nb > kMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  AggLaunch<T> L;
  L.nb = nb;
  int blocks = 0;
  for (int i = 0; i < nb; ++i) {
    if (vper[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    int lg = 0;
    while ((1 << lg) * ept < K[i] && lg < 5) ++lg;
    L.b[i] = {n[i], mu[i], Pc[i], poses[i], residv[i], pv[i],
              (int64_t)vstride[i], vper[i], V[i], K[i], lg};
    L.first[i] = blocks;
    const int vpb = kThreads >> lg;
    blocks += (V[i] + vpb - 1) / vpb;
  }
  L.first[nb] = blocks;
  if (blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ept) {
    case 1: soa_agg_kernel<T, 1><<<blocks, kThreads, 0, s>>>(L); break;
    case 2: soa_agg_kernel<T, 2><<<blocks, kThreads, 0, s>>>(L); break;
    case 4: soa_agg_kernel<T, 4><<<blocks, kThreads, 0, s>>>(L); break;
    case 8: soa_agg_kernel<T, 8><<<blocks, kThreads, 0, s>>>(L); break;
    case 16: soa_agg_kernel<T, 16><<<blocks, kThreads, 0, s>>>(L); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lvba_soa_agg(int nb, const float* const* n,
                            const float* const* mu, const float* const* Pc,
                            const float* const* poses, const int* vstride,
                            const int* vper, const int* V, const int* K,
                            int ept, float* const* residv, float* const* pv,
                            void* stream) {
  return launch_agg(nb, n, mu, Pc, poses, vstride, vper, V, K, ept, residv,
                    pv, stream);
}

extern "C" int lvba_soa_agg_f64(int nb, const double* const* n,
                                const double* const* mu,
                                const double* const* Pc,
                                const double* const* poses,
                                const int* vstride, const int* vper,
                                const int* V, const int* K, int ept,
                                double* const* residv, double* const* pv,
                                void* stream) {
  return launch_agg(nb, n, mu, Pc, poses, vstride, vper, V, K, ept, residv,
                    pv, stream);
}
