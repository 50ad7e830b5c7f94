// Kernel 1: per-voxel aggregation of the plane factor + fused 3x3
// eigensolve (replaces global_lvba_tpu/ops/pallas/soa_fused.py:61
// `_agg_kernel` and the XLA `_soa_eig` beside it).
//
// One block per voxel.  Pass 1 reduces N and Σ n·(R μ + p) over the K
// entries, pass 2 the world scatter in parallel-axis form
// Σ mask·R Pc Rᵀ + n·d dᵀ with d = R μ + p − v̄.  Each thread walks the
// entries k = t, t+T, ... in order and the block sums in a fixed tree
// (block_sum), so the result is bitwise repeatable.  Pass 2 re-reads the
// voxel's cells (26 KB at W = 512, from L1/L2) instead of holding them.
// Thread 0 then runs the eigensolve and writes
//   residv[v] = N > 0 ? λ0 : 0
//   pv[v]     = [u(3), B1(3), B2(3), v̄(3), 1/N, 0, 0, 0]
// with B_i = sqrt(2 / max(λi − λ0, 1e-9·max(|λ2|, 1e-20)))·u_i.
//
// The pose operand is read at poses + v·vstride + 12·k: the (K, 12) pose
// table with vstride 0 on the aligned layout (entry (v, k) takes pose k),
// per-entry pose rows (V, K, 12) with vstride K·12 on the bucketed layout
// (table_select's output).
//
// Templated on the scalar: lvba_soa_agg launches the float instance
// (float32 solves), lvba_soa_agg_f64 the double one (float64 solves).
#include "soa_common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
soa_agg_kernel(const T* __restrict__ n, const T* __restrict__ mu,
               const T* __restrict__ Pc, const T* __restrict__ poses,
               int64_t vstride, int K, T* __restrict__ residv,
               T* __restrict__ pv) {
  using namespace lvba;
  __shared__ T red[6][kThreads];
  const int v = blockIdx.x;
  const int t = threadIdx.x;
  const int64_t row = (int64_t)v * K;
  const T* __restrict__ pose_row = poses + v * vstride;

  T s1[4] = {T(0.), T(0.), T(0.), T(0.)};  // N, Σ n·wm (3)
  for (int k = t; k < K; k += kThreads) {
    const Cell<T> e = load_cell(n, mu, Pc, row + k);
    const Pose<T> P = load_pose(pose_row, k);
    T Rm1, Rm2, Rm3;
    rot_mean(P, e, Rm1, Rm2, Rm3);
    s1[0] += e.n;
    s1[1] += e.n * (Rm1 + P.p1);
    s1[2] += e.n * (Rm2 + P.p2);
    s1[3] += e.n * (Rm3 + P.p3);
  }
  block_sum<T, kThreads, 4>(s1, red);
  const T N = s1[0];
  const T invN = T(1.0) / (N > T(0.) ? N : T(1.0));
  const T vb1 = s1[1] * invN, vb2 = s1[2] * invN, vb3 = s1[3] * invN;

  T S[6] = {T(0.), T(0.), T(0.), T(0.), T(0.), T(0.)};
  for (int k = t; k < K; k += kThreads) {
    const Cell<T> e = load_cell(n, mu, Pc, row + k);
    const Pose<T> P = load_pose(pose_row, k);
    T Rm1, Rm2, Rm3, RP[9];
    rot_mean(P, e, Rm1, Rm2, Rm3);
    rot_scatter(P, e, RP);
    const T d1 = Rm1 + P.p1 - vb1;
    const T d2 = Rm2 + P.p2 - vb2;
    const T d3 = Rm3 + P.p3 - vb3;
    const T S11e = RP[0] * P.R11 + RP[1] * P.R12 + RP[2] * P.R13;
    const T S12e = RP[0] * P.R21 + RP[1] * P.R22 + RP[2] * P.R23;
    const T S13e = RP[0] * P.R31 + RP[1] * P.R32 + RP[2] * P.R33;
    const T S22e = RP[3] * P.R21 + RP[4] * P.R22 + RP[5] * P.R23;
    const T S23e = RP[3] * P.R31 + RP[4] * P.R32 + RP[5] * P.R33;
    const T S33e = RP[6] * P.R31 + RP[7] * P.R32 + RP[8] * P.R33;
    S[0] += e.mask * S11e + e.n * d1 * d1;
    S[1] += e.mask * S12e + e.n * d1 * d2;
    S[2] += e.mask * S13e + e.n * d1 * d3;
    S[3] += e.mask * S22e + e.n * d2 * d2;
    S[4] += e.mask * S23e + e.n * d2 * d3;
    S[5] += e.mask * S33e + e.n * d3 * d3;
  }
  block_sum<T, kThreads, 6>(S, red);

  if (t == 0) {
    T cov[6], lam[3], u[3], e1[3], e2[3];
#pragma unroll
    for (int i = 0; i < 6; ++i) cov[i] = S[i] * invN;
    eigh3(cov, lam, u, e1, e2);
    residv[v] = N > T(0.) ? lam[0] : T(0.0);
    const T scale = mmax(mabs(lam[2]), T(1e-20));
    const T sc1 = msqrt(T(2.0) / mmax(lam[1] - lam[0], T(1e-9) * scale));
    const T sc2 = msqrt(T(2.0) / mmax(lam[2] - lam[0], T(1e-9) * scale));
    T* o = pv + 16 * (int64_t)v;
    o[0] = u[0]; o[1] = u[1]; o[2] = u[2];
    o[3] = sc1 * e1[0]; o[4] = sc1 * e1[1]; o[5] = sc1 * e1[2];
    o[6] = sc2 * e2[0]; o[7] = sc2 * e2[1]; o[8] = sc2 * e2[2];
    o[9] = vb1; o[10] = vb2; o[11] = vb3;
    o[12] = invN; o[13] = T(0.); o[14] = T(0.); o[15] = T(0.);
  }
}

template <typename T>
int launch_agg(const T* n, const T* mu, const T* Pc, const T* poses,
               int vstride, int V, int K, T* residv, T* pv, void* stream) {
  if (V == 0) return 0;
  soa_agg_kernel<T><<<V, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, mu, Pc, poses, vstride, K, residv, pv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lvba_soa_agg(const float* n, const float* mu, const float* Pc,
                            const float* poses, int vstride, int V, int K,
                            float* residv, float* pv, void* stream) {
  return launch_agg(n, mu, Pc, poses, vstride, V, K, residv, pv, stream);
}

extern "C" int lvba_soa_agg_f64(const double* n, const double* mu,
                                const double* Pc, const double* poses,
                                int vstride, int V, int K, double* residv,
                                double* pv, void* stream) {
  return launch_agg(n, mu, Pc, poses, vstride, V, K, residv, pv, stream);
}
