// Shared device code of the plane-factor kernels (soa_agg.cu, soa_chain.cu).
//
// Scalar transcriptions of the plain torch functions in
// global_lvba_tpu_torch/ops/eigh3.py (eigvals3_soa, eigh3_soa) and
// global_lvba_tpu_torch/factors/plane_eigen.py (_soa_agg's per-entry
// products, _soa_eig, _soa_chain): the same formulas in the same order
// and the same branch choices, one (voxel, frame) entry per call.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lvba_error.cuh"

namespace lvba {

// Deterministic block sum of NV values per thread: a fixed shared-memory
// tree, every thread gets the totals.
template <int T, int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float (*red)[T]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < NV; ++i) red[i][t] = v[i];
  __syncthreads();
#pragma unroll
  for (int s = T / 2; s > 0; s >>= 1) {
    if (t < s) {
#pragma unroll
      for (int i = 0; i < NV; ++i) red[i][t] += red[i][t + s];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = red[i][0];
  __syncthreads();
}

// One (voxel, frame) cell of the aligned arrays: n (V,K), mu (V,K,3),
// Pc (V,K,3,3) row-major; Pc is symmetric, its upper triangle is read.
struct Cell {
  float mask, n;                 // mask = (n_raw > 0), n = n_raw * mask
  float m1, m2, m3;
  float P11, P12, P13, P22, P23, P33;
};

__device__ __forceinline__ Cell load_cell(const float* __restrict__ n,
                                          const float* __restrict__ mu,
                                          const float* __restrict__ Pc,
                                          int64_t c) {
  Cell e;
  const float nr = n[c];
  e.mask = nr > 0.f ? 1.f : 0.f;
  e.n = nr * e.mask;
  const float* m = mu + 3 * c;
  e.m1 = m[0]; e.m2 = m[1]; e.m3 = m[2];
  const float* P = Pc + 9 * c;
  e.P11 = P[0]; e.P12 = P[1]; e.P13 = P[2];
  e.P22 = P[4]; e.P23 = P[5]; e.P33 = P[8];
  return e;
}

struct Pose {
  float R11, R12, R13, R21, R22, R23, R31, R32, R33, p1, p2, p3;
};

__device__ __forceinline__ Pose load_pose(const float* __restrict__ pose12,
                                          int f) {
  const float* q = pose12 + 12 * (int64_t)f;
  Pose P;
  P.R11 = q[0]; P.R12 = q[1]; P.R13 = q[2];
  P.R21 = q[3]; P.R22 = q[4]; P.R23 = q[5];
  P.R31 = q[6]; P.R32 = q[7]; P.R33 = q[8];
  P.p1 = q[9]; P.p2 = q[10]; P.p3 = q[11];
  return P;
}

// R·mu
__device__ __forceinline__ void rot_mean(const Pose& P, const Cell& e,
                                         float& Rm1, float& Rm2, float& Rm3) {
  Rm1 = P.R11 * e.m1 + P.R12 * e.m2 + P.R13 * e.m3;
  Rm2 = P.R21 * e.m1 + P.R22 * e.m2 + P.R23 * e.m3;
  Rm3 = P.R31 * e.m1 + P.R32 * e.m2 + P.R33 * e.m3;
}

// R·Pc (row-major 9)
__device__ __forceinline__ void rot_scatter(const Pose& P, const Cell& e,
                                            float (&RP)[9]) {
  RP[0] = P.R11 * e.P11 + P.R12 * e.P12 + P.R13 * e.P13;
  RP[1] = P.R11 * e.P12 + P.R12 * e.P22 + P.R13 * e.P23;
  RP[2] = P.R11 * e.P13 + P.R12 * e.P23 + P.R13 * e.P33;
  RP[3] = P.R21 * e.P11 + P.R22 * e.P12 + P.R23 * e.P13;
  RP[4] = P.R21 * e.P12 + P.R22 * e.P22 + P.R23 * e.P23;
  RP[5] = P.R21 * e.P13 + P.R22 * e.P23 + P.R23 * e.P33;
  RP[6] = P.R31 * e.P11 + P.R32 * e.P12 + P.R33 * e.P13;
  RP[7] = P.R31 * e.P12 + P.R32 * e.P22 + P.R33 * e.P23;
  RP[8] = P.R31 * e.P13 + P.R32 * e.P23 + P.R33 * e.P33;
}

// ---- eigvals3_soa ----
__device__ __forceinline__ void eigvals3(float a00, float a01, float a02,
                                         float a11, float a12, float a22,
                                         float& lam0, float& lam1,
                                         float& lam2) {
  const float p1 = a01 * a01 + a02 * a02 + a12 * a12;
  const float q = (a00 + a11 + a22) / 3.0f;
  const float d0 = a00 - q, d1 = a11 - q, d2 = a22 - q;
  const float p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0f * p1;
  const float p = sqrtf(fmaxf(p2, 0.0f) / 6.0f);
  const bool near_scalar = p < 1e-30f;
  const float ps = near_scalar ? 1.0f : p;
  const float b00 = d0 / ps, b11 = d1 / ps, b22 = d2 / ps;
  const float b01 = a01 / ps, b02 = a02 / ps, b12 = a12 / ps;
  const float detB = b00 * (b11 * b22 - b12 * b12)
                     - b01 * (b01 * b22 - b12 * b02)
                     + b02 * (b01 * b12 - b11 * b02);
  const float r = fminf(fmaxf(detB / 2.0f, -1.0f), 1.0f);
  const float phi = acosf(r) / 3.0f;
  float l2 = q + 2.0f * p * cosf(phi);
  float l0 = q + 2.0f * p * cosf(phi + 2.09439510239319549f);  // 2π/3
  float l1 = 3.0f * q - l2 - l0;
  lam0 = near_scalar ? q : l0;
  lam1 = near_scalar ? q : l1;
  lam2 = near_scalar ? q : l2;
}

// ---- _pick_max_col over C = A·B for symmetric A, B ----
__device__ __forceinline__ void max_col_of_sym_prod(
    float a00, float a01, float a02, float a11, float a12, float a22,
    float b00, float b01, float b02, float b11, float b12, float b22,
    float& x, float& y, float& z, float& nrm) {
  const float c00 = a00 * b00 + a01 * b01 + a02 * b02;
  const float c01 = a00 * b01 + a01 * b11 + a02 * b12;
  const float c02 = a00 * b02 + a01 * b12 + a02 * b22;
  const float c10 = a01 * b00 + a11 * b01 + a12 * b02;
  const float c11 = a01 * b01 + a11 * b11 + a12 * b12;
  const float c12 = a01 * b02 + a11 * b12 + a12 * b22;
  const float c20 = a02 * b00 + a12 * b01 + a22 * b02;
  const float c21 = a02 * b01 + a12 * b11 + a22 * b12;
  const float c22 = a02 * b02 + a12 * b12 + a22 * b22;
  const float n0 = c00 * c00 + c10 * c10 + c20 * c20;
  const float n1 = c01 * c01 + c11 * c11 + c21 * c21;
  const float n2 = c02 * c02 + c12 * c12 + c22 * c22;
  const bool use1 = (n1 >= n0) && (n1 >= n2);
  const bool use2 = (n2 > n0) && (n2 > n1) && !use1;
  x = use1 ? c01 : (use2 ? c02 : c00);
  y = use1 ? c11 : (use2 ? c12 : c10);
  z = use1 ? c21 : (use2 ? c22 : c20);
  nrm = sqrtf(use1 ? n1 : (use2 ? n2 : n0));
}

// ---- eigh3_soa: ascending eigenvalues, eigenvectors v0, v1, v2 ----
__device__ __forceinline__ void eigh3(const float (&a)[6], float (&lam)[3],
                                      float (&v0)[3], float (&v1)[3],
                                      float (&v2)[3]) {
  float scale = fmaxf(fmaxf(fmaxf(fabsf(a[0]), fabsf(a[3])), fabsf(a[5])),
                      fmaxf(fmaxf(fabsf(a[1]), fabsf(a[2])), fabsf(a[4])));
  scale = fmaxf(scale, 1e-30f);
  const float s00 = a[0] / scale, s01 = a[1] / scale, s02 = a[2] / scale;
  const float s11 = a[3] / scale, s12 = a[4] / scale, s22 = a[5] / scale;
  float l0, l1, l2;
  eigvals3(s00, s01, s02, s11, s12, s22, l0, l1, l2);
  const float spread = fmaxf(l2 - l0, 1e-30f);

  float x, y, z, n2;
  max_col_of_sym_prod(s00 - l0, s01, s02, s11 - l0, s12, s22 - l0,
                      s00 - l1, s01, s02, s11 - l1, s12, s22 - l1,
                      x, y, z, n2);
  const bool degen = (spread < 1e-7f) || (n2 < 1e-12f);
  if (degen) { x = 0.0f; y = 0.0f; z = 1.0f; }
  const float inv = 1.0f / sqrtf(x * x + y * y + z * z);
  v2[0] = x * inv; v2[1] = y * inv; v2[2] = z * inv;

  float n0;
  max_col_of_sym_prod(s00 - l1, s01, s02, s11 - l1, s12, s22 - l1,
                      s00 - l2, s01, s02, s11 - l2, s12, s22 - l2,
                      x, y, z, n0);
  const bool bad0 = n0 < 1e-12f * fmaxf(spread, 1.0f);
  const float ax = fabsf(v2[0]), ay = fabsf(v2[1]), az = fabsf(v2[2]);
  const bool usey = (ay <= ax) && (ay <= az);
  const bool usez = (az < ax) && (az < ay) && !usey;
  const float fx = usey ? 0.0f : (usez ? 0.0f : 1.0f);
  const float fy = usey ? 1.0f : 0.0f;
  const float fz = usez ? 1.0f : 0.0f;
  if (bad0) { x = fx; y = fy; z = fz; }
  const float d = x * v2[0] + y * v2[1] + z * v2[2];
  x = x - d * v2[0]; y = y - d * v2[1]; z = z - d * v2[2];
  const float nn = sqrtf(x * x + y * y + z * z);
  const bool tiny = nn < 1e-20f;
  const float ns = tiny ? 1.0f : nn;
  v0[0] = tiny ? fx : x / ns;
  v0[1] = tiny ? fy : y / ns;
  v0[2] = tiny ? fz : z / ns;

  v1[0] = v2[1] * v0[2] - v2[2] * v0[1];
  v1[1] = v2[2] * v0[0] - v2[0] * v0[2];
  v1[2] = v2[0] * v0[1] - v2[1] * v0[0];

  lam[0] = l0 * scale; lam[1] = l1 * scale; lam[2] = l2 * scale;
}

}  // namespace lvba
