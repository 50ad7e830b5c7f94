// Shared device code of the plane-factor kernels (soa_agg.cu, soa_chain.cu).
//
// Scalar transcriptions of the plain torch functions in
// global_lvba_tpu_torch/ops/eigh3.py (eigvals3_soa, eigh3_soa) and
// global_lvba_tpu_torch/factors/plane_eigen.py (_soa_agg's per-entry
// products, _soa_eig, _soa_chain): the same formulas in the same order
// and the same branch choices, one (voxel, frame) entry per call.
// Everything is templated on the scalar T: float for float32 solves,
// double for float64 ones (the plain versions' float64 path, with the
// same constants rounded to T).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lvba_error.cuh"

namespace lvba {

// The math functions of T: the float versions are the C ones the
// float32 kernels always called.
__device__ __forceinline__ float msqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double msqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float mmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double mmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float mmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double mmin(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float mabs(float x) { return fabsf(x); }
__device__ __forceinline__ double mabs(double x) { return fabs(x); }
__device__ __forceinline__ float macos(float x) { return acosf(x); }
__device__ __forceinline__ double macos(double x) { return acos(x); }
__device__ __forceinline__ float mcos(float x) { return cosf(x); }
__device__ __forceinline__ double mcos(double x) { return cos(x); }

// One (voxel, frame) cell of the aligned arrays: n (V,K), mu (V,K,3),
// Pc (V,K,3,3) row-major; Pc is symmetric, its upper triangle is read.
template <typename T>
struct Cell {
  T mask, n;                 // mask = (n_raw > 0), n = n_raw * mask
  T m1, m2, m3;
  T P11, P12, P13, P22, P23, P33;
};

template <typename T>
__device__ __forceinline__ Cell<T> load_cell(const T* __restrict__ n,
                                          const T* __restrict__ mu,
                                          const T* __restrict__ Pc,
                                          int64_t c) {
  Cell<T> e;
  const T nr = n[c];
  e.mask = nr > T(0.) ? T(1.) : T(0.);
  e.n = nr * e.mask;
  const T* m = mu + 3 * c;
  e.m1 = m[0]; e.m2 = m[1]; e.m3 = m[2];
  const T* P = Pc + 9 * c;
  e.P11 = P[0]; e.P12 = P[1]; e.P13 = P[2];
  e.P22 = P[4]; e.P23 = P[5]; e.P33 = P[8];
  return e;
}

template <typename T>
struct Pose {
  T R11, R12, R13, R21, R22, R23, R31, R32, R33, p1, p2, p3;
};

template <typename T>
__device__ __forceinline__ Pose<T> load_pose(const T* __restrict__ pose12,
                                          int f) {
  const T* q = pose12 + 12 * (int64_t)f;
  Pose<T> P;
  P.R11 = q[0]; P.R12 = q[1]; P.R13 = q[2];
  P.R21 = q[3]; P.R22 = q[4]; P.R23 = q[5];
  P.R31 = q[6]; P.R32 = q[7]; P.R33 = q[8];
  P.p1 = q[9]; P.p2 = q[10]; P.p3 = q[11];
  return P;
}

// R·mu
template <typename T>
__device__ __forceinline__ void rot_mean(const Pose<T>& P, const Cell<T>& e,
                                         T& Rm1, T& Rm2, T& Rm3) {
  Rm1 = P.R11 * e.m1 + P.R12 * e.m2 + P.R13 * e.m3;
  Rm2 = P.R21 * e.m1 + P.R22 * e.m2 + P.R23 * e.m3;
  Rm3 = P.R31 * e.m1 + P.R32 * e.m2 + P.R33 * e.m3;
}

// R·Pc (row-major 9)
template <typename T>
__device__ __forceinline__ void rot_scatter(const Pose<T>& P, const Cell<T>& e,
                                            T (&RP)[9]) {
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
template <typename T>
__device__ __forceinline__ void eigvals3(T a00, T a01, T a02,
                                         T a11, T a12, T a22,
                                         T& lam0, T& lam1,
                                         T& lam2) {
  const T p1 = a01 * a01 + a02 * a02 + a12 * a12;
  const T q = (a00 + a11 + a22) / T(3.0);
  const T d0 = a00 - q, d1 = a11 - q, d2 = a22 - q;
  const T p2 = d0 * d0 + d1 * d1 + d2 * d2 + T(2.0) * p1;
  const T p = msqrt(mmax(p2, T(0.0)) / T(6.0));
  const bool near_scalar = p < T(1e-30);
  const T ps = near_scalar ? T(1.0) : p;
  const T b00 = d0 / ps, b11 = d1 / ps, b22 = d2 / ps;
  const T b01 = a01 / ps, b02 = a02 / ps, b12 = a12 / ps;
  const T detB = b00 * (b11 * b22 - b12 * b12)
                     - b01 * (b01 * b22 - b12 * b02)
                     + b02 * (b01 * b12 - b11 * b02);
  const T r = mmin(mmax(detB / T(2.0), -T(1.0)), T(1.0));
  const T phi = macos(r) / T(3.0);
  T l2 = q + T(2.0) * p * mcos(phi);
  T l0 = q + T(2.0) * p * mcos(phi + T(2.09439510239319549));  // 2π/3
  T l1 = T(3.0) * q - l2 - l0;
  lam0 = near_scalar ? q : l0;
  lam1 = near_scalar ? q : l1;
  lam2 = near_scalar ? q : l2;
}

// ---- _pick_max_col over C = A·B for symmetric A, B ----
template <typename T>
__device__ __forceinline__ void max_col_of_sym_prod(
    T a00, T a01, T a02, T a11, T a12, T a22,
    T b00, T b01, T b02, T b11, T b12, T b22,
    T& x, T& y, T& z, T& nrm) {
  const T c00 = a00 * b00 + a01 * b01 + a02 * b02;
  const T c01 = a00 * b01 + a01 * b11 + a02 * b12;
  const T c02 = a00 * b02 + a01 * b12 + a02 * b22;
  const T c10 = a01 * b00 + a11 * b01 + a12 * b02;
  const T c11 = a01 * b01 + a11 * b11 + a12 * b12;
  const T c12 = a01 * b02 + a11 * b12 + a12 * b22;
  const T c20 = a02 * b00 + a12 * b01 + a22 * b02;
  const T c21 = a02 * b01 + a12 * b11 + a22 * b12;
  const T c22 = a02 * b02 + a12 * b12 + a22 * b22;
  const T n0 = c00 * c00 + c10 * c10 + c20 * c20;
  const T n1 = c01 * c01 + c11 * c11 + c21 * c21;
  const T n2 = c02 * c02 + c12 * c12 + c22 * c22;
  const bool use1 = (n1 >= n0) && (n1 >= n2);
  const bool use2 = (n2 > n0) && (n2 > n1) && !use1;
  x = use1 ? c01 : (use2 ? c02 : c00);
  y = use1 ? c11 : (use2 ? c12 : c10);
  z = use1 ? c21 : (use2 ? c22 : c20);
  nrm = msqrt(use1 ? n1 : (use2 ? n2 : n0));
}

// ---- eigh3_soa: ascending eigenvalues, eigenvectors v0, v1, v2 ----
template <typename T>
__device__ __forceinline__ void eigh3(const T (&a)[6], T (&lam)[3],
                                      T (&v0)[3], T (&v1)[3],
                                      T (&v2)[3]) {
  T scale = mmax(mmax(mmax(mabs(a[0]), mabs(a[3])), mabs(a[5])),
                      mmax(mmax(mabs(a[1]), mabs(a[2])), mabs(a[4])));
  scale = mmax(scale, T(1e-30));
  const T s00 = a[0] / scale, s01 = a[1] / scale, s02 = a[2] / scale;
  const T s11 = a[3] / scale, s12 = a[4] / scale, s22 = a[5] / scale;
  T l0, l1, l2;
  eigvals3(s00, s01, s02, s11, s12, s22, l0, l1, l2);
  const T spread = mmax(l2 - l0, T(1e-30));

  T x, y, z, n2;
  max_col_of_sym_prod(s00 - l0, s01, s02, s11 - l0, s12, s22 - l0,
                      s00 - l1, s01, s02, s11 - l1, s12, s22 - l1,
                      x, y, z, n2);
  const bool degen = (spread < T(1e-7)) || (n2 < T(1e-12));
  if (degen) { x = T(0.0); y = T(0.0); z = T(1.0); }
  const T inv = T(1.0) / msqrt(x * x + y * y + z * z);
  v2[0] = x * inv; v2[1] = y * inv; v2[2] = z * inv;

  T n0;
  max_col_of_sym_prod(s00 - l1, s01, s02, s11 - l1, s12, s22 - l1,
                      s00 - l2, s01, s02, s11 - l2, s12, s22 - l2,
                      x, y, z, n0);
  const bool bad0 = n0 < T(1e-12) * mmax(spread, T(1.0));
  const T ax = mabs(v2[0]), ay = mabs(v2[1]), az = mabs(v2[2]);
  const bool usey = (ay <= ax) && (ay <= az);
  const bool usez = (az < ax) && (az < ay) && !usey;
  const T fx = usey ? T(0.0) : (usez ? T(0.0) : T(1.0));
  const T fy = usey ? T(1.0) : T(0.0);
  const T fz = usez ? T(1.0) : T(0.0);
  if (bad0) { x = fx; y = fy; z = fz; }
  const T d = x * v2[0] + y * v2[1] + z * v2[2];
  x = x - d * v2[0]; y = y - d * v2[1]; z = z - d * v2[2];
  const T nn = msqrt(x * x + y * y + z * z);
  const bool tiny = nn < T(1e-20);
  const T ns = tiny ? T(1.0) : nn;
  v0[0] = tiny ? fx : x / ns;
  v0[1] = tiny ? fy : y / ns;
  v0[2] = tiny ? fz : z / ns;

  v1[0] = v2[1] * v0[2] - v2[2] * v0[1];
  v1[1] = v2[2] * v0[0] - v2[0] * v0[2];
  v1[2] = v2[0] * v0[1] - v2[1] * v0[0];

  lam[0] = l0 * scale; lam[1] = l1 * scale; lam[2] = l2 * scale;
}

}  // namespace lvba
