// Kernel 2: the per-entry linearization chain of the plane factor
// (replaces global_lvba_tpu/ops/pallas/soa_fused.py:73 `_chain_kernel`),
// in two launchers sharing chain_entry below.
//
// soa_chain_kernel, the frame-aligned layout, with the voxel-axis g/Hd
// sums of plane_eigen.py:1361-1381 finished inside the launch.  It writes
//   * the three factor rows of every cell straight into the Gram operand
//     A (3V, 6W): A[3v + r, 6k + c] = rows18[r·6 + c] (zeros for a dead
//     cell, n == 0), every element, so A needs no fill;
//   * g (W, 6) and Hd (W, 6, 6), the sums over the voxels of jjt (6) and
//     of the diagonal extras (24 distinct channels, written out to the 36
//     of the row-major 6x6 block), stored or, with `accumulate`, added to
//     the values they hold (an evaluation's running sums over its voxel
//     chunks).
// Bound: bytes — A written once (18 values a cell: 75 MB of the W=512
// evaluation's 130 MB in float32), 13 values read a cell, 16 a voxel,
// the pose table; ~560 flops per live cell stay far below the card's
// FLOP/byte balance.
// Design:
//  * A block owns a tile of kTile = 32 frames (lane l on frame k0 + l, its
//    pose row in registers) and a run of vt voxels (kernels/soa.py
//    chain_tile: the grid fills the card's resident blocks once); warp w
//    walks voxels w, w + kWarps, ... of the run.  In the (V, W)
//    layout voxel v's cells for the tile are contiguous in n, μ and Pc,
//    so each is one span: the warp stages a voxel's n, μ, Pc and pv spans
//    into shared memory with 16-byte cp.async copies (single values at
//    unaligned ends: any W, any offset), the next two voxels' copies in
//    flight while the current voxel's chain runs (a ring of kStages
//    buffers a warp).
//  * A dead cell skips the chain: its rows are exact zeros and it adds
//    nothing, as the masked chain gives.  A voxel with no live cell in
//    the tile skips the gather too: its rows leave as 16-byte zeros.
//  * Row r of voxel v over the tile is 6·nt contiguous values of A: the
//    lanes gather it in shared memory (placed at A's misalignment) and
//    the warp stores it with 16-byte vectors, single values at unaligned
//    ends.
//  * The voxel-axis sums finish in the launch, in a fixed order: a lane
//    sums its frame's 30 channels over its voxels in registers; the block
//    adds its warps' sums in warp order and writes them to part (one
//    (30, 32) slot a block); the last block of the frame tile to arrive
//    (an arrival counter, not an atomic sum) adds the tile's slots in
//    voxel-block order and writes g and Hd, then sets its counter back to
//    zero for the next launch.  No atomic sum: bitwise repeatable.  That
//    pass runs on the kernel's tail and grows with the tile's slots, so a
//    block is one a SM (Chain<T>: 16 warps in float, 8 in double): 8 slots
//    a tile at W = 512 on 132 SMs.
//  * Where W·sizeof(T) is a multiple of 16 and every operand 16-byte
//    aligned (the main path), spans and rows move as whole 16-byte chunks
//    with no skew or ends (kFast).
//
// The group form (kGroups), for the aligned banded groups of large W
// (factors/plane_eigen.py AlignedBandedGroups): a stack of G groups of Vp
// voxels at local width W = 2B, n (G·Vp, W), whose group g reads its own
// window of the pose operand, a (G, W, 12) table (frame offset[g] + k at
// row k).  The grid is a set of voxel blocks a group (no block spans two
// groups), each block's lanes load their group's window, and the sums are
// the group's own: the last block of a (group, frame tile) writes them as
// entry rows vals (G·W, 30) — row g·W + k holds window g's slot k in the
// layout of soa_chain_entries' vals (jjt 6 | the 24 distinct d36) — for
// entry_reduce to fold by frame with the other entries of an evaluation.
// A (3·G·Vp, 6W) is the groups' operands stacked (a torch.bmm gives each
// group's Gram).  The W-wide form is the group form's G = 1 with g and Hd
// written out, compiled as its own instance.
//
// soa_chain_entries_kernel, the bucketed layout: `_chain_kernel` on its
// native layout (poses pre-gathered per entry, plane_eigen.py:1388-1390),
// entries e = v·K + k.  It writes
//   * the 30 unique g/Hd channels (jjt 6 | d36 at _D_UNIQUE 24) of every
//     entry to vals[e, :] — zeros for a dead entry (n == 0) — for the
//     frame segment-sum (selection.cu entry_reduce_kernel);
//   * every element of the Gram operand A (3V, 6W): entry e's three
//     factor rows at A[3v + r, 6·frame[e] + c], zero elsewhere — the one-hot
//     M expansion of plane_eigen.py:1485-1489 as an exact store.  A voxel
//     observes a frame at most once, so no two entries write one cell; a
//     dead entry, or one whose frame id lies outside [0, W), writes no
//     rows (its one-hot column is zero in the JAX expansion).
// Bound: bytes — A written once (18·W values a voxel: 172 MB of the
// corridor's 218 MB in float32), 13 moment + 12 pose + 1 id values in and
// 30 out per entry, 16 pv values per voxel; ~560 flops per live entry stay
// far below the card's FLOP/byte balance.
// Design: a block owns `vt` whole voxels (chain_entries_tile picks vt from
// K and V: at most CHAIN_MAX_ENTRIES = 128 entries, one round of the
// block's threads, and enough blocks to spread A's writes).  It stages its entries' inputs (n,
// μ, Pc, pose rows, frame ids; the voxels' pv) into shared memory with
// coalesced 16-byte loads and, after one __syncthreads(), each thread runs
// the chain of one live entry (a dead slot costs no chain), keeps its 18
// row values in registers and puts its 30 channels in shared memory.  Then
// A, voxel by voxel: the voxel's three rows (contiguous) are zero-filled
// with 16-byte stores (single values at unaligned ends: any W) and, behind
// one __syncthreads(), its live entries store their rows over the zeros
// while the L2 still holds those lines (filling the block's whole span
// first let them leave the L2 before the rows came: slower).  Last, the
// block's vals rows leave as one contiguous, coalesced store.  K > 128
// takes rounds of 128 entries, so shared memory stays bounded at any K.
//
// Both kernels are templated on the scalar: the launchers without a
// suffix take float (float32 solves), the _f64 ones double (float64
// solves, with twice the bytes).
#include "soa_common.cuh"

namespace {

// _soa_chain for one entry.  rows: 18 factor-row channels; acc: += jjt (6)
// then the d36 channels at _D_UNIQUE positions (24).
template <typename T>
__device__ __forceinline__ void chain_entry(
    const lvba::Cell<T>& e, const lvba::Pose<T>& P, T Rm1, T Rm2, T Rm3,
    const T (&RP)[9], const T* __restrict__ q, T (&rows)[18],
    T (&acc)[30]) {
  const T m1 = e.m1, m2 = e.m2, m3 = e.m3, n = e.n, mask = e.mask;
  const T P11 = e.P11, P12 = e.P12, P13 = e.P13;
  const T P22 = e.P22, P23 = e.P23, P33 = e.P33;
  const T R11 = P.R11, R12 = P.R12, R13 = P.R13;
  const T R21 = P.R21, R22 = P.R22, R23 = P.R23;
  const T R31 = P.R31, R32 = P.R32, R33 = P.R33;
  const T u1 = q[0], u2 = q[1], u3 = q[2];
  const T B11 = q[3], B12 = q[4], B13 = q[5];
  const T B21 = q[6], B22 = q[7], B23 = q[8];
  const T vb1 = q[9], vb2 = q[10], vb3 = q[11];
  const T invN = q[12];

  const T r1 = R11 * u1 + R21 * u2 + R31 * u3;  // Rᵀu
  const T r2 = R12 * u1 + R22 * u2 + R32 * u3;
  const T r3 = R13 * u1 + R23 * u2 + R33 * u3;
  const T vi1 = n * m1, vi2 = n * m2, vi3 = n * m3;
  const T w1 = vi2 * r3 - vi3 * r2;
  const T w2 = vi3 * r1 - vi1 * r3;
  const T w3 = vi1 * r2 - vi2 * r1;
  const T t1 = P.p1 - vb1;
  const T t2 = P.p2 - vb2;
  const T t3 = P.p3 - vb3;
  const T adot = u1 * t1 + u2 * t2 + u3 * t3;
  const T md = m1 * r1 + m2 * r2 + m3 * r3;
  const T Pr1 = P11 * r1 + P12 * r2 + P13 * r3;
  const T Pr2 = P12 * r1 + P22 * r2 + P23 * r3;
  const T Pr3 = P13 * r1 + P23 * r2 + P33 * r3;
  const T c11 = Pr1 + n * m1 * md + adot * vi1;
  const T c12 = Pr2 + n * m2 * md + adot * vi2;
  const T c13 = Pr3 + n * m3 * md + adot * vi3;
  const T cb1 = n * Rm1 + n * t1;
  const T cb2 = n * Rm2 + n * t2;
  const T cb3 = n * Rm3 + n * t3;

  const T T11 = RP[0] + n * Rm1 * m1 + t1 * vi1;
  const T T12 = RP[1] + n * Rm1 * m2 + t1 * vi2;
  const T T13 = RP[2] + n * Rm1 * m3 + t1 * vi3;
  const T T21 = RP[3] + n * Rm2 * m1 + t2 * vi1;
  const T T22 = RP[4] + n * Rm2 * m2 + t2 * vi2;
  const T T23 = RP[5] + n * Rm2 * m3 + t2 * vi3;
  const T T31 = RP[6] + n * Rm3 * m1 + t3 * vi1;
  const T T32 = RP[7] + n * Rm3 * m2 + t3 * vi2;
  const T T33 = RP[8] + n * Rm3 * m3 + t3 * vi3;
  const T H1_11 = T12 * r3 - T13 * r2;
  const T H1_12 = T13 * r1 - T11 * r3;
  const T H1_13 = T11 * r2 - T12 * r1;
  const T H1_21 = T22 * r3 - T23 * r2;
  const T H1_22 = T23 * r1 - T21 * r3;
  const T H1_23 = T21 * r2 - T22 * r1;
  const T H1_31 = T32 * r3 - T33 * r2;
  const T H1_32 = T33 * r1 - T31 * r3;
  const T H1_33 = T31 * r2 - T32 * r1;
  const T Rh_11 = R12 * c13 - R13 * c12;
  const T Rh_12 = R13 * c11 - R11 * c13;
  const T Rh_13 = R11 * c12 - R12 * c11;
  const T Rh_21 = R22 * c13 - R23 * c12;
  const T Rh_22 = R23 * c11 - R21 * c13;
  const T Rh_23 = R21 * c12 - R22 * c11;
  const T Rh_31 = R32 * c13 - R33 * c12;
  const T Rh_32 = R33 * c11 - R31 * c13;
  const T Rh_33 = R31 * c12 - R32 * c11;
  const T sN = invN * mask;
  const T A11 = (H1_11 - Rh_11) * sN;
  const T A12 = (H1_12 - Rh_12) * sN;
  const T A13 = (H1_13 - Rh_13) * sN;
  const T A21 = (H1_21 - Rh_21) * sN;
  const T A22 = (H1_22 - Rh_22) * sN;
  const T A23 = (H1_23 - Rh_23) * sN;
  const T A31 = (H1_31 - Rh_31) * sN;
  const T A32 = (H1_32 - Rh_32) * sN;
  const T A33 = (H1_33 - Rh_33) * sN;
  const T c2u = cb1 * u1 + cb2 * u2 + cb3 * u3;
  const T A14 = (cb1 * u1 + c2u) * sN;
  const T A15 = (cb1 * u2) * sN;
  const T A16 = (cb1 * u3) * sN;
  const T A24 = (cb2 * u1) * sN;
  const T A25 = (cb2 * u2 + c2u) * sN;
  const T A26 = (cb2 * u3) * sN;
  const T A34 = (cb3 * u1) * sN;
  const T A35 = (cb3 * u2) * sN;
  const T A36 = (cb3 * u3 + c2u) * sN;

  const T j1 = A11 * u1 + A21 * u2 + A31 * u3;
  const T j2 = A12 * u1 + A22 * u2 + A32 * u3;
  const T j3 = A13 * u1 + A23 * u2 + A33 * u3;
  const T j4 = A14 * u1 + A24 * u2 + A34 * u3;
  const T j5 = A15 * u1 + A25 * u2 + A35 * u3;
  const T j6 = A16 * u1 + A26 * u2 + A36 * u3;

  const T Pi11 = P11 + n * m1 * m1;
  const T Pi12 = P12 + n * m1 * m2;
  const T Pi13 = P13 + n * m1 * m3;
  const T Pi22 = P22 + n * m2 * m2;
  const T Pi23 = P23 + n * m2 * m3;
  const T Pi33 = P33 + n * m3 * m3;
  const T hp11 = -r3 * Pi12 + r2 * Pi13;
  const T hp12 = -r3 * Pi22 + r2 * Pi23;
  const T hp13 = -r3 * Pi23 + r2 * Pi33;
  const T hp21 = r3 * Pi11 - r1 * Pi13;
  const T hp22 = r3 * Pi12 - r1 * Pi23;
  const T hp23 = r3 * Pi13 - r1 * Pi33;
  const T hp31 = -r2 * Pi11 + r1 * Pi12;
  const T hp32 = -r2 * Pi12 + r1 * Pi22;
  const T hp33 = -r2 * Pi13 + r1 * Pi23;
  const T F11 = -hp11;
  const T F12 = -c13 - hp12;
  const T F13 = c12 - hp13;
  const T F21 = c13 - hp21;
  const T F22 = -hp22;
  const T F23 = -c11 - hp23;
  const T F31 = -c12 - hp31;
  const T F32 = c11 - hp32;
  const T F33 = -hp33;
  const T two_sN = T(2.0) * invN * mask;

  // gradient
  acc[0] += j1; acc[1] += j2; acc[2] += j3;
  acc[3] += j4; acc[4] += j5; acc[5] += j6;
  // d36 channels 0..17: D_rr rows interleaved with D_rt rows
  acc[6] += two_sN * (F12 * r3 - F13 * r2);
  acc[7] += two_sN * (F13 * r1 - F11 * r3) + T(0.5) * j3;
  acc[8] += two_sN * (F11 * r2 - F12 * r1) - T(0.5) * j2;
  acc[9] += two_sN * w1 * u1;
  acc[10] += two_sN * w1 * u2;
  acc[11] += two_sN * w1 * u3;
  acc[12] += two_sN * (F22 * r3 - F23 * r2) - T(0.5) * j3;
  acc[13] += two_sN * (F23 * r1 - F21 * r3);
  acc[14] += two_sN * (F21 * r2 - F22 * r1) + T(0.5) * j1;
  acc[15] += two_sN * w2 * u1;
  acc[16] += two_sN * w2 * u2;
  acc[17] += two_sN * w2 * u3;
  acc[18] += two_sN * (F32 * r3 - F33 * r2) + T(0.5) * j2;
  acc[19] += two_sN * (F33 * r1 - F31 * r3) - T(0.5) * j1;
  acc[20] += two_sN * (F31 * r2 - F32 * r1);
  acc[21] += two_sN * w3 * u1;
  acc[22] += two_sN * w3 * u2;
  acc[23] += two_sN * w3 * u3;
  // d36 channels 21, 22, 23, 28, 29, 35: the distinct D_tt entries
  const T tn = two_sN * n;
  acc[24] += tn * u1 * u1;
  acc[25] += tn * u1 * u2;
  acc[26] += tn * u1 * u3;
  acc[27] += tn * u2 * u2;
  acc[28] += tn * u2 * u3;
  acc[29] += tn * u3 * u3;

  // factor rows: B·A (2x6) and √2/N·[w; n·u]
  rows[0] = B11 * A11 + B12 * A21 + B13 * A31;
  rows[1] = B11 * A12 + B12 * A22 + B13 * A32;
  rows[2] = B11 * A13 + B12 * A23 + B13 * A33;
  rows[3] = B11 * A14 + B12 * A24 + B13 * A34;
  rows[4] = B11 * A15 + B12 * A25 + B13 * A35;
  rows[5] = B11 * A16 + B12 * A26 + B13 * A36;
  rows[6] = B21 * A11 + B22 * A21 + B23 * A31;
  rows[7] = B21 * A12 + B22 * A22 + B23 * A32;
  rows[8] = B21 * A13 + B22 * A23 + B23 * A33;
  rows[9] = B21 * A14 + B22 * A24 + B23 * A34;
  rows[10] = B21 * A15 + B22 * A25 + B23 * A35;
  rows[11] = B21 * A16 + B22 * A26 + B23 * A36;
  const T sq = T(1.41421356237309515) * invN * mask;
  rows[12] = sq * w1;
  rows[13] = sq * w2;
  rows[14] = sq * w3;
  rows[15] = sq * n * u1;
  rows[16] = sq * n * u2;
  rows[17] = sq * n * u3;
}

// The first value of a span staged at shared memory `sm` (16-byte aligned,
// with 16 bytes of slack) sits at the span's own misalignment, so the
// span's 16-byte chunks land on 16-byte chunks of shared memory.
template <typename U>
__device__ __forceinline__ U* skewed(U* sm, const void* g) {
  return sm + (reinterpret_cast<uintptr_t>(g) & 15) / sizeof(U);
}

// Values before `p`'s next 16-byte boundary, at most count.
template <typename U>
__device__ __forceinline__ int64_t lead_of(const U* p, int64_t count) {
  const int64_t lead =
      ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / sizeof(U);
  return count < lead ? count : lead;
}

// dst[0 .. count) = src[0 .. count) by threads tid of nthr: 16-byte
// vectors where dst and src agree mod 16 (skewed), single values at the
// ends.
template <typename U>
__device__ __forceinline__ void copy_span(U* __restrict__ dst,
                                          const U* __restrict__ src,
                                          int64_t count, int tid, int nthr) {
  constexpr int kv = 16 / sizeof(U);
  const int head = static_cast<int>(lead_of(src, count));
  const int64_t nvec = (count - head) / kv;
  for (int i = tid; i < head; i += nthr) dst[i] = src[i];
  const int4* s4 = reinterpret_cast<const int4*>(src + head);
  int4* d4 = reinterpret_cast<int4*>(dst + head);
  for (int64_t i = tid; i < nvec; i += nthr) d4[i] = s4[i];
  for (int64_t i = head + nvec * kv + tid; i < count; i += nthr)
    dst[i] = src[i];
}

// dst[0 .. count) = 0 by threads tid of nthr, 16-byte stores between the
// ends
template <typename T>
__device__ __forceinline__ void zero_span(T* __restrict__ dst,
                                          int64_t count, int tid,
                                          int nthr) {
  constexpr int kv = 16 / sizeof(T);
  const int head = static_cast<int>(lead_of(dst, count));
  const int64_t nvec = (count - head) / kv;
  for (int i = tid; i < head; i += nthr) dst[i] = T(0.);
  int4* d4 = reinterpret_cast<int4*>(dst + head);
  const int4 z = make_int4(0, 0, 0, 0);
  for (int64_t i = tid; i < nvec; i += nthr) d4[i] = z;
  for (int64_t i = head + nvec * kv + tid; i < count; i += nthr)
    dst[i] = T(0.);
}

// cp.async of B bytes from global memory to shared memory (16 bytes by
// the L2 alone, smaller copies through the L1, as PTX allows them)
template <int B>
__device__ __forceinline__ void cp_async(void* sm, const void* g) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(sm));
  if constexpr (B == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(g));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(g), "n"(B));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// copy_span by a warp's lanes through cp.async: count < 32·16/sizeof(U)
// values, dst skewed to src
template <typename U>
__device__ __forceinline__ void async_span(U* __restrict__ dst,
                                           const U* __restrict__ src,
                                           int count, int lane) {
  constexpr int kv = 16 / static_cast<int>(sizeof(U));
  const int head = static_cast<int>(lead_of(src, count));
  const int nvec = (count - head) / kv;
  const int tail = head + nvec * kv;
  if (lane < head) cp_async<sizeof(U)>(dst + lane, src + lane);
  for (int i = lane; i < nvec; i += 32)
    cp_async<16>(dst + head + i * kv, src + head + i * kv);
  if (tail + lane < count) cp_async<sizeof(U)>(dst + tail + lane,
                                               src + tail + lane);
}

// The same for whole 16-byte chunks between 16-byte aligned addresses,
// no ends: cp.async from global memory, copies, zeros.
__device__ __forceinline__ void async_chunks(void* dst, const void* src,
                                             int chunks, int lane) {
  char* const d = static_cast<char*>(dst);
  const char* const s = static_cast<const char*>(src);
  for (int i = lane; i < chunks; i += 32) cp_async<16>(d + 16 * i, s + 16 * i);
}

__device__ __forceinline__ void copy_chunks(void* dst, const void* src,
                                            int chunks, int lane) {
  int4* const d = static_cast<int4*>(dst);
  const int4* const s = static_cast<const int4*>(src);
  for (int i = lane; i < chunks; i += 32) d[i] = s[i];
}

__device__ __forceinline__ void zero_chunks(void* dst, int chunks, int lane) {
  int4* const d = static_cast<int4*>(dst);
  for (int i = lane; i < chunks; i += 32) d[i] = make_int4(0, 0, 0, 0);
}

// The aligned chain's warps a block for each scalar, passed by
// kernels/build.py from kernels/soa.py CHAIN_WARPS (chain_tile sizes the
// grid with them).
#if !defined(LVBA_CHAIN_WARPS_F32) || !defined(LVBA_CHAIN_WARPS_F64)
#error "built by kernels/build.py, which passes the aligned chain's warps"
#endif
template <typename T>
struct Chain {
  static constexpr int kWarps =
      sizeof(T) == 4 ? LVBA_CHAIN_WARPS_F32 : LVBA_CHAIN_WARPS_F64;
  static constexpr int kThreads = 32 * kWarps;
  static_assert(kWarps >= 1 && kThreads <= 1024, "whole warps");
};
constexpr int kTile = 32;   // frames a block: one a lane
constexpr int kCh = 30;     // summed channels: jjt 6 | the 24 distinct d36
constexpr int kStages = 3;  // a warp's voxels staged at once: 2 in flight

// The 36 row-major Hd channels from the 24 distinct ones
// (factors/plane_eigen.py _D24_TO_36).
__constant__ int kD24To36[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11,
    12, 13, 14, 15, 16, 17, 3,  9,  15, 18, 19, 20,
    4,  10, 16, 19, 21, 22, 5,  11, 17, 20, 22, 23};

// Shared memory of the aligned chain, in values of T: per warp a ring of
// kStages buffers of one voxel's spans (n, μ, Pc over the tile, pv) and
// three staged rows, each region with 16 bytes of slack for the skew.
// After the voxels, a warp's region holds its (kCh, kTile) sums.
template <typename T>
struct ChainSmem {
  static constexpr int kSlack = 16 / sizeof(T);
  static constexpr int kN = kTile + kSlack;
  static constexpr int kMu = 3 * kTile + kSlack;
  static constexpr int kPc = 9 * kTile + kSlack;
  static constexpr int kPv = 16 + kSlack;
  static constexpr int kBuf = kN + kMu + kPc + kPv;
  static constexpr int kRow = 6 * kTile + kSlack;
  static constexpr int kRows = kStages * kBuf;  // the staged rows' offset
  static constexpr int kWarp = kRows + 3 * kRow;
  static constexpr int kBytes = Chain<T>::kWarps * kWarp * sizeof(T);
  static_assert(kN * sizeof(T) % 16 == 0 && kMu * sizeof(T) % 16 == 0 &&
                    kPc * sizeof(T) % 16 == 0 && kPv * sizeof(T) % 16 == 0 &&
                    kRow * sizeof(T) % 16 == 0,
                "every region starts 16-byte aligned");
  static_assert(kWarp >= kCh * kTile, "a warp's region holds its sums");
};

// Resident blocks a SM the launch bounds ask for: 512 threads a SM in
// float32 (128 registers a thread), 256 in float64 (255 registers).
template <typename T>
struct ChainOcc {
  static constexpr int kThreadsPerSm = sizeof(T) == 4 ? 512 : 256;
  static constexpr int kPer = kThreadsPerSm / Chain<T>::kThreads;
  static constexpr int kMinBlocks = kPer > 0 ? kPer : 1;
};

// Where voxel v's spans of the tile starting at cell c sit in buffer buf:
// at each span's misalignment, or at the regions' starts on the aligned
// path (kFast: every span starts 16-byte aligned).
template <typename T, bool kFast>
struct Spans {
  T* n;
  T* mu;
  T* Pc;
  T* pv;
  __device__ __forceinline__ Spans(T* buf, const T* n_, const T* mu_,
                                   const T* Pc_, const T* pv_, int64_t c,
                                   int v) {
    using L = ChainSmem<T>;
    n = buf;
    mu = buf + L::kN;
    Pc = buf + L::kN + L::kMu;
    pv = buf + L::kN + L::kMu + L::kPc;
    if constexpr (!kFast) {
      n = skewed(n, n_ + c);
      mu = skewed(mu, mu_ + 3 * c);
      Pc = skewed(Pc, Pc_ + 9 * c);
      pv = skewed(pv, pv_ + 16 * (int64_t)v);
    }
  }
};

// kFast: W·sizeof(T) a multiple of 16 and every operand 16-byte aligned,
// so every span and staged row is whole 16-byte chunks (the main path's
// W = 512); otherwise spans and rows go through their ends one value at
// a time.
// kGroups: the group form (groups of Vp voxels, each with its pose window
// and its sums as entry rows in vals); otherwise Vp == V, one group.
template <typename T, bool kFast, bool kGroups>
__global__ void __launch_bounds__(Chain<T>::kThreads,
                                  ChainOcc<T>::kMinBlocks)
soa_chain_kernel(const T* __restrict__ n, const T* __restrict__ mu,
                 const T* __restrict__ Pc, const T* __restrict__ pose12,
                 const T* __restrict__ pv, int V, int W, int vt, int Vp,
                 T* __restrict__ A, T* __restrict__ g, T* __restrict__ Hd,
                 T* __restrict__ vals, int accumulate, T* __restrict__ part,
                 int* __restrict__ arrivals) {
  using namespace lvba;
  using L = ChainSmem<T>;
  using C = Chain<T>;
  extern __shared__ __align__(16) unsigned char chain_smem[];
  __shared__ int last;
  T* const smem = reinterpret_cast<T*>(chain_smem);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* const wsm = smem + warp * L::kWarp;
  const int tile = blockIdx.x;
  // the voxel blocks of a group, this block's group and its voxel block
  const int nvb = kGroups ? (Vp + vt - 1) / vt : gridDim.y;
  const int grp = kGroups ? blockIdx.y / nvb : 0;
  const int vb = kGroups ? blockIdx.y - grp * nvb : blockIdx.y;
  const int vbase = kGroups ? grp * Vp : 0;       // the group's first voxel
  const int vend = kGroups ? vbase + Vp : V;
  const int slot0 = grp * gridDim.x + tile;        // (group, tile)
  const int k0 = tile * kTile;
  const int nt = min(kTile, W - k0);  // frames in the tile
  const bool on = lane < nt;
  const int64_t ld = 6 * (int64_t)W;  // row stride of A
  Pose<T> P{};
  if (on) P = load_pose(pose12 + (int64_t)grp * W * 12, k0 + lane);
  T acc[kCh];
#pragma unroll
  for (int i = 0; i < kCh; ++i) acc[i] = T(0.);

  const int cn = nt * static_cast<int>(sizeof(T)) / 16;  // kFast: n's chunks
  auto stage = [&](int v, T* buf) {
    const int64_t c = (int64_t)v * W + k0;
    const Spans<T, kFast> s(buf, n, mu, Pc, pv, c, v);
    if constexpr (kFast) {
      async_chunks(s.n, n + c, cn, lane);
      async_chunks(s.mu, mu + 3 * c, 3 * cn, lane);
      async_chunks(s.Pc, Pc + 9 * c, 9 * cn, lane);
      async_chunks(s.pv, pv + 16 * (int64_t)v, sizeof(T), lane);
    } else {
      async_span(s.n, n + c, nt, lane);
      async_span(s.mu, mu + 3 * c, 3 * nt, lane);
      async_span(s.Pc, Pc + 9 * c, 9 * nt, lane);
      async_span(s.pv, pv + 16 * (int64_t)v, 16, lane);
    }
  };
  const int v1 = min(vend, vbase + (vb + 1) * vt);
  constexpr int kStep = C::kWarps;  // a warp's voxels: warp, warp + kStep...
  int v = vbase + vb * vt + warp;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (v + i * kStep < v1) stage(v + i * kStep, wsm + i * L::kBuf);
    cp_async_commit();
  }
  for (int b = 0; v < v1; v += kStep, b = (b + 1) % kStages) {
    T* const buf = wsm + b * L::kBuf;
    const int va = v + (kStages - 1) * kStep;  // into the freed buffer
    if (va < v1) stage(va, wsm + (b + kStages - 1) % kStages * L::kBuf);
    cp_async_commit();  // (empty groups at the last voxels)
    cp_async_wait<kStages - 1>();  // voxel v's spans have landed
    __syncwarp();
    const int64_t c = (int64_t)v * W + k0;
    const Spans<T, kFast> s(buf, n, mu, Pc, pv, c, v);
    T* const out = A + 3 * (int64_t)v * ld + 6 * (int64_t)k0;
    Cell<T> e{};
    if (on) e = load_cell(s.n, s.mu, s.Pc, lane);
    const bool live = on && e.mask != T(0.);
    if (__ballot_sync(0xffffffffu, live) == 0u) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        if constexpr (kFast) zero_chunks(out + r * ld, 6 * cn, lane);
        else zero_span(out + r * ld, 6 * nt, lane, 32);
      }
    } else {
      T* st[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        st[r] = wsm + L::kRows + r * L::kRow;
        if constexpr (!kFast) st[r] = skewed(st[r], out + r * ld);
      }
      if (live) {
        T Rm1, Rm2, Rm3, RP[9], rows[18];
        rot_mean(P, e, Rm1, Rm2, Rm3);
        rot_scatter(P, e, RP);
        chain_entry(e, P, Rm1, Rm2, Rm3, RP, s.pv, rows, acc);
#pragma unroll
        for (int r = 0; r < 3; ++r) {
#pragma unroll
          for (int cc = 0; cc < 6; ++cc)
            st[r][6 * lane + cc] = rows[r * 6 + cc];
        }
      } else if (on) {
#pragma unroll
        for (int r = 0; r < 3; ++r) {
#pragma unroll
          for (int cc = 0; cc < 6; ++cc) st[r][6 * lane + cc] = T(0.);
        }
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        if constexpr (kFast) copy_chunks(out + r * ld, st[r], 6 * cn, lane);
        else copy_span(out + r * ld, st[r], 6 * nt, lane, 32);
      }
    }
    __syncwarp();  // buffer b and the staged rows are free again
  }
  cp_async_wait<0>();
  __syncwarp();

  // the block's sums: its warps' in warp order, into its slot of part
#pragma unroll
  for (int i = 0; i < kCh; ++i) wsm[i * kTile + lane] = acc[i];
  __syncthreads();
  constexpr int kSlot = kCh * kTile;
  T* const mine = part + ((int64_t)slot0 * nvb + vb) * kSlot;
  for (int j = threadIdx.x; j < kSlot; j += C::kThreads) {
    T s = smem[j];
    for (int w = 1; w < C::kWarps; ++w) s += smem[w * L::kWarp + j];
    mine[j] = s;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(arrivals + slot0, 1) == nvb - 1;
  __syncthreads();
  if (!last) return;
  // the tile's last block: the running g and Hd of its frames loaded
  // first (kOut values a thread), then the tile's slots added in
  // voxel-block order (kCols columns a thread, kAhead slots' loads in
  // flight at once), then g and Hd stored (kGroups: the group's entry
  // rows)
  __threadfence();
  constexpr int kOut = (42 * kTile + C::kThreads - 1) / C::kThreads;
  T* o[kOut];
  T old[kOut];
  int col[kOut];  // the column of the tile's sums each output takes
#pragma unroll
  for (int u = 0; u < kOut; ++u) {
    const int j = threadIdx.x + u * C::kThreads;
    o[u] = nullptr;
    old[u] = T(0.);
    col[u] = 0;
    if (!kGroups && j < 42 * nt) {
      const int l = j / 42, q = j - 42 * l;
      col[u] = (q < 6 ? q : 6 + kD24To36[q - 6]) * kTile + l;
      o[u] = q < 6 ? g + 6 * (int64_t)(k0 + l) + q
                   : Hd + 36 * (int64_t)(k0 + l) + (q - 6);
      if (accumulate) old[u] = __ldcg(o[u]);
    }
  }
  const T* const slots = part + (int64_t)slot0 * nvb * kSlot;
  constexpr int kCols = (kSlot + C::kThreads - 1) / C::kThreads;
  constexpr int kAhead = 8;
  T sum[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) sum[c] = T(0.);
  for (int i0 = 0; i0 < nvb; i0 += kAhead) {
    T x[kAhead][kCols];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = threadIdx.x + c * C::kThreads;
        x[u][c] = i0 + u < nvb && j < kSlot
                      ? __ldcg(slots + (int64_t)(i0 + u) * kSlot + j)
                      : T(0.);
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) sum[c] += x[u][c];
    }
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int j = threadIdx.x + c * C::kThreads;
    if (j < kSlot) smem[j] = sum[c];
  }
  __syncthreads();
  if constexpr (kGroups) {
    // rows g·W + k0 .. + nt of vals, kCh values each, contiguous
    T* const rows = vals + ((int64_t)grp * W + k0) * kCh;
    for (int j = threadIdx.x; j < kCh * nt; j += C::kThreads) {
      const int l = j / kCh;
      rows[j] = smem[(j - kCh * l) * kTile + l];
    }
  } else {
#pragma unroll
    for (int u = 0; u < kOut; ++u) {
      if (o[u] != nullptr)
        *o[u] = accumulate ? old[u] + smem[col[u]] : smem[col[u]];
    }
  }
  if (threadIdx.x == 0) arrivals[slot0] = 0;
}

// The limits of chain_entries_tile (kernels/soa.py CHAIN_MAX_ENTRIES and
// CHAIN_MAX_TILE), passed by kernels/build.py.
#if !defined(LVBA_CHAIN_MAX_ENTRIES) || !defined(LVBA_CHAIN_MAX_TILE)
#error "built by kernels/build.py, which passes the per-entry block limits"
#endif
constexpr int kEntryThreads = LVBA_CHAIN_MAX_ENTRIES;  // entries a round
constexpr int kMaxTile = LVBA_CHAIN_MAX_TILE;          // voxels a block
static_assert(kEntryThreads % 32 == 0 && kEntryThreads <= 1024,
              "one entry a thread, whole warps");

template <typename T>
struct EntrySmem {
  static constexpr int kSlack = 16 / sizeof(T);
  static constexpr int kPv = 16 * kMaxTile + kSlack;
  static constexpr int kN = kEntryThreads + kSlack;
  static constexpr int kMu = 3 * kEntryThreads + kSlack;
  static constexpr int kPc = 9 * kEntryThreads + kSlack;
  static constexpr int kPose = 12 * kEntryThreads + kSlack;
  static constexpr int kVals = 30 * kEntryThreads + kSlack;
  static constexpr int kFrame = kEntryThreads + 4;          // ints
  static constexpr int kValues = kPv + kN + kMu + kPc + kPose + kVals;
  static constexpr int kBytes = kValues * sizeof(T) + kFrame * 4;
};

template <typename T>
__global__ void __launch_bounds__(kEntryThreads)
soa_chain_entries_kernel(const T* __restrict__ n,
                         const T* __restrict__ mu,
                         const T* __restrict__ Pc,
                         const T* __restrict__ poses,
                         const int* __restrict__ frame,
                         const T* __restrict__ pv, int V, int K, int W,
                         int vt, T* __restrict__ A, T* __restrict__ vals) {
  using namespace lvba;
  using L = EntrySmem<T>;
  extern __shared__ __align__(16) unsigned char entry_smem[];
  // every region starts 16-byte aligned (each size is a multiple of 16 B)
  T* const sm_pv = reinterpret_cast<T*>(entry_smem);
  T* const sm_n = sm_pv + L::kPv;
  T* const sm_mu = sm_n + L::kN;
  T* const sm_Pc = sm_mu + L::kMu;
  T* const sm_pose = sm_Pc + L::kPc;
  T* const sm_vals = sm_pose + L::kPose;
  int* const sm_frame = reinterpret_cast<int*>(sm_vals + L::kVals);

  const int v0 = blockIdx.x * vt;
  const int nv = min(vt, V - v0);
  const int64_t ld = 6 * (int64_t)W;  // row stride of A
  T* const spv = skewed(sm_pv, pv + 16 * (int64_t)v0);
  copy_span(spv, pv + 16 * (int64_t)v0, 16 * (int64_t)nv, threadIdx.x,
            blockDim.x);

  const int64_t e0 = (int64_t)v0 * K;
  const int ne = nv * K;
  for (int r0 = 0; r0 < ne; r0 += kEntryThreads) {
    const int m = min(kEntryThreads, ne - r0);
    const int64_t e = e0 + r0;  // the round's first entry
    if (r0 > 0) __syncthreads();  // the last round's reads are done
    T* cn = skewed(sm_n, n + e);
    T* cmu = skewed(sm_mu, mu + 3 * e);
    T* cPc = skewed(sm_Pc, Pc + 9 * e);
    T* cpose = skewed(sm_pose, poses + 12 * e);
    int* cf = skewed(sm_frame, frame + e);
    T* cv = skewed(sm_vals, vals + 30 * e);
    copy_span(cn, n + e, m, threadIdx.x, blockDim.x);
    copy_span(cmu, mu + 3 * e, 3 * (int64_t)m, threadIdx.x, blockDim.x);
    copy_span(cPc, Pc + 9 * e, 9 * (int64_t)m, threadIdx.x, blockDim.x);
    copy_span(cpose, poses + 12 * e, 12 * (int64_t)m, threadIdx.x, blockDim.x);
    copy_span(cf, frame + e, m, threadIdx.x, blockDim.x);
    __syncthreads();  // the inputs are staged
    const int j = threadIdx.x;
    T rows[18];
    int mine = -1, f = 0;  // the voxel (in the block) and frame of my rows
    if (j < m) {
      T* o = cv + 30 * j;
      const Cell<T> c = load_cell(cn, cmu, cPc, j);
      if (c.mask == T(0.)) {
#pragma unroll
        for (int i = 0; i < 30; ++i) o[i] = T(0.);
      } else {
        const int vl = (r0 + j) / K;  // the voxel within the block
        const Pose<T> P = load_pose(cpose, j);
        T acc[30];
#pragma unroll
        for (int i = 0; i < 30; ++i) acc[i] = T(0.);
        T Rm1, Rm2, Rm3, RP[9];
        rot_mean(P, c, Rm1, Rm2, Rm3);
        rot_scatter(P, c, RP);
        chain_entry(c, P, Rm1, Rm2, Rm3, RP, spv + 16 * vl, rows, acc);
#pragma unroll
        for (int i = 0; i < 30; ++i) o[i] = acc[i];
        f = cf[j];
        if (f >= 0 && f < W) mine = vl;
      }
    }
    // A, voxel by voxel: the voxel's three rows zero-filled (in the round
    // where its first entry lies), then, behind one barrier, its entries'
    // rows stored over the zeros while the L2 still holds those lines
    for (int vl = r0 / K; vl <= (r0 + m - 1) / K; ++vl) {
      if (vl * K >= r0)
        zero_span(A + 3 * (int64_t)(v0 + vl) * ld, 3 * ld, threadIdx.x,
                  blockDim.x);
      __syncthreads();
      if (mine == vl) {
        T* out = A + 3 * (int64_t)(v0 + vl) * ld + 6 * (int64_t)f;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
#pragma unroll
          for (int cc = 0; cc < 6; ++cc) out[r * ld + cc] = rows[r * 6 + cc];
        }
      }
    }
    // (the loop's barriers put every vals row in shared memory first)
    copy_span(vals + 30 * e, cv, 30 * (int64_t)m, threadIdx.x, blockDim.x);
  }
}

template <typename T>
int chain_smem_attr() {
  constexpr int bytes = ChainSmem<T>::kBytes;
  if (bytes <= 48 * 1024) return 0;
  const void* const fns[] = {
      reinterpret_cast<const void*>(soa_chain_kernel<T, true, false>),
      reinterpret_cast<const void*>(soa_chain_kernel<T, false, false>),
      reinterpret_cast<const void*>(soa_chain_kernel<T, true, true>),
      reinterpret_cast<const void*>(soa_chain_kernel<T, false, true>)};
  for (const void* f : fns) {
    const cudaError_t e = cudaFuncSetAttribute(
        f, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// G == 0: the W-wide form (g, Hd); G >= 1: the group form, V == G·Vp
// (vals).
template <typename T>
int launch_chain(const T* n, const T* mu, const T* Pc, const T* pose12,
                 const T* pv, int V, int W, int vt, int G, int Vp, T* A,
                 T* g, T* Hd, T* vals, int accumulate, T* part,
                 int* arrivals, void* stream) {
  if (V < 1 || W < 1 || vt < 1 || G < 0 ||
      (G > 0 && (Vp < 1 || (int64_t)G * Vp != V)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = chain_smem_attr<T>();
  if (err != 0) return err;
  const int64_t gy = G > 0 ? (int64_t)G * ((Vp + vt - 1) / vt)
                           : (V + vt - 1) / vt;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kTile - 1) / kTile, static_cast<unsigned>(gy));
  const bool fast = (W * sizeof(T)) % 16 == 0 && aligned16(n) &&
                    aligned16(mu) && aligned16(Pc) && aligned16(pv) &&
                    aligned16(A);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kT = Chain<T>::kThreads, kB = ChainSmem<T>::kBytes;
  if (G > 0 && fast)
    soa_chain_kernel<T, true, true><<<grid, kT, kB, s>>>(
        n, mu, Pc, pose12, pv, V, W, vt, Vp, A, g, Hd, vals, accumulate,
        part, arrivals);
  else if (G > 0)
    soa_chain_kernel<T, false, true><<<grid, kT, kB, s>>>(
        n, mu, Pc, pose12, pv, V, W, vt, Vp, A, g, Hd, vals, accumulate,
        part, arrivals);
  else if (fast)
    soa_chain_kernel<T, true, false><<<grid, kT, kB, s>>>(
        n, mu, Pc, pose12, pv, V, W, vt, V, A, g, Hd, vals, accumulate,
        part, arrivals);
  else
    soa_chain_kernel<T, false, false><<<grid, kT, kB, s>>>(
        n, mu, Pc, pose12, pv, V, W, vt, V, A, g, Hd, vals, accumulate,
        part, arrivals);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int chain_occupancy(int* blocks) {
  const int err = chain_smem_attr<T>();
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, soa_chain_kernel<T, true, false>, Chain<T>::kThreads,
      ChainSmem<T>::kBytes));
}

template <typename T>
int launch_chain_entries(const T* n, const T* mu, const T* Pc,
                         const T* poses, const int* frame, const T* pv,
                         int V, int K, int W, int vt, T* A, T* vals,
                         void* stream) {
  if ((int64_t)V * K == 0) return 0;
  if (vt < 1 || vt > kMaxTile)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = EntrySmem<T>::kBytes;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        soa_chain_entries_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (V + vt - 1) / vt;
  soa_chain_entries_kernel<T><<<blocks, kEntryThreads, bytes,
                                static_cast<cudaStream_t>(stream)>>>(
      n, mu, Pc, poses, frame, pv, V, K, W, vt, A, vals);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A (3V, 6W) is written in full.  G == 0 (the W-wide form): pose12 is
// (W, 12), g (W, 6) and Hd (W, 6, 6) are stored, or added to with
// `accumulate`; vals is unused.  G >= 1 (the group form): V == G·Vp,
// pose12 is (G, W, 12), vals (G·W, 30) is stored; g, Hd and accumulate
// are unused.  vt voxels a block (kernels/soa.py chain_tile); part holds
// ceil(W / 32) · max(G, 1) · (voxel blocks a group) slots of 30 · 32
// values; arrivals[ceil(W / 32) · max(G, 1)] must be zero, and the launch
// leaves it so.
extern "C" int lvba_soa_chain(const float* n, const float* mu,
                              const float* Pc, const float* pose12,
                              const float* pv, int V, int W, int vt, int G,
                              int Vp, float* A, float* g, float* Hd,
                              float* vals, int accumulate, float* part,
                              int* arrivals, void* stream) {
  return launch_chain(n, mu, Pc, pose12, pv, V, W, vt, G, Vp, A, g, Hd, vals,
                      accumulate, part, arrivals, stream);
}

extern "C" int lvba_soa_chain_f64(const double* n, const double* mu,
                                  const double* Pc, const double* pose12,
                                  const double* pv, int V, int W, int vt,
                                  int G, int Vp, double* A, double* g,
                                  double* Hd, double* vals, int accumulate,
                                  double* part, int* arrivals,
                                  void* stream) {
  return launch_chain(n, mu, Pc, pose12, pv, V, W, vt, G, Vp, A, g, Hd, vals,
                      accumulate, part, arrivals, stream);
}

// Resident blocks a SM of soa_chain_kernel's float (f64 == 0) or double
// instance, written to *blocks.
extern "C" int lvba_soa_chain_occupancy(int f64, int* blocks) {
  return f64 ? chain_occupancy<double>(blocks) : chain_occupancy<float>(blocks);
}

// A (3V, 6W) and vals (V·K, 30) are written in full (A needs no fill);
// vt voxels a block, 1 <= vt <= CHAIN_MAX_TILE (kernels/soa.py
// chain_entries_tile).
extern "C" int lvba_soa_chain_entries(const float* n, const float* mu,
                                      const float* Pc, const float* poses,
                                      const int* frame, const float* pv,
                                      int V, int K, int W, int vt, float* A,
                                      float* vals, void* stream) {
  return launch_chain_entries(n, mu, Pc, poses, frame, pv, V, K, W, vt, A,
                              vals, stream);
}

extern "C" int lvba_soa_chain_entries_f64(const double* n, const double* mu,
                                          const double* Pc,
                                          const double* poses,
                                          const int* frame, const double* pv,
                                          int V, int K, int W, int vt,
                                          double* A, double* vals,
                                          void* stream) {
  return launch_chain_entries(n, mu, Pc, poses, frame, pv, V, K, W, vt, A,
                              vals, stream);
}
