// Native host runtime of global_lvba_tpu_torch: the port's own copy of
// global_lvba_tpu/native/lvba_native.cpp, limited to the six entry points
// that the pipeline calls on a CUDA device (LZF, voxel keys, the radix
// argsort, union-find, the body->world transform and the segment moments).
// The reference's equivalents are PCL's PCD reader (+LZF), std::
// unordered_map voxel binning and the BFS track construction
// (src/dataset_io.cpp:263-288, src/lvba_system.cpp:965-986); here they are
// plain C functions bound with ctypes (native/runtime.py), feeding numpy.
//
// Built at first use by kernels/build.host_library() with
//   g++ -O3 -std=c++17 -shared -fPIC -pthread -ffp-contract=off
// -ffp-contract=off keeps every product and sum separately rounded, in the
// order written, as numpy rounds them: transform_points lands within an ulp
// of the numpy path's einsum (which may sum the three products in another
// order) and bin_moments within float64 rounding of its reduceat (pairwise
// within a segment).  The JAX package builds with GCC's default, which
// fuses them into FMAs.
//
// Left out of the JAX file: plane_cgh, lm_solve and set_lapack (the JAX
// bench's CPU baseline), the float32 voxel_keys (no pipeline caller) and
// the host z-buffers (csrc/zbuffer.cu rasterizes on the card).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// LZF decompression (PCL binary_compressed payload layout).
// Returns bytes written, or -1 on malformed input.
long lvba_lzf_decompress(const unsigned char* in, long in_len,
                         unsigned char* out, long out_len) {
  long ip = 0, op = 0;
  while (ip < in_len && op < out_len) {
    unsigned int ctrl = in[ip++];
    if (ctrl < 32) {  // literal run
      long cnt = (long)ctrl + 1;
      if (ip + cnt > in_len || op + cnt > out_len) return -1;
      std::memcpy(out + op, in + ip, cnt);
      ip += cnt;
      op += cnt;
    } else {  // back reference
      long len = ctrl >> 5;
      if (len == 7) {
        if (ip >= in_len) return -1;
        len += in[ip++];
      }
      if (ip >= in_len) return -1;
      long ref = op - (((long)(ctrl & 0x1f)) << 8) - (long)in[ip++] - 1;
      if (ref < 0) return -1;
      len += 2;
      if (op + len > out_len) return -1;
      for (long i = 0; i < len; ++i) out[op + i] = out[ref + i];
      op += len;
    }
  }
  return op;
}

// ---------------------------------------------------------------------------
// Voxel keys of float64 world points: floor(p / voxel) packed into int64
// (20 bits an axis, offset 2^19), threaded; matches map/voxelize.
// pack_voxel_keys(voxel_coords(...)).  Returns -1 when a coordinate leaves
// the packable range (the caller raises).
int lvba_voxel_keys64(const double* pts, long n, double voxel_size,
                      int n_threads, long long* keys_out) {
  const long long OFF = 1LL << 19;
  const long long LIM = 1LL << 20;
  int T = n_threads > 0 ? n_threads : (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  std::vector<int> bad(T, 0);
  std::vector<std::thread> threads;
  for (int t = 0; t < T; ++t) {
    long lo = n * (long)t / T, hi = n * (long)(t + 1) / T;
    threads.emplace_back([=, &bad]() {
      for (long i = lo; i < hi; ++i) {
        long long k = 0;
        for (int j = 0; j < 3; ++j) {
          long long c = (long long)std::floor(pts[i * 3 + j] / voxel_size) + OFF;
          if (c < 0 || c >= LIM) { bad[t] = 1; return; }
          k = (k << 20) | c;
        }
        keys_out[i] = k;
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int t = 0; t < T; ++t)
    if (bad[t]) return -1;
  return 0;
}

// ---------------------------------------------------------------------------
// 8-pass LSD radix sort of int64 keys; fills the permutation (argsort).
// Each pass is stable, so the permutation is numpy's stable argsort.
void lvba_radix_argsort(const long long* keys, long n, long long* perm_out) {
  std::vector<long long> idx(n), tmp_idx(n);
  std::vector<unsigned long long> k(n), tmp_k(n);
  for (long i = 0; i < n; ++i) {
    idx[i] = i;
    k[i] = (unsigned long long)keys[i] ^ 0x8000000000000000ULL;
  }
  long cnt[256];
  for (int pass = 0; pass < 8; ++pass) {
    int shift = pass * 8;
    std::memset(cnt, 0, sizeof(cnt));
    for (long i = 0; i < n; ++i) cnt[(k[i] >> shift) & 0xff]++;
    long sum = 0;
    for (int b = 0; b < 256; ++b) {
      long c = cnt[b];
      cnt[b] = sum;
      sum += c;
    }
    for (long i = 0; i < n; ++i) {
      int b = (k[i] >> shift) & 0xff;
      tmp_k[cnt[b]] = k[i];
      tmp_idx[cnt[b]] = idx[i];
      cnt[b]++;
    }
    k.swap(tmp_k);
    idx.swap(tmp_idx);
  }
  std::memcpy(perm_out, idx.data(), n * sizeof(long long));
}

// ---------------------------------------------------------------------------
// Union-find over match edges; labels each node with its component root.
// nodes: 0..n-1; edges: two int64 arrays of m ends. Path halving + union by
// size.
void lvba_union_find(long n, const long long* edges_a, const long long* edges_b,
                     long m, long long* label_out) {
  std::vector<long long> parent(n);
  std::vector<long long> size(n, 1);
  for (long i = 0; i < n; ++i) parent[i] = i;
  auto find = [&](long long x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };
  for (long e = 0; e < m; ++e) {
    long long ra = find(edges_a[e]);
    long long rb = find(edges_b[e]);
    if (ra == rb) continue;
    if (size[ra] < size[rb]) std::swap(ra, rb);
    parent[rb] = ra;
    size[ra] += size[rb];
  }
  for (long i = 0; i < n; ++i) label_out[i] = find(i);
}

// ---------------------------------------------------------------------------
// Threaded body->world point transform: out_i = R[fid_i] pts_i + p[fid_i].
// The numpy formulation (R[fid] gathered to (N, 3, 3), then einsum)
// materializes 144 MB of per-point rotation copies at 2M points.
void lvba_transform_points(const double* pts, const int* fid, long n,
                           const double* R, const double* p, int n_threads,
                           double* out) {
  int T = n_threads > 0 ? n_threads : (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  std::vector<std::thread> threads;
  for (int t = 0; t < T; ++t) {
    long lo = n * (long)t / T, hi = n * (long)(t + 1) / T;
    threads.emplace_back([=]() {
      for (long i = lo; i < hi; ++i) {
        const double* Ri = R + 9L * fid[i];
        const double* pi = p + 3L * fid[i];
        const double* x = pts + 3 * i;
        double* o = out + 3 * i;
        o[0] = Ri[0] * x[0] + Ri[1] * x[1] + Ri[2] * x[2] + pi[0];
        o[1] = Ri[3] * x[0] + Ri[4] * x[1] + Ri[5] * x[2] + pi[1];
        o[2] = Ri[6] * x[0] + Ri[7] * x[1] + Ri[8] * x[2] + pi[2];
      }
    });
  }
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Threaded per-segment point-moment accumulation: the host half of
// cut_voxel's per-voxel stats (include/BALM/bavoxel.hpp:799-836).  For
// segment i, rows sort_idx[starts[i] .. starts[i+1]) of pts (n, 3)
// accumulate (sum xyz, sum of the 6 unique xxT entries) in segment order
// (np.add.reduceat sums pairwise: the two agree to float64 rounding).
// Threads split the segment list by equal point counts.
void lvba_bin_moments(const double* pts, const long long* sort_idx, long n,
                      const long long* starts, long s, int n_threads,
                      double* sums /* (s, 3) */, double* moms /* (s, 6) */) {
  int T = n_threads > 0 ? n_threads : (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  if ((long)T > s) T = (int)(s > 0 ? s : 1);
  std::vector<std::thread> threads;
  for (int t = 0; t < T; ++t) {
    // balance by POINTS, not segments: segment sizes are heavy-tailed
    long p_lo = n * (long)t / T, p_hi = n * (long)(t + 1) / T;
    // segment range covering [p_lo, p_hi): first segment whose start
    // >= p_lo .. first whose start >= p_hi (starts is sorted, starts[0]=0)
    long s_lo = (long)(std::lower_bound(starts, starts + s, (long long)p_lo) - starts);
    long s_hi = (long)(std::lower_bound(starts, starts + s, (long long)p_hi) - starts);
    threads.emplace_back([=]() {
      for (long i = s_lo; i < s_hi; ++i) {
        long e0 = starts[i];
        long e1 = (i + 1 < s) ? (long)starts[i + 1] : n;
        double s0 = 0, s1 = 0, s2 = 0;
        double m0 = 0, m1 = 0, m2 = 0, m3 = 0, m4 = 0, m5 = 0;
        for (long e = e0; e < e1; ++e) {
          const double* q = pts + 3 * sort_idx[e];
          double x = q[0], y = q[1], z = q[2];
          s0 += x; s1 += y; s2 += z;
          m0 += x * x; m1 += x * y; m2 += x * z;
          m3 += y * y; m4 += y * z; m5 += z * z;
        }
        double* so = sums + 3 * i;
        so[0] = s0; so[1] = s1; so[2] = s2;
        double* mo = moms + 6 * i;
        mo[0] = m0; mo[1] = m1; mo[2] = m2; mo[3] = m3; mo[4] = m4; mo[5] = m5;
      }
    });
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
