// Native host runtime of global_lvba_tpu_torch: the port's own copy of
// global_lvba_tpu/native/lvba_native.cpp, limited to the six entry points
// that the pipeline calls on a CUDA device (LZF, voxel keys, the radix
// argsort, union-find, the body->world transform and the segment moments),
// and the image codecs that stand in for cv2's (the PNG row unfilter, the
// JPEG encoder and decoder).
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
#include <cstdlib>
#include <cstring>
#include <string>
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

// ---------------------------------------------------------------------------
// PNG row unfilter (the five filter types of the PNG specification, 9.2):
// raw holds H rows of 1 + rowbytes bytes (the filter type, then the filtered
// row), out receives the H * rowbytes reconstructed bytes; bpp is the bytes
// of a whole pixel (1 below 8 bits a pixel).  Paeth and Average run along a
// row byte by byte, which numpy cannot vectorize.  Returns 0, or -1 on a
// filter type outside 0-4.
int lvba_png_unfilter(const unsigned char* raw, long H, long rowbytes,
                      int bpp, unsigned char* out) {
  for (long y = 0; y < H; ++y) {
    const unsigned char* f = raw + y * (rowbytes + 1) + 1;
    const int ft = f[-1];
    unsigned char* c = out + y * rowbytes;
    const unsigned char* p = y > 0 ? c - rowbytes : nullptr;
    switch (ft) {
      case 0:
        std::memcpy(c, f, rowbytes);
        break;
      case 1:
        for (long x = 0; x < rowbytes; ++x)
          c[x] = (unsigned char)(f[x] + (x >= bpp ? c[x - bpp] : 0));
        break;
      case 2:
        for (long x = 0; x < rowbytes; ++x)
          c[x] = (unsigned char)(f[x] + (p ? p[x] : 0));
        break;
      case 3:
        for (long x = 0; x < rowbytes; ++x) {
          const int a = x >= bpp ? c[x - bpp] : 0, b = p ? p[x] : 0;
          c[x] = (unsigned char)(f[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (long x = 0; x < rowbytes; ++x) {
          const int a = x >= bpp ? c[x - bpp] : 0, b = p ? p[x] : 0;
          const int cc = (p && x >= bpp) ? p[x - bpp] : 0;
          const int pa = std::abs(b - cc), pb = std::abs(a - cc),
                    pc = std::abs(a + b - 2 * cc);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : cc);
          c[x] = (unsigned char)(f[x] + pred);
        }
        break;
      default:
        return -1;
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Baseline JPEG encoder with libjpeg's defaults as cv2.imwrite(".jpg") sets
// them: JFIF APP0 1.01, quality 95 (jpeg_quality_scaling of the Annex K
// tables, clamped to 1..255), 4:2:0 (Y 2x2, Cb and Cr 1x1), the Annex K
// Huffman tables, no restart markers.  Each stage is libjpeg's integer
// arithmetic: jccolor's 16-bit fixed-point RGB->YCbCr tables, jcsample's
// h2v2 average with the alternating 1, 2 bias, jfdctint's islow DCT
// (CONST_BITS 13, PASS1_BITS 2), libjpeg-turbo's reciprocal quantizer
// (jcdctmgr compute_reciprocal / quantize), jcprepct's and jccoefct's edge
// padding (the last column and row replicated, dummy blocks carrying the
// DC of the block before them), and jchuff's bit packing (0xFF stuffed
// with 0x00, the last byte padded with ones).
namespace {

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const int kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

const int kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3 tables: 16 code counts by length, then the symbols
const unsigned char kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1,
                                       1, 0, 0, 0, 0, 0, 0, 0};
const unsigned char kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1,
                                         1, 1, 1, 0, 0, 0, 0, 0};
const unsigned char kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const unsigned char kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3,
                                       5, 5, 4, 4, 0, 0, 1, 0x7d};
const unsigned char kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const unsigned char kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4,
                                         7, 5, 4, 4, 0, 1, 2, 0x77};
const unsigned char kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffTable {
  unsigned code[256];
  int size[256];
  void build(const unsigned char* bits, const unsigned char* vals) {
    std::memset(size, 0, sizeof(size));
    unsigned c = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len - 1]; ++i, ++k) {
        code[vals[k]] = c++;
        size[vals[k]] = len;
      }
      c <<= 1;
    }
  }
};

// libjpeg-turbo's quantizer divisor for one coefficient (compute_reciprocal
// with 16-bit DCTELEMs): q_out = ((|x| + corr) * recip) >> (16 + shift)
struct Divisor {
  unsigned recip, corr;
  int shift;
};

Divisor reciprocal(unsigned divisor) {
  if (divisor == 1) return {1, 0, -16};
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  unsigned fq = (1u << r) / divisor, fr = (1u << r) % divisor;
  unsigned c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  return {fq & 0xffffu, c & 0xffffu, r - 16};
}

struct Tables {
  int qtbl[2][64];  // natural order, scaled to quality 95
  Divisor div[2][64];
  HuffTable dc[2], ac[2];
  long ctab[8 * 256];
  Tables() {
    const int scale = 200 - 95 * 2;  // jpeg_quality_scaling(95)
    for (int t = 0; t < 2; ++t)
      for (int i = 0; i < 64; ++i) {
        long v = ((long)(t ? kStdChroma : kStdLuma)[i] * scale + 50) / 100;
        v = v < 1 ? 1 : (v > 255 ? 255 : v);
        qtbl[t][i] = (int)v;
        div[t][i] = reciprocal((unsigned)v << 3);  // islow output is x8
      }
    dc[0].build(kDcLumaBits, kDcVals);
    dc[1].build(kDcChromaBits, kDcVals);
    ac[0].build(kAcLumaBits, kAcLumaVals);
    ac[1].build(kAcChromaBits, kAcChromaVals);
    const long one_half = 1L << 15, cbcr_off = 128L << 16;
    auto fix = [](double x) { return (long)(x * 65536.0 + 0.5); };
    for (long i = 0; i < 256; ++i) {
      ctab[0 * 256 + i] = fix(0.29900) * i;                      // R->Y
      ctab[1 * 256 + i] = fix(0.58700) * i;                      // G->Y
      ctab[2 * 256 + i] = fix(0.11400) * i + one_half;           // B->Y
      ctab[3 * 256 + i] = -fix(0.16874) * i;                     // R->Cb
      ctab[4 * 256 + i] = -fix(0.33126) * i;                     // G->Cb
      ctab[5 * 256 + i] = fix(0.5) * i + cbcr_off + one_half - 1;  // B->Cb, R->Cr
      ctab[6 * 256 + i] = -fix(0.41869) * i;                     // G->Cr
      ctab[7 * 256 + i] = -fix(0.08131) * i;                     // B->Cr
    }
  }
};

// jfdctint.c jpeg_fdct_islow on one block of centred samples, in place
void fdct_islow(int* d) {
  const long c0298 = 2446, c0390 = 3196, c0541 = 4433, c0765 = 6270,
             c0899 = 7373, c1175 = 9633, c1501 = 12299, c1847 = 15137,
             c1961 = 16069, c2053 = 16819, c2562 = 20995, c3072 = 25172;
  auto descale = [](long x, int n) { return (x + (1L << (n - 1))) >> n; };
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass ? 8 : 1, stride = pass ? 1 : 8;
    const int sh = pass ? 13 + 2 : 13 - 2;
    for (int k = 0; k < 8; ++k) {
      int* p = d + k * stride;
      long t0 = p[0] + p[7 * step], t7 = p[0] - p[7 * step];
      long t1 = p[step] + p[6 * step], t6 = p[step] - p[6 * step];
      long t2 = p[2 * step] + p[5 * step], t5 = p[2 * step] - p[5 * step];
      long t3 = p[3 * step] + p[4 * step], t4 = p[3 * step] - p[4 * step];
      long t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
      if (pass == 0) {
        p[0] = (int)((t10 + t11) * 4);
        p[4 * step] = (int)((t10 - t11) * 4);
      } else {
        p[0] = (int)descale(t10 + t11, 2);
        p[4 * step] = (int)descale(t10 - t11, 2);
      }
      long z1 = (t12 + t13) * c0541;
      p[2 * step] = (int)descale(z1 + t13 * c0765, sh);
      p[6 * step] = (int)descale(z1 + t12 * -c1847, sh);
      z1 = t4 + t7;
      long z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
      long z5 = (z3 + z4) * c1175;
      t4 *= c0298;
      t5 *= c2053;
      t6 *= c3072;
      t7 *= c1501;
      z1 *= -c0899;
      z2 *= -c2562;
      z3 *= -c1961;
      z4 *= -c0390;
      z3 += z5;
      z4 += z5;
      p[7 * step] = (int)descale(t4 + z1 + z3, sh);
      p[5 * step] = (int)descale(t5 + z2 + z4, sh);
      p[3 * step] = (int)descale(t6 + z2 + z3, sh);
      p[1 * step] = (int)descale(t7 + z1 + z4, sh);
    }
  }
}

struct BitWriter {
  std::vector<unsigned char>& out;
  unsigned long long acc = 0;
  int n = 0;
  void put(unsigned code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1));
    n += size;
    while (n >= 8) {
      const unsigned char b = (unsigned char)(acc >> (n - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      n -= 8;
    }
  }
  // jchuff flush_bits: seven one bits complete the last byte; the rest
  // of them is dropped
  void flush() {
    put(0x7F, 7);
    acc = 0;
    n = 0;
  }
};

void put_marker(std::vector<unsigned char>& o, int m, const unsigned char* body,
                int len) {
  o.push_back(0xFF);
  o.push_back((unsigned char)m);
  o.push_back((unsigned char)((len + 2) >> 8));
  o.push_back((unsigned char)((len + 2) & 0xFF));
  o.insert(o.end(), body, body + len);
}

// one image (H, W, 3) BGR uint8, row stride W * 3, into `out`
void encode(const Tables& T, const unsigned char* bgr, int H, int W,
            std::vector<unsigned char>& out) {
  // component planes after jcprepct/jcsample padding
  const int ywb = (W + 7) / 8, yhb = (H + 7) / 8;    // Y blocks
  const int cwb = (W + 15) / 16, chb = (H + 15) / 16;  // Cb/Cr blocks
  const int mcux = cwb, mcuy = chb;
  const int yw = ywb * 8, yh = mcuy * 16;  // Y plane (rows to an iMCU)
  const int cw = cwb * 8, ch = mcuy * 8;
  const int hw = cwb * 16;                 // full-size width for h2v2
  const int H2 = (H + 1) / 2 * 2;          // rows to a whole row group
  std::vector<int> Y((size_t)yh * yw), Cb((size_t)ch * cw), Cr((size_t)ch * cw);
  std::vector<int> fy((size_t)2 * hw), fb((size_t)2 * hw), fr((size_t)2 * hw);
  const long* ct = T.ctab;
  for (int g = 0; g < H2 / 2; ++g) {  // row groups of two full-size rows
    for (int k = 0; k < 2; ++k) {
      const int y = std::min(2 * g + k, H - 1);
      const unsigned char* s = bgr + (size_t)y * W * 3;
      int* ry = fy.data() + (size_t)k * hw;
      int* rb = fb.data() + (size_t)k * hw;
      int* rr = fr.data() + (size_t)k * hw;
      for (int x = 0; x < W; ++x) {
        const int b = s[3 * x], gg = s[3 * x + 1], r = s[3 * x + 2];
        ry[x] = (int)((ct[r] + ct[256 + gg] + ct[512 + b]) >> 16);
        rb[x] = (int)((ct[768 + r] + ct[1024 + gg] + ct[1280 + b]) >> 16);
        rr[x] = (int)((ct[1280 + r] + ct[1536 + gg] + ct[1792 + b]) >> 16);
      }
      for (int x = W; x < hw; ++x) {
        ry[x] = ry[W - 1];
        rb[x] = rb[W - 1];
        rr[x] = rr[W - 1];
      }
      for (int x = 0; x < yw; ++x) Y[(size_t)(2 * g + k) * yw + x] = ry[x];
    }
    for (int x = 0; x < cw; ++x) {
      int bias = 1 + (x & 1);
      Cb[(size_t)g * cw + x] = (fb[2 * x] + fb[2 * x + 1] + fb[hw + 2 * x] +
                                fb[hw + 2 * x + 1] + bias) >> 2;
      Cr[(size_t)g * cw + x] = (fr[2 * x] + fr[2 * x + 1] + fr[hw + 2 * x] +
                                fr[hw + 2 * x + 1] + bias) >> 2;
    }
  }
  for (int y = H2; y < yh; ++y)
    std::memcpy(&Y[(size_t)y * yw], &Y[(size_t)(H2 - 1) * yw], yw * sizeof(int));
  for (int y = H2 / 2; y < ch; ++y) {
    std::memcpy(&Cb[(size_t)y * cw], &Cb[(size_t)(H2 / 2 - 1) * cw], cw * sizeof(int));
    std::memcpy(&Cr[(size_t)y * cw], &Cr[(size_t)(H2 / 2 - 1) * cw], cw * sizeof(int));
  }

  // headers
  out.push_back(0xFF);
  out.push_back(0xD8);
  const unsigned char app0[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  put_marker(out, 0xE0, app0, 14);
  for (int t = 0; t < 2; ++t) {
    unsigned char q[65];
    q[0] = (unsigned char)t;
    for (int i = 0; i < 64; ++i) q[1 + i] = (unsigned char)T.qtbl[t][kNatural[i]];
    put_marker(out, 0xDB, q, 65);
  }
  const unsigned char sof[15] = {8, (unsigned char)(H >> 8), (unsigned char)H,
                                 (unsigned char)(W >> 8), (unsigned char)W, 3,
                                 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  put_marker(out, 0xC0, sof, 15);
  const unsigned char* bits[4] = {kDcLumaBits, kAcLumaBits, kDcChromaBits, kAcChromaBits};
  const unsigned char* vals[4] = {kDcVals, kAcLumaVals, kDcVals, kAcChromaVals};
  const unsigned char cls[4] = {0x00, 0x10, 0x01, 0x11};
  for (int t = 0; t < 4; ++t) {
    unsigned char body[17 + 162];
    body[0] = cls[t];
    int n = 0;
    for (int i = 0; i < 16; ++i) n += body[1 + i] = bits[t][i];
    std::memcpy(body + 17, vals[t], n);
    put_marker(out, 0xC4, body, 17 + n);
  }
  const unsigned char sos[10] = {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  put_marker(out, 0xDA, sos, 10);

  // scan: interleaved MCUs of Y 2x2, Cb, Cr
  BitWriter bw{out};
  int last_dc[3] = {0, 0, 0};
  int blk[64], q[64];
  auto block = [&](const int* plane, int pw, int bx, int by, int t) {
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c)
        blk[r * 8 + c] = plane[(size_t)(by * 8 + r) * pw + bx * 8 + c] - 128;
    fdct_islow(blk);
    for (int i = 0; i < 64; ++i) {
      const Divisor& d = T.div[t][i];
      int v = blk[i];
      const unsigned a = (unsigned)((v < 0 ? -v : v) + (int)d.corr) * d.recip;
      int m = (int)(a >> (d.shift + 16));
      q[i] = v < 0 ? -m : m;
    }
  };
  auto emit = [&](int comp, int t) {
    int diff = q[0] - last_dc[comp];
    last_dc[comp] = q[0];
    int a = diff < 0 ? -diff : diff, nb = 0;
    while (a) { ++nb; a >>= 1; }
    bw.put(T.dc[t].code[nb], T.dc[t].size[nb]);
    if (nb) bw.put((unsigned)(diff < 0 ? diff - 1 : diff), nb);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = q[kNatural[k]];
      if (v == 0) { ++run; continue; }
      while (run > 15) {
        bw.put(T.ac[t].code[0xF0], T.ac[t].size[0xF0]);
        run -= 16;
      }
      a = v < 0 ? -v : v;
      nb = 0;
      while (a) { ++nb; a >>= 1; }
      const int sym = (run << 4) + nb;
      bw.put(T.ac[t].code[sym], T.ac[t].size[sym]);
      bw.put((unsigned)(v < 0 ? v - 1 : v), nb);
      run = 0;
    }
    if (run > 0) bw.put(T.ac[t].code[0], T.ac[t].size[0]);
  };
  auto dummy = [&](int dc) {
    std::memset(q, 0, sizeof(q));
    q[0] = dc;
  };
  for (int my = 0; my < mcuy; ++my)
    for (int mx = 0; mx < mcux; ++mx) {
      int prev_dc = 0;
      for (int r = 0; r < 2; ++r)
        for (int c = 0; c < 2; ++c) {
          const int bx = 2 * mx + c, by = 2 * my + r;
          if (by < yhb && bx < ywb) {
            block(Y.data(), yw, bx, by, 0);
          } else {
            // dummy block: the DC of the MCU's previous block, no AC
            dummy(prev_dc);
          }
          prev_dc = q[0];
          emit(0, 0);
        }
      block(Cb.data(), cw, mx, my, 1);
      emit(1, 1);
      block(Cr.data(), cw, mx, my, 1);
      emit(2, 1);
    }
  bw.flush();
  out.push_back(0xFF);
  out.push_back(0xD9);
}

}  // namespace

extern "C" {

// Encode n images (n, H, W, 3) BGR uint8 as baseline JPEGs at quality 95,
// one thread an image on every hardware thread.  Image i's bytes go to
// out + i * cap; sizes[i] receives its length, or -1 where cap was too
// small.  Returns 0.
int lvba_jpeg_encode(const unsigned char* imgs, int n, int H, int W,
                     unsigned char* out, long cap, long* sizes) {
  const Tables T;
  int Tn = (int)std::thread::hardware_concurrency();
  if (Tn < 1) Tn = 1;
  if (Tn > n) Tn = n > 0 ? n : 1;
  std::vector<std::thread> threads;
  for (int t = 0; t < Tn; ++t)
    threads.emplace_back([&, t]() {
      std::vector<unsigned char> buf;
      for (int i = t; i < n; i += Tn) {
        buf.clear();
        encode(T, imgs + (size_t)i * H * W * 3, H, W, buf);
        if ((long)buf.size() > cap) {
          sizes[i] = -1;
          continue;
        }
        std::memcpy(out + (size_t)i * cap, buf.data(), buf.size());
        sizes[i] = (long)buf.size();
      }
    });
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JPEG decoder: libjpeg-turbo's decompressor as cv2.imread drives it
// (jpeg_read_header's defaults: JDCT_ISLOW, do_fancy_upsampling; output
// JCS_EXT_BGR or JCS_GRAYSCALE), bit for bit.  The stages follow libjpeg's
// files:
//   * jdmarker.c: SOI, APPn (JFIF APP0, the first APP1 that begins with
//     "Exif\0\0", Adobe APP14's transform), DQT of 8- and 16-bit entries,
//     SOF0/1/2, DHT, SOS, DRI, RSTn, DNL (skipped, as libjpeg does), COM,
//     EOI; 0xFF fill bytes and FF00 stuffing.  Huffman table slots 0 and
//     1 start as the Annex K tables (jstdhuff.c, for streams that carry
//     none).  A component's quantization table is latched at its first
//     scan (jdinput.c latch_quant_tables).
//   * jdhuff.c / jdphuff.c: sequential scans, interleaved or not (a
//     non-interleaved scan walks the component's own ceil(w / 8) x
//     ceil(h / 8) blocks), the four progressive scan kinds (DC first and
//     refine, AC first with EOB runs, AC refine with correction bits),
//     restart intervals resetting the DC predictors and the EOB run.
//   * jidctint.c: jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2) with the
//     range-limit table of jdmaster.c (x & 1023 around CENTERJSAMPLE).
//   * jdsample.c: h2v1 and h2v2 fancy upsampling where the downsampled
//     width is above 2 (replication otherwise), h1v2 fancy, int_upsample
//     for any other integral ratio; the edge rows repeat, as jdmainct.c's
//     context rows do.
//   * jdcolor.c: ycc_rgb_convert's tables (Cr_r_tab, Cb_b_tab, Cr_g_tab,
//     Cb_g_tab, ONE_HALF rounding), rgb_gray_convert, gray_rgb_convert,
//     and the colour space that jdapimin.c default_decompress_parms
//     picks.  For gray output of a YCbCr file only Y is transformed.
// Not read (an error naming the format): arithmetic coding, lossless and
// hierarchical frames, precision other than 8 bits, 2 or 4 components,
// fractional sampling ratios, and a progressive file whose scans leave one
// of the first nine AC coefficients unrefined (libjpeg smooths those
// blocks).  Where libjpeg warns and goes on (data cut short, a Huffman
// code that is not in its table, a restart marker missing, no EOI), this
// decoder fails.
namespace {

struct JpegFail {
  std::string msg;
};

[[noreturn]] void jfail(const std::string& m) { throw JpegFail{m}; }

// the zigzag order with libjpeg's 16 guard entries (jutils.c)
int natural80(int k) { return k < 64 ? kNatural[k] : 63; }

struct HuffDec {
  int maxcode[17];
  int valoff[17];
  unsigned char bits[16];
  unsigned char vals[256];
  unsigned short look[512];  // (length << 8) | symbol for codes of <= 9 bits
  bool defined = false, built = false;
  // a table as a DHT defines it (jdmarker.c get_dht); checked and derived
  // only by build, at a scan that uses it, as libjpeg does: a bad table
  // that a later DHT replaces before any scan reads it is no error
  void set(const unsigned char* b, const unsigned char* v) {
    int count = 0;
    for (int l = 0; l < 16; ++l) count += b[l];
    if (count > 256) jfail("bad JPEG Huffman table");
    std::memcpy(bits, b, 16);
    std::memcpy(vals, v, count);
    defined = true;
    built = false;
  }
  // jdhuff.c jpeg_make_d_derived_tbl
  void build(bool dc) {
    if (built) return;
    std::memset(look, 0, sizeof(look));
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      const int nl = bits[l - 1];
      // the codes must fit in l bits and none may be all ones; checked
      // before the lookahead fill, which relies on it to stay inside look[]
      if (code + nl >= (1 << l)) jfail("bad JPEG Huffman table");
      valoff[l] = k - code;
      for (int i = 0; i < nl; ++i, ++k, ++code)
        if (l <= 9)
          for (int f = 0; f < (1 << (9 - l)); ++f)
            look[(code << (9 - l)) | f] = (unsigned short)((l << 8) | vals[k]);
      maxcode[l] = nl ? code - 1 : -1;
      code <<= 1;
    }
    if (dc)
      for (int i = 0; i < k; ++i)
        if (vals[i] > 15) jfail("bad JPEG Huffman table");
    built = true;
  }
};

// Entropy-coded bits.  Past a marker (or the end of the data) the reader
// supplies zero bits, as libjpeg does, but a symbol that consumes one of
// them fails: libjpeg warns there and fills the image with zeros.
struct BitReader {
  const unsigned char* d;
  long n, pos;
  unsigned long long acc = 0;  // next bit at bit 63
  int cnt = 0;                 // bits in acc
  int fake = 0;                // of them, zero bits past the data
  bool at_marker = false;
  void reset(long p) {
    pos = p;
    acc = 0;
    cnt = fake = 0;
    at_marker = false;
  }
  void fill() {
    while (cnt <= 56) {
      unsigned c = 0;
      if (!at_marker) {
        if (pos >= n) {
          at_marker = true;
        } else if (d[pos] != 0xFF) {
          c = d[pos++];
        } else {
          long p = pos + 1;
          while (p < n && d[p] == 0xFF) ++p;  // fill bytes
          if (p < n && d[p] == 0) {
            c = 0xFF;
            pos = p + 1;
          } else {
            at_marker = true;  // pos stays on the marker
          }
        }
      }
      if (at_marker) fake += 8;
      acc |= (unsigned long long)c << (56 - cnt);
      cnt += 8;
    }
  }
  unsigned peek(int k) {
    if (cnt < k) fill();
    return (unsigned)(acc >> (64 - k));
  }
  void skip(int k) {
    acc <<= k;
    cnt -= k;
    if (cnt < fake) jfail("JPEG data is cut short or corrupt");
  }
  int get(int k) {
    const int v = (int)peek(k);
    skip(k);
    return v;
  }
  int decode(const HuffDec& h) {
    const unsigned p = peek(16);
    const int e = h.look[p >> 7];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    for (int l = 10; l <= 16; ++l) {
      const int c = (int)(p >> (16 - l));
      if (c <= h.maxcode[l]) {
        skip(l);
        return h.vals[h.valoff[l] + c];
      }
    }
    jfail("corrupt JPEG data: a Huffman code outside its table");
  }
};

inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r + (int)(~0u << s) + 1 : r;
}

struct JComp {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;    // downsampled size (jdinput.c initial_setup)
  int wib = 0, hib = 0;  // the component's own blocks
  int bw = 0, bh = 0;    // blocks stored (the padded MCU grid)
  int td = 0, ta = 0;    // Huffman tables of the current scan
  bool latched = false;
  int q[64] = {0};       // latched quantization table, natural order
  int coef_bits[64];
  std::vector<short> coef;
};

struct JpegFrame {
  const unsigned char* d = nullptr;
  long n = 0;
  int H = 0, W = 0, ncomp = 0, kind = -1;  // 0 baseline, 1 extended, 2 progressive
  int max_h = 1, max_v = 1, mcux = 0, mcuy = 0;
  int color = 0;  // 0 gray, 1 YCbCr, 2 RGB
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  long exif_off = -1, exif_len = 0;
  int restart = 0;
  int qt[4][64];
  bool qdef[4] = {false, false, false, false};
  HuffDec dc[4], ac[4];
  JComp comp[3];
  bool started = false;  // a SOS was read
};

int be16(const unsigned char* p) { return (p[0] << 8) | p[1]; }

void std_huff(JpegFrame& f) {
  f.dc[0].set(kDcLumaBits, kDcVals);
  f.dc[1].set(kDcChromaBits, kDcVals);
  f.ac[0].set(kAcLumaBits, kAcLumaVals);
  f.ac[1].set(kAcChromaBits, kAcChromaVals);
}

const char* sof_name(int m) {
  switch (m) {
    case 0xC3: return "lossless JPEG (SOF3)";
    case 0xC5: return "hierarchical JPEG (SOF5)";
    case 0xC6: return "hierarchical progressive JPEG (SOF6)";
    case 0xC7: return "hierarchical lossless JPEG (SOF7)";
    case 0xC9: return "arithmetic-coded JPEG (SOF9)";
    case 0xCA: return "arithmetic-coded progressive JPEG (SOF10)";
    case 0xCB: return "arithmetic-coded lossless JPEG (SOF11)";
    case 0xCD: return "hierarchical arithmetic-coded JPEG (SOF13)";
    case 0xCE: return "hierarchical arithmetic-coded progressive JPEG (SOF14)";
    case 0xCF: return "hierarchical arithmetic-coded lossless JPEG (SOF15)";
  }
  return nullptr;
}

void read_sof(JpegFrame& f, int m, const unsigned char* p, int len) {
  if (f.kind >= 0) jfail("JPEG with two frame headers");
  if (len < 6) jfail("JPEG frame header is cut short");
  const int prec = p[0];
  f.H = be16(p + 1);
  f.W = be16(p + 3);
  f.ncomp = p[5];
  if (prec != 8)
    jfail(std::to_string(prec) + "-bit JPEG (precision " +
          std::to_string(prec) + ") is not supported (8-bit only)");
  if (f.ncomp == 2 || f.ncomp == 4)
    jfail("JPEG of " + std::to_string(f.ncomp) + " components" +
          (f.ncomp == 4 ? " (CMYK/YCCK)" : "") +
          " is not supported (1 or 3 components)");
  if (f.ncomp != 1 && f.ncomp != 3)
    jfail("JPEG of " + std::to_string(f.ncomp) + " components is not valid");
  if (len < 6 + 3 * f.ncomp) jfail("JPEG frame header is cut short");
  if (f.H == 0) jfail("JPEG height 0 (set by a DNL marker) is not supported");
  if (f.W == 0) jfail("JPEG width 0 is not valid");
  if (f.H > 65500 || f.W > 65500) jfail("JPEG larger than 65500 pixels");
  f.kind = m == 0xC0 ? 0 : (m == 0xC1 ? 1 : 2);
  for (int c = 0; c < f.ncomp; ++c) {
    JComp& k = f.comp[c];
    k.id = p[6 + 3 * c];
    k.h = p[7 + 3 * c] >> 4;
    k.v = p[7 + 3 * c] & 15;
    k.tq = p[8 + 3 * c];
    if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
      jfail("JPEG sampling factors or table ids are not valid");
    f.max_h = std::max(f.max_h, k.h);
    f.max_v = std::max(f.max_v, k.v);
  }
  f.mcux = (f.W + 8 * f.max_h - 1) / (8 * f.max_h);
  f.mcuy = (f.H + 8 * f.max_v - 1) / (8 * f.max_v);
  for (int c = 0; c < f.ncomp; ++c) {
    JComp& k = f.comp[c];
    if (f.max_h % k.h || f.max_v % k.v)
      jfail("JPEG with fractional sampling ratios is not supported");
    k.dw = (int)(((long)f.W * k.h + f.max_h - 1) / f.max_h);
    k.dh = (int)(((long)f.H * k.v + f.max_v - 1) / f.max_v);
    k.wib = (k.dw + 7) / 8;
    k.hib = (k.dh + 7) / 8;
    k.bw = f.mcux * k.h;
    k.bh = f.mcuy * k.v;
    for (int i = 0; i < 64; ++i) k.coef_bits[i] = -1;
  }
}

void read_dqt(JpegFrame& f, const unsigned char* p, int len) {
  int k = 0;
  while (k < len) {
    const int pq = p[k] >> 4, tq = p[k] & 15;
    const int sz = pq ? 129 : 65;
    if (tq > 3 || pq > 1 || k + sz > len) jfail("bad JPEG quantization table");
    for (int i = 0; i < 64; ++i)
      f.qt[tq][kNatural[i]] = pq ? be16(p + k + 1 + 2 * i) : p[k + 1 + i];
    f.qdef[tq] = true;
    k += sz;
  }
}

void read_dht(JpegFrame& f, const unsigned char* p, int len) {
  int k = 0;
  while (k < len) {
    if (k + 17 > len) jfail("bad JPEG Huffman table");
    const int tc = p[k] >> 4, th = p[k] & 15;
    int count = 0;
    for (int i = 0; i < 16; ++i) count += p[k + 1 + i];
    if (tc > 1 || th > 3 || count > 256 || k + 17 + count > len)
      jfail("bad JPEG Huffman table");
    (tc ? f.ac : f.dc)[th].set(p + k + 1, p + k + 17);
    k += 17 + count;
  }
}

// the colour space as jdapimin.c default_decompress_parms picks it
void pick_color(JpegFrame& f) {
  if (f.ncomp == 1) {
    f.color = 0;
  } else if (f.jfif) {
    f.color = 1;
  } else if (f.adobe) {
    f.color = f.adobe_transform == 0 ? 2 : 1;
  } else {
    const int a = f.comp[0].id, b = f.comp[1].id, c = f.comp[2].id;
    f.color = (a == 82 && b == 71 && c == 66) ? 2 : 1;  // 'R', 'G', 'B'
  }
}

// the position of the next marker's 0xFF at or after p (fill bytes and
// stray entropy bytes skipped), or n
long next_marker(const unsigned char* d, long n, long p) {
  while (p + 1 < n) {
    if (d[p] == 0xFF) {
      long q = p + 1;
      while (q < n && d[q] == 0xFF) ++q;
      if (q < n && d[q] != 0) return q - 1;
      p = q + 1;
    } else {
      ++p;
    }
  }
  return n;
}

struct Scan {
  int ns = 0;
  int ci[4];
  int ss = 0, se = 63, ah = 0, al = 0;
};

void block_seq(BitReader& br, const HuffDec& dc, const HuffDec& ac,
               short* blk, int& last_dc) {
  int s = br.decode(dc);
  if (s) s = extend(br.get(s), s);
  s += last_dc;
  last_dc = s;
  blk[0] = (short)s;
  for (int k = 1; k < 64; ++k) {
    const int rs = br.decode(ac);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      blk[natural80(k)] = (short)extend(br.get(s), s);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

void decode_scan(JpegFrame& f, const Scan& sc, BitReader& br) {
  const bool prog = f.kind == 2;
  const bool dc_scan = sc.ss == 0;
  if (prog) {
    // jdphuff.c start_pass_phuff_decoder's checks
    bool bad = dc_scan ? sc.se != 0 : (sc.ss > sc.se || sc.se > 63 || sc.ns != 1);
    if (sc.ah != 0 && sc.al != sc.ah - 1) bad = true;
    if (sc.al > 13) bad = true;
    if (bad) jfail("bad progressive JPEG scan parameters");
    for (int i = 0; i < sc.ns; ++i) {
      JComp& k = f.comp[sc.ci[i]];
      for (int c = sc.ss; c <= sc.se; ++c) k.coef_bits[c] = sc.al;
    }
  }
  for (int i = 0; i < sc.ns; ++i) {
    const JComp& k = f.comp[sc.ci[i]];
    const bool need_dc = !prog || (dc_scan && sc.ah == 0);
    const bool need_ac = !prog || !dc_scan;
    if ((need_dc && !f.dc[k.td].defined) || (need_ac && !f.ac[k.ta].defined))
      jfail("JPEG scan names a Huffman table that is not defined");
    if (need_dc) f.dc[k.td].build(true);
    if (need_ac) f.ac[k.ta].build(false);
  }
  int mx_n, my_n;
  if (sc.ns == 1) {
    mx_n = f.comp[sc.ci[0]].wib;
    my_n = f.comp[sc.ci[0]].hib;
  } else {
    mx_n = f.mcux;
    my_n = f.mcuy;
    int blocks = 0;
    for (int i = 0; i < sc.ns; ++i)
      blocks += f.comp[sc.ci[i]].h * f.comp[sc.ci[i]].v;
    if (blocks > 10) jfail("JPEG MCU of more than 10 blocks");
  }
  int last_dc[4] = {0, 0, 0, 0};
  long eobrun = 0;
  int next_rst = 0, togo = f.restart;
  const int p1 = 1 << sc.al, m1 = -p1;
  const long total = (long)mx_n * my_n;
  for (long m = 0; m < total; ++m) {
    if (f.restart) {
      if (togo == 0) {
        const long mp = next_marker(br.d, br.n, br.pos);
        if (mp + 1 >= br.n || br.d[mp + 1] != 0xD0 + next_rst)
          jfail("JPEG restart marker missing or out of order");
        br.reset(mp + 2);
        next_rst = (next_rst + 1) & 7;
        togo = f.restart;
        last_dc[0] = last_dc[1] = last_dc[2] = last_dc[3] = 0;
        eobrun = 0;
      }
      --togo;
    }
    const int mx = (int)(m % mx_n), my = (int)(m / mx_n);
    for (int i = 0; i < sc.ns; ++i) {
      JComp& k = f.comp[sc.ci[i]];
      const int hb = sc.ns == 1 ? 1 : k.h, vb = sc.ns == 1 ? 1 : k.v;
      for (int by = 0; by < vb; ++by)
        for (int bx = 0; bx < hb; ++bx) {
          const int x = mx * hb + bx, y = my * vb + by;
          short* blk = k.coef.data() + ((size_t)y * k.bw + x) * 64;
          if (!prog) {
            block_seq(br, f.dc[k.td], f.ac[k.ta], blk, last_dc[i]);
          } else if (dc_scan && sc.ah == 0) {  // DC first
            int s = br.decode(f.dc[k.td]);
            if (s) s = extend(br.get(s), s);
            s += last_dc[i];
            last_dc[i] = s;
            blk[0] = (short)(unsigned)((unsigned)s << sc.al);
          } else if (dc_scan) {  // DC refine
            if (br.get(1)) blk[0] = (short)(blk[0] | p1);
          } else if (sc.ah == 0) {  // AC first
            if (eobrun > 0) {
              --eobrun;
              continue;
            }
            const HuffDec& ac = f.ac[k.ta];
            for (int c = sc.ss; c <= sc.se; ++c) {
              const int rs = br.decode(ac);
              int r = rs >> 4, s = rs & 15;
              if (s) {
                c += r;
                s = extend(br.get(s), s);
                blk[natural80(c)] = (short)(unsigned)((unsigned)s << sc.al);
              } else if (r == 15) {
                c += 15;
              } else {
                eobrun = 1L << r;
                if (r) eobrun += br.get(r);
                --eobrun;
                break;
              }
            }
          } else {  // AC refine
            const HuffDec& ac = f.ac[k.ta];
            int c = sc.ss;
            if (eobrun == 0) {
              for (; c <= sc.se; ++c) {
                const int rs = br.decode(ac);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                  s = br.get(1) ? p1 : m1;
                } else if (r != 15) {
                  eobrun = 1L << r;
                  if (r) eobrun += br.get(r);
                  break;
                }
                do {
                  short* t = blk + natural80(c);
                  if (*t != 0) {
                    if (br.get(1) && (*t & p1) == 0)
                      *t = (short)(*t + (*t >= 0 ? p1 : m1));
                  } else if (--r < 0) {
                    break;
                  }
                  ++c;
                } while (c <= sc.se);
                if (s) blk[natural80(c)] = (short)s;
              }
            }
            if (eobrun > 0) {
              for (; c <= sc.se; ++c) {
                short* t = blk + natural80(c);
                if (*t != 0 && br.get(1) && (*t & p1) == 0)
                  *t = (short)(*t + (*t >= 0 ? p1 : m1));
              }
              --eobrun;
            }
          }
        }
    }
  }
}

void read_sos(JpegFrame& f, const unsigned char* p, int len, Scan& sc) {
  if (f.kind < 0) jfail("JPEG scan before its frame header");
  if (len < 1) jfail("JPEG scan header is cut short");
  sc.ns = p[0];
  if (sc.ns < 1 || sc.ns > 4 || len != 4 + 2 * sc.ns)
    jfail("bad JPEG scan header");
  for (int i = 0; i < sc.ns; ++i) {
    const int id = p[1 + 2 * i];
    int c = 0;
    while (c < f.ncomp && f.comp[c].id != id) ++c;
    if (c == f.ncomp) jfail("JPEG scan names a component not in the frame");
    for (int j = 0; j < i; ++j)
      if (sc.ci[j] == c) jfail("JPEG scan names a component twice");
    sc.ci[i] = c;
    f.comp[c].td = p[2 + 2 * i] >> 4;
    f.comp[c].ta = p[2 + 2 * i] & 15;
    if (f.comp[c].td > 3 || f.comp[c].ta > 3) jfail("bad JPEG scan header");
  }
  const unsigned char* t = p + 1 + 2 * sc.ns;
  sc.ss = t[0];
  sc.se = t[1];
  sc.ah = t[2] >> 4;
  sc.al = t[2] & 15;
  for (int i = 0; i < sc.ns; ++i) {  // jdinput.c latch_quant_tables
    JComp& k = f.comp[sc.ci[i]];
    if (k.latched) continue;
    if (!f.qdef[k.tq]) jfail("JPEG component without its quantization table");
    std::memcpy(k.q, f.qt[k.tq], sizeof(k.q));
    k.latched = true;
  }
}

// Markers up to the first SOS (header only) or to EOI (decode: every
// scan entropy-decoded into the components' coefficients).
void parse(JpegFrame& f, bool decode) {
  const unsigned char* d = f.d;
  const long n = f.n;
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) jfail("not a JPEG file");
  long p = 2;
  std_huff(f);
  for (;;) {
    p = next_marker(d, n, p);
    if (p + 1 >= n) jfail("JPEG data ends before its EOI marker");
    const int m = d[p + 1];
    p += 2;
    if (m == 0xD9) {
      if (!f.started) jfail("JPEG without a scan");
      return;
    }
    if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    if (p + 2 > n) jfail("JPEG marker segment is cut short");
    const int len = be16(d + p) - 2;
    const unsigned char* body = d + p + 2;
    if (len < 0 || p + 2 + len > n) jfail("JPEG marker segment is cut short");
    p += 2 + len;
    if (const char* name = sof_name(m))
      jfail(std::string(name) + " is not supported (baseline, extended "
                                "and progressive Huffman only)");
    switch (m) {
      case 0xC0:
      case 0xC1:
      case 0xC2:
        read_sof(f, m, body, len);
        break;
      case 0xC4:
        read_dht(f, body, len);
        break;
      case 0xCC:
        jfail("arithmetic-coded JPEG (DAC) is not supported");
      case 0xDB:
        read_dqt(f, body, len);
        break;
      case 0xDD:
        if (len < 2) jfail("bad JPEG DRI marker");
        f.restart = be16(body);
        break;
      case 0xDE:
      case 0xDF:
        jfail("hierarchical JPEG (DHP/EXP) is not supported");
      case 0xE0:
        if (!f.started && len >= 14 && std::memcmp(body, "JFIF\0", 5) == 0)
          f.jfif = true;
        break;
      case 0xE1:
        if (!f.started && f.exif_off < 0 && len > 6 &&
            std::memcmp(body, "Exif\0\0", 6) == 0) {
          f.exif_off = (long)(body - d) + 6;
          f.exif_len = len - 6;
        }
        break;
      case 0xEE:
        if (!f.started && len >= 12 && std::memcmp(body, "Adobe", 5) == 0) {
          f.adobe = true;
          f.adobe_transform = body[11];
        }
        break;
      case 0xDA: {
        Scan sc;
        read_sos(f, body, len, sc);
        if (!f.started) {
          pick_color(f);
          f.started = true;
          if (!decode) return;
          for (int c = 0; c < f.ncomp; ++c)
            f.comp[c].coef.assign((size_t)f.comp[c].bw * f.comp[c].bh * 64, 0);
        }
        BitReader br{d, n, p};
        decode_scan(f, sc, br);
        p = br.at_marker ? br.pos : next_marker(d, n, br.pos);
        break;
      }
      default:  // other APPn, COM, DNL, JPG, ...: skipped
        break;
    }
  }
}

// the tables of jdmaster.c prepare_range_limit_table and jdcolor.c
struct DecodeTables {
  unsigned char idct_limit[1024];  // the post-IDCT table at x & 1023
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  long y_tab[3 * 256];
  DecodeTables() {
    for (int i = 0; i < 1024; ++i)
      idct_limit[i] = (unsigned char)(i < 128 ? i + 128
                                      : i < 512 ? 255
                                      : i < 896 ? 0
                                                : i - 896);
    const long one_half = 1L << 15;
    auto fix = [](double x) { return (long)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const long x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
      y_tab[i] = fix(0.29900) * i;
      y_tab[256 + i] = fix(0.58700) * i;
      y_tab[512 + i] = fix(0.11400) * i + one_half;
    }
  }
};

inline unsigned char clamp255(int x) {
  return (unsigned char)(x < 0 ? 0 : (x > 255 ? 255 : x));
}

// jidctint.c jpeg_idct_islow: one block of coefficients, dequantized by q,
// into 8 rows of out (stride bytes apart)
void idct_islow(const DecodeTables& T, const short* in, const int* q,
                unsigned char* out, long stride) {
  const long c0298 = 2446, c0390 = 3196, c0541 = 4433, c0765 = 6270,
             c0899 = 7373, c1175 = 9633, c1501 = 12299, c1847 = 15137,
             c1961 = 16069, c2053 = 16819, c2562 = 20995, c3072 = 25172;
  int ws[64];
  for (int c = 0; c < 8; ++c) {  // columns
    const short* s = in + c;
    const int* qq = q + c;
    int* w = ws + c;
    if (!s[8] && !s[16] && !s[24] && !s[32] && !s[40] && !s[48] && !s[56]) {
      const int dc = (int)((unsigned)(s[0] * qq[0]) << 2);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    long z2 = (long)s[16] * qq[16], z3 = (long)s[48] * qq[48];
    long z1 = (z2 + z3) * c0541;
    long t2 = z1 + z3 * -c1847, t3 = z1 + z2 * c0765;
    z2 = (long)s[0] * qq[0];
    z3 = (long)s[32] * qq[32];
    long t0 = (z2 + z3) * 8192, t1 = (z2 - z3) * 8192;
    const long t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
    t0 = (long)s[56] * qq[56];
    t1 = (long)s[40] * qq[40];
    t2 = (long)s[24] * qq[24];
    t3 = (long)s[8] * qq[8];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    long z4 = t1 + t3;
    const long z5 = (z3 + z4) * c1175;
    t0 *= c0298;
    t1 *= c2053;
    t2 *= c3072;
    t3 *= c1501;
    z1 *= -c0899;
    z2 *= -c2562;
    z3 *= -c1961;
    z4 *= -c0390;
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    const int sh = 13 - 2;
    const long rnd = 1L << (sh - 1);
    w[0] = (int)((t10 + t3 + rnd) >> sh);
    w[56] = (int)((t10 - t3 + rnd) >> sh);
    w[8] = (int)((t11 + t2 + rnd) >> sh);
    w[48] = (int)((t11 - t2 + rnd) >> sh);
    w[16] = (int)((t12 + t1 + rnd) >> sh);
    w[40] = (int)((t12 - t1 + rnd) >> sh);
    w[24] = (int)((t13 + t0 + rnd) >> sh);
    w[32] = (int)((t13 - t0 + rnd) >> sh);
  }
  const unsigned char* lim = T.idct_limit;
  for (int r = 0; r < 8; ++r) {  // rows
    const int* w = ws + 8 * r;
    unsigned char* o = out + r * stride;
    const int sh = 13 + 2 + 3;
    const long rnd = 1L << (sh - 1);
    long z2 = w[2], z3 = w[6];
    long z1 = (z2 + z3) * c0541;
    long t2 = z1 + z3 * -c1847, t3 = z1 + z2 * c0765;
    long t0 = ((long)w[0] + w[4]) * 8192, t1 = ((long)w[0] - w[4]) * 8192;
    const long t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
    t0 = w[7];
    t1 = w[5];
    t2 = w[3];
    t3 = w[1];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    long z4 = t1 + t3;
    const long z5 = (z3 + z4) * c1175;
    t0 *= c0298;
    t1 *= c2053;
    t2 *= c3072;
    t3 *= c1501;
    z1 *= -c0899;
    z2 *= -c2562;
    z3 *= -c1961;
    z4 *= -c0390;
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    o[0] = lim[((t10 + t3 + rnd) >> sh) & 1023];
    o[7] = lim[((t10 - t3 + rnd) >> sh) & 1023];
    o[1] = lim[((t11 + t2 + rnd) >> sh) & 1023];
    o[6] = lim[((t11 - t2 + rnd) >> sh) & 1023];
    o[2] = lim[((t12 + t1 + rnd) >> sh) & 1023];
    o[5] = lim[((t12 - t1 + rnd) >> sh) & 1023];
    o[3] = lim[((t13 + t0 + rnd) >> sh) & 1023];
    o[4] = lim[((t13 - t0 + rnd) >> sh) & 1023];
  }
}

// A component's samples at full size: rows [0, H) of width >= W, stride
// `ostride`, from its IDCT plane (dw x dh samples, stride `stride`) as
// jdsample.c upsamples it.
void upsample(const JpegFrame& f, const JComp& k, const unsigned char* pl,
              long stride, unsigned char* out, long ostride) {
  const int hf = f.max_h / k.h, vf = f.max_v / k.v;
  const int dw = k.dw, dh = k.dh;
  const bool fancy_h = dw > 2;
  for (int y = 0; y < f.H; ++y) {
    unsigned char* o = out + (long)y * ostride;
    if (hf == 1 && vf == 1) {
      std::memcpy(o, pl + (long)y * stride, dw);
    } else if (hf == 2 && vf == 1 && fancy_h) {  // h2v1_fancy_upsample
      const unsigned char* in = pl + (long)y * stride;
      o[0] = in[0];
      o[1] = (unsigned char)((in[0] * 3 + in[1] + 2) >> 2);
      for (int c = 1; c < dw - 1; ++c) {
        const int v = in[c] * 3;
        o[2 * c] = (unsigned char)((v + in[c - 1] + 1) >> 2);
        o[2 * c + 1] = (unsigned char)((v + in[c + 1] + 2) >> 2);
      }
      o[2 * dw - 2] = (unsigned char)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
      o[2 * dw - 1] = in[dw - 1];
    } else if (hf == 1 && vf == 2) {  // h1v2_fancy_upsample
      const int i = y >> 1, v = y & 1;
      const unsigned char* in0 = pl + (long)i * stride;
      const unsigned char* in1 =
          pl + (long)(v ? std::min(i + 1, dh - 1) : std::max(i - 1, 0)) * stride;
      const int bias = v ? 2 : 1;
      for (int c = 0; c < dw; ++c)
        o[c] = (unsigned char)((in0[c] * 3 + in1[c] + bias) >> 2);
    } else if (hf == 2 && vf == 2 && fancy_h) {  // h2v2_fancy_upsample
      const int i = y >> 1, v = y & 1;
      const unsigned char* in0 = pl + (long)i * stride;
      const unsigned char* in1 =
          pl + (long)(v ? std::min(i + 1, dh - 1) : std::max(i - 1, 0)) * stride;
      int last = in0[0] * 3 + in1[0];
      int cur = in0[1] * 3 + in1[1];
      o[0] = (unsigned char)((last * 4 + 8) >> 4);
      o[1] = (unsigned char)((last * 3 + cur + 7) >> 4);
      for (int c = 1; c < dw - 1; ++c) {
        const int next = in0[c + 1] * 3 + in1[c + 1];
        o[2 * c] = (unsigned char)((cur * 3 + last + 8) >> 4);
        o[2 * c + 1] = (unsigned char)((cur * 3 + next + 7) >> 4);
        last = cur;
        cur = next;
      }
      o[2 * dw - 2] = (unsigned char)((cur * 3 + last + 8) >> 4);
      o[2 * dw - 1] = (unsigned char)((cur * 4 + 7) >> 4);
    } else {  // h2v1_upsample, h2v2_upsample, int_upsample: replication
      const unsigned char* in = pl + (long)(y / vf) * stride;
      for (int c = 0; c < dw; ++c)
        for (int r = 0; r < hf; ++r) o[c * hf + r] = in[c];
    }
  }
}

// smoothing_ok() of jdcoefct.c on the final coefficient precision
bool would_smooth(const JpegFrame& f) {
  if (f.kind != 2) return false;
  bool useful = false;
  for (int c = 0; c < f.ncomp; ++c) {
    const JComp& k = f.comp[c];
    if (!k.latched) return false;
    for (int i = 0; i < 10; ++i)
      if (k.q[kNatural[i]] == 0) return false;
    if (k.coef_bits[0] < 0) return false;
    for (int i = 1; i < 10; ++i)
      if (k.coef_bits[i] != 0) useful = true;
  }
  return useful;
}

void decode_image(const DecodeTables& T, JpegFrame& f, bool gray,
                  unsigned char* out) {
  parse(f, true);
  if (would_smooth(f))
    jfail("progressive JPEG whose scans leave AC coefficients unrefined "
          "(block smoothing) is not supported");
  const int H = f.H, W = f.W;
  const bool only_y = gray && f.color != 2;
  const int nc = only_y ? 1 : f.ncomp;
  std::vector<unsigned char> full[3];
  long fstride[3];
  for (int c = 0; c < nc; ++c) {
    const JComp& k = f.comp[c];
    const long stride = (long)k.bw * 8;
    std::vector<unsigned char> plane((size_t)stride * k.hib * 8);
    for (int by = 0; by < k.hib; ++by)
      for (int bx = 0; bx < k.wib; ++bx)
        idct_islow(T, k.coef.data() + ((size_t)by * k.bw + bx) * 64, k.q,
                   plane.data() + (size_t)by * 8 * stride + bx * 8, stride);
    const int hf = f.max_h / k.h, vf = f.max_v / k.v;
    if (hf == 1 && vf == 1) {
      full[c].swap(plane);
      fstride[c] = stride;
    } else {
      fstride[c] = (long)k.dw * hf;
      full[c].assign((size_t)fstride[c] * H, 0);
      upsample(f, k, plane.data(), stride, full[c].data(), fstride[c]);
    }
  }
  for (int y = 0; y < H; ++y) {
    const unsigned char* a = full[0].data() + (long)y * fstride[0];
    if (gray) {
      unsigned char* o = out + (long)y * W;
      if (only_y) {
        std::memcpy(o, a, W);
      } else {  // rgb_gray_convert
        const unsigned char* g = full[1].data() + (long)y * fstride[1];
        const unsigned char* b = full[2].data() + (long)y * fstride[2];
        for (int x = 0; x < W; ++x)
          o[x] = (unsigned char)((T.y_tab[a[x]] + T.y_tab[256 + g[x]] +
                                  T.y_tab[512 + b[x]]) >> 16);
      }
      continue;
    }
    unsigned char* o = out + (long)y * W * 3;
    if (f.ncomp == 1) {  // gray_rgb_convert
      for (int x = 0; x < W; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = a[x];
      continue;
    }
    const unsigned char* b1 = full[1].data() + (long)y * fstride[1];
    const unsigned char* b2 = full[2].data() + (long)y * fstride[2];
    if (f.color == 2) {  // rgb_rgb_convert into BGR
      for (int x = 0; x < W; ++x) {
        o[3 * x] = b2[x];
        o[3 * x + 1] = b1[x];
        o[3 * x + 2] = a[x];
      }
      continue;
    }
    for (int x = 0; x < W; ++x) {  // ycc_rgb_convert into BGR
      const int yy = a[x], cb = b1[x], cr = b2[x];
      o[3 * x + 2] = clamp255(yy + T.cr_r[cr]);
      o[3 * x + 1] = clamp255(yy + (int)((T.cb_g[cb] + T.cr_g[cr]) >> 16));
      o[3 * x] = clamp255(yy + T.cb_b[cb]);
    }
  }
}

void put_err(const std::string& m, char* err, int errlen) {
  if (errlen <= 0) return;
  const size_t k = std::min((size_t)errlen - 1, m.size());
  std::memcpy(err, m.data(), k);
  err[k] = 0;
}

}  // namespace

extern "C" {

// The header of a JPEG of n bytes, up to its first scan, into info[16]:
// H, W, components, kind (0 baseline, 1 extended sequential, 2
// progressive), colour space (0 gray, 1 YCbCr, 2 RGB), the offset and
// length of the first APP1 Exif payload after "Exif\0\0" (-1, 0 if none),
// then (h, v) sampling of each component.  Returns 0, or -1 with a message
// in err (errlen bytes) for a file it does not read.
int lvba_jpeg_info(const unsigned char* data, long n, long* info, char* err,
                   int errlen) {
  try {
    JpegFrame f;
    f.d = data;
    f.n = n;
    parse(f, false);
    long v[16] = {f.H, f.W, f.ncomp, f.kind, f.color, f.exif_off, f.exif_len};
    for (int c = 0; c < f.ncomp; ++c) {
      v[7 + 2 * c] = f.comp[c].h;
      v[8 + 2 * c] = f.comp[c].v;
    }
    std::memcpy(info, v, sizeof(v));
    return 0;
  } catch (const JpegFail& e) {
    put_err(e.msg, err, errlen);
    return -1;
  } catch (const std::bad_alloc&) {
    put_err("out of memory decoding a JPEG", err, errlen);
    return -1;
  }
}

// Decode a JPEG into out: (H, W) uint8 Y (gray != 0, cv2's
// IMREAD_GRAYSCALE) or (H, W, 3) BGR (cv2's IMREAD_COLOR), with H and W
// as lvba_jpeg_info gives them.  Returns 0, or -1 with a message in err.
int lvba_jpeg_decode(const unsigned char* data, long n, int gray,
                     unsigned char* out, char* err, int errlen) {
  static const DecodeTables T;
  try {
    JpegFrame f;
    f.d = data;
    f.n = n;
    decode_image(T, f, gray != 0, out);
    return 0;
  } catch (const JpegFail& e) {
    put_err(e.msg, err, errlen);
    return -1;
  } catch (const std::bad_alloc&) {
    put_err("out of memory decoding a JPEG", err, errlen);
    return -1;
  }
}

}  // extern "C"
