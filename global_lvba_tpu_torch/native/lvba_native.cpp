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
// (jpeg_read_header's defaults: JDCT_ISLOW, do_fancy_upsampling,
// do_block_smoothing; output JCS_EXT_BGR or JCS_GRAYSCALE, or JCS_CMYK for
// four components, which cv2 turns into BGR or gray itself), bit for bit.
// The stages follow libjpeg's files:
//   * jdmarker.c: SOI, APPn (JFIF APP0, the first APP1 that begins with
//     "Exif\0\0", Adobe APP14's transform), DQT of 8- and 16-bit entries,
//     SOF0/1/2/3/9/10, DHT, DAC (conditioning L, U and Kx; 0, 1 and 5 by
//     default), SOS, DRI, RSTn, DNL (skipped, as libjpeg does), COM, EOI;
//     0xFF fill bytes and FF00 stuffing.  Huffman table slots 0 and 1
//     start as the Annex K tables (jstdhuff.c, for streams that carry
//     none).  A component's quantization table is latched at its first
//     scan (jdinput.c latch_quant_tables).
//   * jdhuff.c / jdphuff.c: sequential scans, interleaved or not (a
//     non-interleaved scan walks the component's own ceil(w / 8) x
//     ceil(h / 8) blocks), the four progressive scan kinds (DC first and
//     refine, AC first with EOB runs, AC refine with correction bits),
//     restart intervals resetting the DC predictors and the EOB run.
//   * jdarith.c: the QM decoder (jaricom.c's Qe table; past a marker it
//     reads zero bytes), 64 DC and 256 AC statistics bins a table, DC
//     conditioning on the last difference,
//     the sequential MCU decoder and the four progressive ones; a restart
//     resets the statistics, the predictions and the decoder.
//   * jdlhuff.c / jddiffct.c / jdlossls.c: lossless frames, precision 2-8
//     (the 8-bit API that cv2 reads through), predictors 1-7, the first
//     row of a scan or restart interval predicted from 2^(P - Pt - 1) and
//     its left neighbour, the first column from the row above, samples
//     modulo 2^16, scaled back by the point transform into 8 bits; rows
//     are undifferenced an iMCU row at a time, as libjpeg does (a restart
//     inside one resets the first row of the iMCU row).
//   * jidctint.c: jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2) as
//     libjpeg-turbo's SIMD version computes it (16-bit lanes: wrapping
//     sums, saturating passes; the same as the C version within an
//     encoder's range).
//   * jdcoefct.c: block smoothing of a progressive file whose scans leave
//     one of the first nine AC coefficients imprecise (smoothing_ok,
//     decompress_smooth_data of libjpeg-turbo 2.1 and later: a 5 x 5
//     neighbourhood of DC values; the DC itself too where no AC scan came).
//   * jdsample.c: h2v1 and h2v2 fancy upsampling where the downsampled
//     width is above 2 (replication otherwise, and always in lossless
//     frames), h1v2 fancy, int_upsample for any other integral ratio; the
//     edge rows repeat, as jdmainct.c's context rows do.
//   * jdcolor.c: ycc_rgb_convert's tables (Cr_r_tab, Cb_b_tab, Cr_g_tab,
//     Cb_g_tab, ONE_HALF rounding), ycck_cmyk_convert, rgb_gray_convert,
//     gray_rgb_convert, and the colour space that jdapimin.c
//     default_decompress_parms picks (four components: CMYK, or YCCK under
//     Adobe transform other than 0).  For gray output of a YCbCr file only
//     Y is transformed.  A lossless frame converts nothing but RGB to BGR
//     (gray out of a gray frame, CMYK out of a CMYK one).
//   * cv2's CMYK to BGR (y', m', c') and to gray, x' = k - (((255 - x) k)
//     >> 8), gray (4899 R + 9617 G + 1868 B + 8192) >> 14.
// Not read (an error naming the format), as cv2 reads none of them:
// hierarchical frames, arithmetic-coded lossless frames, precision other
// than 8 bits (2-8 lossless), 2 or more than 4 components, fractional
// sampling ratios, and the colour conversions a lossless frame refuses.
// Damaged data is read as libjpeg reads it through the stdio source that
// cv2.imread hands it (jdatasrc.c, jdhuff.c, jdphuff.c, jdlhuff.c,
// jdarith.c, jdmarker.c), warning and going on where libjpeg does:
//   * the file is followed by a fake EOI, again at every read past its end
//     (JWRN_JPEG_EOF): the stream reads as the file then FF D9 FF D9 ...;
//   * a Huffman scan that reaches a marker reads zero bits; a bit taken
//     from them sets insufficient_data (JWRN_HIT_MARKER), the MCU is
//     finished from zeros, and later MCUs of its restart interval are not
//     decoded (zero coefficients, the DC predictors kept; a lossless MCU
//     row zero differences, its predictor back at the first row);
//   * a Huffman code outside its table takes 17 bits and decodes as 0
//     (JWRN_HUFF_BAD_CODE);
//   * a restart marker missing or out of order goes through
//     jpeg_resync_to_restart (discard it, scan on, or leave it unread for
//     an empty interval); insufficient_data is cleared unless a marker is
//     left unread;
//   * an arithmetic scan reads zeros past a marker, and a code libjpeg
//     flags as bad (JWRN_ARITH_BAD_CODE) ends its MCU and the rest of its
//     restart interval;
//   * a file of one scan is done when its scan is: what follows is read
//     by jpeg_finish_decompress, after cv2 has its image;
//   * the block smoothing of a progressive file takes the previous scan's
//     coefficient precision for iMCU rows past the last one decoded with
//     data (last_good_iMCU_row).
// What libjpeg treats as fatal fails here too: no SOI, a cut header (its
// fake EOI comes before any scan), bad tables or scan parameters, a second
// SOI or SOF, reserved markers, and the formats above.
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
  // set by a DHT: the standard tables (std_huff) serve sequential frames
  // only (jdhuff.c jinit_huff_decoder); libjpeg's progressive and lossless
  // decoders load none
  bool dht = false;
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
  // jdhuff.c jpeg_make_d_derived_tbl; a DC table's symbols stop at 15, or
  // 16 in a lossless frame
  void build(bool dc, int max_dc = 15) {
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
        if (vals[i] > max_dc) jfail("bad JPEG Huffman table");
    built = true;
  }
};

// The byte stream as libjpeg's stdio source gives it: the file, then FF D9
// over and over (a fake EOI at each read past the end).  pos is the next
// byte; unread a marker read but not yet acted on (libjpeg's
// unread_marker), pos then past it.
struct Stream {
  const unsigned char* d;
  long n, pos;
  int unread = 0;
  int at(long p) const { return p < n ? d[p] : ((p - n) & 1 ? 0xD9 : 0xFF); }
  // jdmarker.c next_marker: bytes up to an FF skipped, fill bytes and FF 00
  // passed over; the marker's code, pos past it
  int next_marker() {
    for (;;) {
      while (at(pos) != 0xFF) ++pos;
      int c;
      do c = at(++pos); while (c == 0xFF);
      ++pos;
      if (c != 0) return c;
    }
  }
};

// jdmarker.c read_restart_marker and jpeg_resync_to_restart: past RSTn
// (next_rst), or resynchronised as libjpeg chooses by the marker's
// distance from it
void read_restart(Stream& s, int& next_rst) {
  if (!s.unread) s.unread = s.next_marker();
  if (s.unread == 0xD0 + next_rst) {
    s.unread = 0;
  } else {
    for (;;) {
      const int m = s.unread;
      int action;
      if (m < 0xC0)
        action = 2;  // not a valid marker: scan on
      else if (m < 0xD0 || m > 0xD7)
        action = 3;  // a marker that is no RSTn: leave it unread
      else if (m == 0xD0 + ((next_rst + 1) & 7) ||
               m == 0xD0 + ((next_rst + 2) & 7))
        action = 3;  // one of the next two restarts
      else if (m == 0xD0 + ((next_rst - 1) & 7) ||
               m == 0xD0 + ((next_rst - 2) & 7))
        action = 2;  // an earlier restart: scan on
      else
        action = 1;  // the one wanted, or too far away: discard it
      if (action == 1) s.unread = 0;
      if (action != 2) break;
      s.unread = s.next_marker();
    }
  }
  next_rst = (next_rst + 1) & 7;
}

// Entropy-coded bits.  Past a marker the reader supplies zero bits, as
// libjpeg does, and a symbol that takes one of them sets insufficient.
struct BitReader {
  Stream s;
  unsigned long long acc = 0;  // next bit at bit 63
  int cnt = 0;                 // bits in acc
  int fake = 0;                // of them, zero bits past a marker
  bool insufficient = false;
  // jdhuff.c process_restart: the bits left thrown away, past the RSTn
  void restart(int& next_rst) {
    acc = 0;
    cnt = fake = 0;
    read_restart(s, next_rst);
    if (!s.unread) insufficient = false;
  }
  void fill() {
    while (cnt <= 56) {
      unsigned c = 0;
      if (!s.unread) {
        const int b = s.at(s.pos);
        if (b != 0xFF) {
          c = b;
          ++s.pos;
        } else {
          long p = s.pos + 1;
          while (s.at(p) == 0xFF) ++p;  // fill bytes
          if (s.at(p) == 0) {
            c = 0xFF;
          } else {
            s.unread = s.at(p);
          }
          s.pos = p + 1;
        }
      }
      if (s.unread) fake += 8;
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
    if (cnt < fake) {
      insufficient = true;
      fake = cnt;
    }
  }
  int get(int k) {
    const int v = (int)peek(k);
    skip(k);
    return v;
  }
  // a code of up to 9 bits from the lookahead table, longer ones a bit
  // length at a time (jpeg_huff_decode); one that no length matches takes
  // 17 bits and reads as 0
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
    peek(17);
    skip(17);
    return 0;
  }
};

// jaricom.c's Table D.2: (Qe << 16) | (Next_Index_MPS << 8) |
// (Switch_MPS << 7) | Next_Index_LPS; state 113 is the fixed 0.5 bin
#define V(qe, lps, mps, sw) ((qe << 16) | (mps << 8) | (sw << 7) | lps)
const long kAritab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),
    V(0x080b, 18, 4, 0),    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),
    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),    V(0x0036, 30, 9, 0),
    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),
    V(0x3f25, 36, 16, 0),   V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),
    V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),   V(0x0cef, 43, 21, 0),
    V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),
    V(0x01b1, 54, 28, 0),   V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),
    V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),   V(0x0068, 62, 33, 0),
    V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),
    V(0x2ef1, 67, 40, 0),   V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),
    V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),   V(0x1177, 73, 45, 0),
    V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),
    V(0x04de, 50, 52, 0),   V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),
    V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),   V(0x01f8, 54, 57, 0),
    V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),
    V(0x008f, 61, 32, 0),   V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),
    V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),   V(0x2fe8, 83, 69, 0),
    V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),
    V(0x119c, 74, 76, 0),   V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),
    V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),   V(0x5832, 80, 81, 1),
    V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),
    V(0x2516, 86, 71, 0),   V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),
    V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),   V(0x3824, 99, 93, 0),
    V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),
    V(0x3c3d, 104, 100, 0), V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0),
    V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0), V(0x415e, 103, 99, 0),
    V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1),
    V(0x5522, 112, 109, 0), V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V

// jdarith.c arith_decode: the C register holds the interval's base and the
// bits read ahead, CT the bits left of them (-16 before the first two
// bytes).  Past a marker (the fake EOI at the end of the file too) the
// decoder reads zero bytes, as arithmetic coding allows.
struct ArithDec {
  Stream s;
  long c = 0, a = 0;
  int ct = -16;
  // jdarith.c process_restart's reset of the decoder
  void reset() {
    c = a = 0;
    ct = -16;
  }
  int byte() {
    if (s.unread) return 0;
    const int v = s.at(s.pos++);
    if (v != 0xFF) return v;
    int m = s.at(s.pos++);
    while (m == 0xFF) m = s.at(s.pos++);  // fill bytes
    if (m == 0) return 0xFF;
    s.unread = m;
    return 0;
  }
  int decode(unsigned char* st) {
    while (a < 0x8000L) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000L;  // the first two bytes are in
      }
      a <<= 1;
    }
    int sv = *st;
    long qe = kAritab[sv & 0x7F];
    const unsigned char nl = qe & 0xFF;
    qe >>= 8;
    const unsigned char nm = qe & 0xFF;
    qe >>= 8;
    long temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = (unsigned char)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (unsigned char)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000L) {
      if (a < qe) {
        *st = (unsigned char)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (unsigned char)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r + (int)(~0u << s) + 1 : r;
}

struct JComp {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;    // downsampled size (jdinput.c initial_setup)
  int wib = 0, hib = 0;  // the component's own blocks (samples if lossless)
  int bw = 0, bh = 0;    // blocks stored (the padded MCU grid)
  int td = 0, ta = 0;    // entropy tables of the current scan
  int pt = 0;            // lossless: the point transform of its scan
  bool latched = false;
  int q[64] = {0};       // latched quantization table, natural order
  int coef_bits[64];
  // the precision before the last scan of this component that touched
  // coefficients 1-9 (libjpeg-turbo's second half of coef_bits)
  int prev_bits[64];
  std::vector<short> coef;
  std::vector<unsigned short> samp;  // lossless: dw x dh samples mod 2^16
};

enum { kGray, kYCbCr, kRGB, kCMYK, kYCCK };

struct JpegFrame {
  const unsigned char* d = nullptr;
  long n = 0;
  int H = 0, W = 0, ncomp = 0, prec = 8;
  int kind = -1;  // 0 baseline, 1 extended, 2 progressive, 3 lossless
  bool arith = false;
  int max_h = 1, max_v = 1, mcux = 0, mcuy = 0;
  int color = kGray;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  long exif_off = -1, exif_len = 0;
  int restart = 0;
  int qt[4][64];
  bool qdef[4] = {false, false, false, false};
  HuffDec dc[4], ac[4];
  // arithmetic conditioning of the 16 table slots (jdmarker.c get_soi)
  int dac_l[16], dac_u[16], dac_k[16];
  JpegFrame() {
    for (int t = 0; t < 16; ++t) {
      dac_l[t] = 0;
      dac_u[t] = 1;
      dac_k[t] = 5;
    }
  }
  JComp comp[4];
  bool started = false;  // a SOS was read
  int scans = 0;         // SOS markers read (input_scan_number)
  bool multi = false;    // has_multiple_scans: the image is read whole first
  bool gray_out = false;  // decoding for IMREAD_GRAYSCALE
  int last_good = 0;     // last_good_iMCU_row
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
    case 0xC5: return "hierarchical JPEG (SOF5)";
    case 0xC6: return "hierarchical progressive JPEG (SOF6)";
    case 0xC7: return "hierarchical lossless JPEG (SOF7)";
    case 0xC8: return "JPEG extension frame (JPG)";
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
  f.prec = p[0];
  f.H = be16(p + 1);
  f.W = be16(p + 3);
  f.ncomp = p[5];
  const bool lossless = m == 0xC3;
  if (lossless && (f.prec < 2 || f.prec > 8))
    jfail(std::to_string(f.prec) + "-bit lossless JPEG (precision " +
          std::to_string(f.prec) + ") is not supported (2 to 8 bits)");
  if (!lossless && f.prec != 8)
    jfail(std::to_string(f.prec) + "-bit JPEG (precision " +
          std::to_string(f.prec) + ") is not supported (8-bit only)");
  if (f.ncomp < 1 || f.ncomp > 4)
    jfail("JPEG of " + std::to_string(f.ncomp) +
          " components is not supported (1, 3 or 4)");
  if (len != 6 + 3 * f.ncomp) jfail("bad JPEG frame header length");
  if (f.H == 0) jfail("JPEG height 0 (set by a DNL marker) is not supported");
  if (f.W == 0) jfail("JPEG width 0 is not valid");
  if (f.H > 65500 || f.W > 65500) jfail("JPEG larger than 65500 pixels");
  f.kind = lossless ? 3 : ((m & 3) == 0 ? 0 : (m & 3));
  f.arith = m == 0xC9 || m == 0xCA;
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
  const int bs = lossless ? 1 : 8;  // a lossless "block" is one sample
  f.mcux = (f.W + bs * f.max_h - 1) / (bs * f.max_h);
  f.mcuy = (f.H + bs * f.max_v - 1) / (bs * f.max_v);
  for (int c = 0; c < f.ncomp; ++c) {
    JComp& k = f.comp[c];
    k.dw = (int)(((long)f.W * k.h + f.max_h - 1) / f.max_h);
    k.dh = (int)(((long)f.H * k.v + f.max_v - 1) / f.max_v);
    k.wib = (k.dw + bs - 1) / bs;
    k.hib = (k.dh + bs - 1) / bs;
    k.bw = f.mcux * k.h;
    k.bh = f.mcuy * k.v;
    for (int i = 0; i < 64; ++i) k.coef_bits[i] = k.prev_bits[i] = -1;
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
    HuffDec& t = (tc ? f.ac : f.dc)[th];
    t.set(p + k + 1, p + k + 17);
    t.dht = true;
    k += 17 + count;
  }
}

// jdmarker.c get_dac
void read_dac(JpegFrame& f, const unsigned char* p, int len) {
  if (len % 2) jfail("bad JPEG DAC marker");
  for (int k = 0; k < len; k += 2) {
    const int index = p[k], val = p[k + 1];
    if (index >= 32) jfail("bad JPEG DAC marker");
    if (index >= 16) {
      f.dac_k[index - 16] = val;
    } else {
      f.dac_l[index] = val & 15;
      f.dac_u[index] = val >> 4;
      if (f.dac_l[index] > f.dac_u[index]) jfail("bad JPEG DAC marker");
    }
  }
}

// the colour space as jdapimin.c default_decompress_parms picks it
void pick_color(JpegFrame& f) {
  if (f.ncomp == 1) {
    f.color = kGray;
  } else if (f.ncomp == 4) {
    f.color = f.adobe && f.adobe_transform != 0 ? kYCCK : kCMYK;
  } else if (f.jfif) {
    f.color = kYCbCr;
  } else if (f.adobe) {
    f.color = f.adobe_transform == 0 ? kRGB : kYCbCr;
  } else {
    const int a = f.comp[0].id, b = f.comp[1].id, c = f.comp[2].id;
    if (a == 82 && b == 71 && c == 66)  // 'R', 'G', 'B'
      f.color = kRGB;
    else  // ids 1, 2, 3 or unknown: JFIF's YCbCr, or RGB if lossless
      f.color = f.kind == 3 ? kRGB : kYCbCr;
  }
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
  last_dc = (int)((unsigned)s + (unsigned)last_dc);
  blk[0] = (short)last_dc;
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

// jdphuff.c / jdarith.c start_pass: a progressive scan's parameters
// checked, the coefficients' precision recorded
void progressive_pass(JpegFrame& f, const Scan& sc) {
  const bool dc_scan = sc.ss == 0;
  bool bad = dc_scan ? sc.se != 0 : (sc.ss > sc.se || sc.se > 63 || sc.ns != 1);
  if (sc.ah != 0 && sc.al != sc.ah - 1) bad = true;
  if (sc.al > 13) bad = true;
  if (bad) jfail("bad progressive JPEG scan parameters");
  for (int i = 0; i < sc.ns; ++i) {
    JComp& k = f.comp[sc.ci[i]];
    for (int c = std::min(sc.ss, 1); c <= std::max(sc.se, 9); ++c)
      k.prev_bits[c] = f.scans > 1 ? k.coef_bits[c] : 0;
    for (int c = sc.ss; c <= sc.se; ++c) k.coef_bits[c] = sc.al;
  }
}

// the MCU grid of a scan: (MCUs a row, MCU rows)
void scan_grid(const JpegFrame& f, const Scan& sc, int& mx_n, int& my_n) {
  if (sc.ns == 1) {
    mx_n = f.comp[sc.ci[0]].wib;
    my_n = f.comp[sc.ci[0]].hib;
    return;
  }
  mx_n = f.mcux;
  my_n = f.mcuy;
  int blocks = 0;
  for (int i = 0; i < sc.ns; ++i)
    blocks += f.comp[sc.ci[i]].h * f.comp[sc.ci[i]].v;
  if (blocks > 10) jfail("JPEG MCU of more than 10 blocks");
}

void decode_scan(JpegFrame& f, const Scan& sc, BitReader& br) {
  const bool prog = f.kind == 2;
  const bool dc_scan = sc.ss == 0;
  if (prog) progressive_pass(f, sc);
  for (int i = 0; i < sc.ns; ++i) {
    const JComp& k = f.comp[sc.ci[i]];
    const bool need_dc = !prog || (dc_scan && sc.ah == 0);
    const bool need_ac = !prog || !dc_scan;
    const HuffDec &dc = f.dc[k.td], &ac = f.ac[k.ta];
    if ((need_dc && !(prog ? dc.dht : dc.defined)) ||
        (need_ac && !(prog ? ac.dht : ac.defined)))
      jfail("JPEG scan names a Huffman table that is not defined");
    if (need_dc) f.dc[k.td].build(true);
    if (need_ac) f.ac[k.ta].build(false);
  }
  int mx_n, my_n;
  scan_grid(f, sc, mx_n, my_n);
  int last_dc[4] = {0, 0, 0, 0};
  long eobrun = 0;
  int next_rst = 0, togo = f.restart;
  const int p1 = 1 << sc.al, m1 = -p1;
  const long total = (long)mx_n * my_n;
  // a one-component scan's MCU is a block: its iMCU row is v block rows
  const int row_div = sc.ns == 1 ? f.comp[sc.ci[0]].v : 1;
  for (long m = 0; m < total; ++m) {
    if (f.restart) {
      if (togo == 0) {
        br.restart(next_rst);
        togo = f.restart;
        last_dc[0] = last_dc[1] = last_dc[2] = last_dc[3] = 0;
        eobrun = 0;
      }
      --togo;
    }
    const int mx = (int)(m % mx_n), my = (int)(m / mx_n);
    // out of data: the MCU left as it is, for the rest of the interval
    if (br.insufficient) continue;
    if (f.multi) f.last_good = my / row_div;
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
            last_dc[i] = (int)((unsigned)s + (unsigned)last_dc[i]);
            blk[0] = (short)((unsigned)last_dc[i] << sc.al);
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

// JWRN_ARITH_BAD_CODE: the MCU ends where the code does
struct ArithBad {};
[[noreturn]] void bad_arith() { throw ArithBad{}; }

// jdarith.c: the statistics of a scan and its MCU decoders
struct ArithScan {
  ArithDec ad;
  const JpegFrame& f;
  unsigned char dc_stats[16][64], ac_stats[16][256];
  unsigned char fixed = 113;
  int last_dc[4] = {0, 0, 0, 0}, dc_ctx[4] = {0, 0, 0, 0};
  ArithScan(const JpegFrame& fr, const Stream& s) : ad{s}, f(fr) {}
  // Figures F.19-F.24: a DC difference, with its conditioning
  void dc_diff(int i, int tbl) {
    unsigned char* st = dc_stats[tbl] + dc_ctx[i];
    if (ad.decode(st) == 0) {
      dc_ctx[i] = 0;
      return;
    }
    const int sign = ad.decode(st + 1);
    st += 2 + sign;
    int m = ad.decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;
      while (ad.decode(st)) {
        if ((m <<= 1) == 0x8000) bad_arith();
        st += 1;
      }
    }
    if (m < (int)((1L << f.dac_l[tbl]) >> 1))
      dc_ctx[i] = 0;
    else if (m > (int)((1L << f.dac_u[tbl]) >> 1))
      dc_ctx[i] = 12 + sign * 4;
    else
      dc_ctx[i] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ad.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    last_dc[i] = (last_dc[i] + v) & 0xffff;
  }
  // an AC value's magnitude category and bits (Figures F.23, F.24) after
  // its sign; st at S0 + 3 (k - 1) + 2
  int ac_value(unsigned char* st, int k, int tbl) {
    int m = ad.decode(st);
    if (m != 0) {
      if (ad.decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= f.dac_k[tbl] ? 189 : 217);
        while (ad.decode(st)) {
          if ((m <<= 1) == 0x8000) bad_arith();
          st += 1;
        }
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ad.decode(st)) v |= m;
    return v + 1;
  }
  // decode_mcu's AC part (sequential) and decode_mcu_AC_first
  void ac_first(short* blk, int tbl, int ss, int se, int al, bool seq) {
    for (int k = ss; k <= se; k++) {
      unsigned char* st = ac_stats[tbl] + 3 * (k - 1);
      if (ad.decode(st)) break;  // EOB
      while (ad.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) bad_arith();
      }
      const int sign = ad.decode(&fixed);
      int v = ac_value(st + 2, k, tbl);
      if (sign) v = -v;
      blk[kNatural[k]] =
          seq ? (short)v : (short)(unsigned)((unsigned)v << al);
    }
  }
  // decode_mcu_AC_refine
  void ac_refine(short* blk, int tbl, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -p1;
    int kex = se;
    for (; kex > 0; kex--)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; k++) {
      unsigned char* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex)
        if (ad.decode(st)) break;  // EOB
      for (;;) {
        short* t = blk + kNatural[k];
        if (*t) {
          if (ad.decode(st + 2)) *t = (short)(*t + (*t < 0 ? m1 : p1));
          break;
        }
        if (ad.decode(st + 1)) {
          *t = (short)(ad.decode(&fixed) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) bad_arith();
      }
    }
  }
};

void decode_arith_scan(JpegFrame& f, const Scan& sc, ArithScan& as) {
  const bool prog = f.kind == 2;
  if (prog) progressive_pass(f, sc);
  const bool dc_pass = !prog || (sc.ss == 0 && sc.ah == 0);
  const bool ac_pass = !prog || sc.ss;
  int mx_n, my_n;
  scan_grid(f, sc, mx_n, my_n);
  auto reset_stats = [&]() {
    for (int i = 0; i < sc.ns; ++i) {
      const JComp& k = f.comp[sc.ci[i]];
      if (dc_pass) {
        std::memset(as.dc_stats[k.td], 0, 64);
        as.last_dc[i] = as.dc_ctx[i] = 0;
      }
      if (ac_pass) std::memset(as.ac_stats[k.ta], 0, 256);
    }
  };
  reset_stats();
  int next_rst = 0, togo = f.restart;
  const long total = (long)mx_n * my_n;
  const int row_div = sc.ns == 1 ? f.comp[sc.ci[0]].v : 1;
  bool dead = false;  // a bad code ends the restart interval (ct = -1)
  for (long m = 0; m < total; ++m) {
    if (f.restart) {
      if (togo == 0) {  // jdarith.c process_restart
        read_restart(as.ad.s, next_rst);
        as.ad.reset();
        togo = f.restart;
        reset_stats();
        dead = false;
      }
      --togo;
    }
    const int mx = (int)(m % mx_n), my = (int)(m / mx_n);
    if (f.multi) f.last_good = my / row_div;  // never out of data
    if (dead) continue;
    try {
    for (int i = 0; i < sc.ns; ++i) {
      JComp& k = f.comp[sc.ci[i]];
      const int hb = sc.ns == 1 ? 1 : k.h, vb = sc.ns == 1 ? 1 : k.v;
      for (int by = 0; by < vb; ++by)
        for (int bx = 0; bx < hb; ++bx) {
          const int x = mx * hb + bx, y = my * vb + by;
          short* blk = k.coef.data() + ((size_t)y * k.bw + x) * 64;
          if (!prog) {  // decode_mcu
            as.dc_diff(i, k.td);
            blk[0] = (short)as.last_dc[i];
            as.ac_first(blk, k.ta, 1, 63, 0, true);
          } else if (sc.ss == 0 && sc.ah == 0) {  // decode_mcu_DC_first
            as.dc_diff(i, k.td);
            blk[0] = (short)(unsigned)((unsigned)as.last_dc[i] << sc.al);
          } else if (sc.ss == 0) {  // decode_mcu_DC_refine
            if (as.ad.decode(&as.fixed)) blk[0] = (short)(blk[0] | (1 << sc.al));
          } else if (sc.ah == 0) {
            as.ac_first(blk, k.ta, sc.ss, sc.se, sc.al, false);
          } else {
            as.ac_refine(blk, k.ta, sc.ss, sc.se, sc.al);
          }
        }
    }
    } catch (const ArithBad&) {
      dead = true;
    }
  }
}

// jdlossls.c: one row of samples from its differences; the first row of a
// scan or restart interval from 2^(P - Pt - 1) and its left neighbour,
// the others' first column from the row above and the rest by the
// scan's predictor
void undifference(int psv, bool first, int initial, const int* diff,
                  const unsigned short* prev, unsigned short* out, int width) {
  if (first || psv == 1) {
    int ra = (diff[0] + (first ? initial : prev[0])) & 0xFFFF;
    out[0] = (unsigned short)ra;
    for (int x = 1; x < width; ++x) {
      ra = (diff[x] + ra) & 0xFFFF;
      out[x] = (unsigned short)ra;
    }
    return;
  }
  long rb = prev[0], rc = 0;
  long ra = (diff[0] + rb) & 0xFFFF;
  out[0] = (unsigned short)ra;
  for (int x = 1; x < width; ++x) {
    rc = rb;
    rb = prev[x];
    long p;
    switch (psv) {
      case 2: p = rb; break;
      case 3: p = rc; break;
      case 4: p = ra + rb - rc; break;
      case 5: p = ra + ((rb - rc) >> 1); break;
      case 6: p = rb + ((ra - rc) >> 1); break;
      default: p = (ra + rb) >> 1; break;
    }
    ra = (diff[x] + p) & 0xFFFF;
    out[x] = (unsigned short)ra;
  }
}

// jddiffct.c decompress_data with jdlhuff.c decode_mcus: a lossless scan
// an iMCU row at a time, its MCU rows decoded (restarts between them),
// then its rows undifferenced
void decode_lossless_scan(JpegFrame& f, const Scan& sc, BitReader& br) {
  const int psv = sc.ss, pt = sc.al;
  if (psv < 1 || psv > 7 || sc.se != 0 || sc.ah != 0 || pt >= f.prec)
    jfail("bad lossless JPEG scan parameters");
  for (int i = 0; i < sc.ns; ++i) {
    JComp& k = f.comp[sc.ci[i]];
    if (!f.dc[k.td].dht)
      jfail("JPEG scan names a Huffman table that is not defined");
    f.dc[k.td].build(true, 16);
    k.pt = pt;
  }
  const bool one = sc.ns == 1;
  int mx_n, my_n;
  scan_grid(f, sc, mx_n, my_n);
  if (f.restart && f.restart % mx_n)
    jfail("lossless JPEG restart interval is not a whole number of MCU rows");
  const int rows_a_restart = f.restart / mx_n;
  const int initial = 1 << (f.prec - pt - 1);
  std::vector<int> diff[4];
  int width[4];
  for (int i = 0; i < sc.ns; ++i) {
    const JComp& k = f.comp[sc.ci[i]];
    width[i] = one ? k.dw : mx_n * k.h;
    diff[i].assign((size_t)width[i] * k.v, 0);
  }
  bool first[4] = {true, true, true, true};
  int togo = rows_a_restart, next_rst = 0;
  const int total = f.mcuy;
  for (int r = 0; r < total; ++r) {
    const JComp& k0 = f.comp[sc.ci[0]];
    const int last_rows = k0.hib % k0.v ? k0.hib % k0.v : k0.v;
    const int mcu_rows = one ? (r < total - 1 ? k0.v : last_rows) : 1;
    for (int yo = 0; yo < mcu_rows; ++yo) {
      if (f.restart) {
        if (togo == 0) {
          br.restart(next_rst);
          togo = rows_a_restart;
          first[0] = first[1] = first[2] = first[3] = true;
        }
      }
      if (br.insufficient) {
        // jdlhuff.c decode_mcus out of data: the MCU row's differences
        // zero, every component's predictor back at the first row
        for (int i = 0; i < sc.ns; ++i) {
          const int rows = one ? 1 : f.comp[sc.ci[i]].v;
          const size_t at = (size_t)(one ? yo : 0) * width[i];
          std::fill(diff[i].begin() + at,
                    diff[i].begin() + at + (size_t)rows * width[i], 0);
        }
        first[0] = first[1] = first[2] = first[3] = true;
        if (f.restart) --togo;
        continue;
      }
      for (int mx = 0; mx < mx_n; ++mx)
        for (int i = 0; i < sc.ns; ++i) {
          const JComp& k = f.comp[sc.ci[i]];
          const HuffDec& h = f.dc[k.td];
          const int hb = one ? 1 : k.h, vb = one ? 1 : k.v;
          for (int y = 0; y < vb; ++y)
            for (int x = 0; x < hb; ++x) {
              int s = br.decode(h);
              if (s == 16)
                s = 32768;
              else if (s)
                s = extend(br.get(s), s);
              diff[i][(size_t)(one ? yo : y) * width[i] + mx * hb + x] = s;
            }
        }
      if (f.restart) --togo;
    }
    for (int i = 0; i < sc.ns; ++i) {
      JComp& k = f.comp[sc.ci[i]];
      const int rows = r < total - 1 ? k.v : (k.hib % k.v ? k.hib % k.v : k.v);
      for (int row = 0; row < rows; ++row) {
        const long y = (long)r * k.v + row;
        unsigned short* out = k.samp.data() + y * k.dw;
        undifference(psv, first[i], initial, diff[i].data() + (size_t)row * width[i],
                     y ? out - k.dw : out, out, k.dw);
        first[i] = false;
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
  }
  const unsigned char* t = p + 1 + 2 * sc.ns;
  sc.ss = t[0];
  sc.se = t[1];
  sc.ah = t[2] >> 4;
  sc.al = t[2] & 15;
}

// What libjpeg refuses only once jpeg_start_decompress runs, after
// jpeg_read_header has given cv2 the size (so cv2's size limit comes
// first): two components (no colour conversion), fractional sampling
// ratios in a component the output needs (jdsample.c; a gray read of
// gray or YCbCr needs only Y); and, as a guard for direct callers, more
// pixels than cv2 reads (io/image.py raises its own error before a
// decode).
void check_decodable(const JpegFrame& f) {
  if (f.ncomp == 2)
    jfail("JPEG of 2 components is not supported (no colour conversion "
          "reads it)");
  const bool only_y = f.gray_out && (f.color == kGray || f.color == kYCbCr);
  for (int c = 0; c < (only_y ? 1 : f.ncomp); ++c)
    if (f.max_h % f.comp[c].h || f.max_v % f.comp[c].v)
      jfail("JPEG with fractional sampling ratios is not supported");
  if ((long)f.H * f.W > (1L << 30))
    jfail("JPEG of " + std::to_string(f.W) + " x " + std::to_string(f.H) +
          " pixels is larger than cv2 reads");
}

// A scan's tables at its start (jdinput.c start_input_pass, jdhuff.c
// start_pass): Huffman slots 0-3, each component's quantization table
// latched at its first scan.
void start_scan(JpegFrame& f, const Scan& sc) {
  for (int i = 0; i < sc.ns; ++i) {
    const JComp& k = f.comp[sc.ci[i]];
    // the arithmetic decoder's 16 conditioning slots are read as given
    if (!f.arith && (k.td > 3 || k.ta > 3)) jfail("bad JPEG scan header");
  }
  if (f.kind == 3) return;  // lossless: no quantization
  for (int i = 0; i < sc.ns; ++i) {  // jdinput.c latch_quant_tables
    JComp& k = f.comp[sc.ci[i]];
    if (k.latched) continue;
    if (!f.qdef[k.tq]) jfail("JPEG component without its quantization table");
    std::memcpy(k.q, f.qt[k.tq], sizeof(k.q));
    k.latched = true;
  }
}

// Markers up to the first SOS (header only) or to EOI (decode: every
// scan entropy-decoded into the components' coefficients or samples; a
// file of one scan ends with it).  The stream runs on past the file as
// FF D9 ... (Stream), so a file cut anywhere reads as libjpeg reads it.
void parse(JpegFrame& f, bool decode) {
  if (f.n < 4 || f.d[0] != 0xFF || f.d[1] != 0xD8) jfail("not a JPEG file");
  Stream st{f.d, f.n, 2};
  std_huff(f);
  std::vector<unsigned char> tail;
  for (;;) {
    const int m = st.unread ? st.unread : st.next_marker();
    st.unread = 0;
    if (m == 0xD9) {
      if (!f.started) jfail("JPEG without a scan");
      return;
    }
    if (m == 0xD8) jfail("JPEG with a second SOI marker");
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // no parameters
    const int len = ((st.at(st.pos) << 8) | st.at(st.pos + 1)) - 2;
    st.pos += 2;
    const bool skipped = (m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC;
    if (len < 0) {
      if (!skipped) jfail("bad JPEG marker segment length");
      continue;  // libjpeg skips nothing after a bogus length
    }
    const unsigned char* body = f.d + st.pos;
    const bool whole = st.pos + len <= f.n;
    if (!whole) {  // read on into the fake EOIs, as libjpeg does
      tail.resize(len);
      for (int i = 0; i < len; ++i) tail[i] = (unsigned char)st.at(st.pos + i);
      body = tail.data();
    }
    st.pos += len;
    if (const char* name = sof_name(m))
      jfail(std::string(name) + " is not supported (libjpeg does not decode "
                                "it)");
    switch (m) {
      case 0xC0:
      case 0xC1:
      case 0xC2:
      case 0xC3:
      case 0xC9:
      case 0xCA:
        read_sof(f, m, body, len);
        break;
      case 0xC4:
        read_dht(f, body, len);
        break;
      case 0xCC:
        read_dac(f, body, len);
        break;
      case 0xDB:
        read_dqt(f, body, len);
        break;
      case 0xDD:
        if (len != 2) jfail("bad JPEG DRI marker");
        f.restart = be16(body);
        break;
      case 0xE0:
        if (!f.started && len >= 14 && std::memcmp(body, "JFIF\0", 5) == 0)
          f.jfif = true;
        break;
      case 0xE1:
        if (!f.started && whole && f.exif_off < 0 && len > 6 &&
            std::memcmp(body, "Exif\0\0", 6) == 0) {
          f.exif_off = (long)(body - f.d) + 6;
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
        ++f.scans;
        const bool first = !f.started;
        if (first) {
          pick_color(f);
          f.started = true;
          f.multi = sc.ns < f.ncomp || f.kind == 2;
          if (!decode) return;
          check_decodable(f);
        }
        start_scan(f, sc);
        if (first) {
          for (int c = 0; c < f.ncomp; ++c) {
            JComp& k = f.comp[c];
            if (f.kind == 3)
              k.samp.assign((size_t)k.dw * k.dh, 0);
            else
              k.coef.assign((size_t)k.bw * k.bh * 64, 0);
          }
        }
        if (f.arith) {
          ArithScan as(f, st);
          decode_arith_scan(f, sc, as);
          st = as.ad.s;
        } else {
          BitReader br{st};
          if (f.kind == 3)
            decode_lossless_scan(f, sc, br);
          else
            decode_scan(f, sc, br);
          st = br.s;
        }
        // one scan: the image is whole, and libjpeg reads what follows
        // only in jpeg_finish_decompress, after cv2 has taken it
        if (!f.multi) return;
        break;
      }
      default:
        if (skipped) break;  // APPn, COM, DNL
        // DHP, EXP, JPGn and the reserved codes: libjpeg's
        // JERR_UNKNOWN_MARKER (JPG itself is an unsupported SOF)
        if (m == 0xDE || m == 0xDF)
          jfail("hierarchical JPEG (DHP/EXP) is not supported");
        jfail("JPEG marker " + std::to_string(m) + " is not supported");
    }
  }
}

// the tables of jdcolor.c
struct DecodeTables {
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  long y_tab[3 * 256];
  DecodeTables() {
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

// A component's samples at full size: rows [0, H) of width >= W, stride
// `ostride`, from its plane (dw x dh samples, stride `stride`) as
// jdsample.c upsamples it; `replicate` (lossless frames) never fancy.
void upsample(const JpegFrame& f, const JComp& k, const unsigned char* pl,
              long stride, unsigned char* out, long ostride, bool replicate) {
  const int hf = f.max_h / k.h, vf = f.max_v / k.v;
  const int dw = k.dw, dh = k.dh;
  const bool fancy_h = dw > 2 && !replicate;
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
    } else if (hf == 1 && vf == 2 && !replicate) {  // h1v2_fancy_upsample
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

// an estimate of a coefficient known to Al bits (or not at all) from num
inline int smooth_pred(long num, long q, int al) {
  int pred;
  if (num >= 0) {
    pred = (int)(((q << 7) + num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = (int)(((q << 7) - num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  return pred;
}

// jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1 and later): each of
// a component's blocks with its first nine AC coefficients, where still
// zero and imprecise, estimated from the DC values of the 5 x 5 blocks
// around it (and the DC itself where no AC scan came), then the IDCT.
// Rows and edges as libjpeg walks them, an iMCU row at a time.
void idct_smoothed(const JpegFrame& f, const JComp& k, unsigned char* plane,
                   long stride);

// jidctint.c's islow IDCT as libjpeg-turbo's SIMD version computes it
// (jsimd_idct_islow_sse2 / _avx2, which cv2's build runs on x86-64): one
// block of coefficients, dequantized by q, into 8 rows of out (stride bytes
// apart).  Within an encoder's range it is the C jpeg_idct_islow; beyond
// it, in the coefficients of damaged data, the 16-bit lanes decide: the
// dequantized values, in0 +- in4, in7 + in3 and in5 + in1 wrap at 16 bits,
// each pass's results saturate to 16 bits, the samples to 8 bits around
// CENTERJSAMPLE, and a block whose rows 1-7 are all zero takes the DC path
// (dequantized DC << 2, wrapping) for every column.
inline int wrap16(int x) { return (int)(short)(unsigned short)(x & 0xFFFF); }
inline int sat16(int x) { return std::max(-32768, std::min(32767, x)); }

// one 8-point pass of the SIMD IDCT on 16-bit inputs; the sums before the
// descale, in the order out[0..7] takes them, in 32-bit lanes that wrap as
// paddd's do (the products of 16-bit values and constants are exact)
inline void idct_pass(const int* in, int* sum) {
  typedef unsigned U;
  const int c0298 = 2446, c0390 = 3196, c0541 = 4433, c0765 = 6270,
            c0899 = 7373, c1175 = 9633, c1501 = 12299, c1847 = 15137,
            c1961 = 16069, c2053 = 16819, c2562 = 20995, c3072 = 25172;
  const int z2 = in[2], z3 = in[6];
  const U t2 = (U)(z2 * c0541) + (U)(z3 * (c0541 - c1847));
  const U t3 = (U)(z2 * (c0541 + c0765)) + (U)(z3 * c0541);
  const U t0 = (U)wrap16(in[0] + in[4]) << 13;
  const U t1 = (U)wrap16(in[0] - in[4]) << 13;
  const U t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
  const int o0 = in[7], o1 = in[5], o2 = in[3], o3 = in[1];
  const int z3s = wrap16(o0 + o2), z4s = wrap16(o1 + o3);
  const U zz3 = (U)(z3s * (c1175 - c1961)) + (U)(z4s * c1175);
  const U zz4 = (U)(z3s * c1175) + (U)(z4s * (c1175 - c0390));
  const U u0 = (U)(o0 * (c0298 - c0899)) + (U)(o3 * -c0899) + zz3;
  const U u3 = (U)(o0 * -c0899) + (U)(o3 * (c1501 - c0899)) + zz4;
  const U u1 = (U)(o1 * (c2053 - c2562)) + (U)(o2 * -c2562) + zz4;
  const U u2 = (U)(o1 * -c2562) + (U)(o2 * (c3072 - c2562)) + zz3;
  sum[0] = (int)(t10 + u3);
  sum[7] = (int)(t10 - u3);
  sum[1] = (int)(t11 + u2);
  sum[6] = (int)(t11 - u2);
  sum[2] = (int)(t12 + u1);
  sum[5] = (int)(t12 - u1);
  sum[3] = (int)(t13 + u0);
  sum[4] = (int)(t13 - u0);
}

void idct_islow(const short* in, const int* q, unsigned char* out,
                long stride) {
  int ws[64];  // pass 1's 16-bit results, row-major
  bool ac = false;
  for (int i = 8; i < 64 && !ac; ++i) ac = in[i] != 0;
  if (!ac) {
    for (int c = 0; c < 8; ++c) {
      const int dc = wrap16(wrap16(in[c] * q[c]) * 4);
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = dc;
    }
  } else {
    for (int c = 0; c < 8; ++c) {  // columns
      int col[8], sum[8];
      for (int r = 0; r < 8; ++r) col[r] = wrap16(in[8 * r + c] * q[8 * r + c]);
      idct_pass(col, sum);
      for (int r = 0; r < 8; ++r)
        ws[8 * r + c] = sat16((int)((unsigned)sum[r] + (1u << 10)) >> 11);
    }
  }
  for (int r = 0; r < 8; ++r) {  // rows
    int sum[8];
    idct_pass(ws + 8 * r, sum);
    unsigned char* o = out + r * stride;
    for (int c = 0; c < 8; ++c) {
      const int v = sat16((int)((unsigned)sum[c] + (1u << 17)) >> 18);
      o[c] = (unsigned char)(std::max(-128, std::min(127, v)) + 128);
    }
  }
}

void idct_smoothed(const JpegFrame& f, const JComp& k, unsigned char* plane,
                   long stride) {
  // smoothing_ok's latches: the precision now, and before the last scan
  // (-1 after a single scan) for the iMCU rows that scan did not reach
  int prev[10];
  for (int i = 0; i < 10; ++i) prev[i] = f.scans > 1 ? k.prev_bits[i] : -1;
  const long Q00 = k.q[0], Q01 = k.q[1], Q10 = k.q[8], Q20 = k.q[16],
             Q11 = k.q[9], Q02 = k.q[2], Q03 = k.q[3], Q12 = k.q[10],
             Q21 = k.q[17], Q30 = k.q[24];
  const int total = f.mcuy, last_row = total - 1, v = k.v;
  const int last_col = k.wib - 1;
  auto dc = [&](int row, int col) {
    return (int)k.coef[((size_t)row * k.bw + col) * 64];
  };
  short ws[64];
  for (int r = 0; r < total; ++r) {
    const int* cb = r > f.last_good ? prev : k.coef_bits;
    bool change_dc = true;
    for (int i = 1; i < 10; ++i)
      if (cb[i] != -1) change_dc = false;
    const int block_rows = r < last_row ? v : (k.hib % v ? k.hib % v : v);
    const int image_block_rows = block_rows * total;
    for (int br = 0; br < block_rows; ++br) {
      const int ibr = r * block_rows + br, cur = r * v + br;
      const int pv = ibr > 0 ? cur - 1 : cur;
      const int pp = ibr > 1 ? cur - 2 : pv;
      const int nx = ibr < image_block_rows - 1 ? cur + 1 : cur;
      const int nn = ibr < image_block_rows - 2 ? cur + 2 : nx;
      int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10, DC11,
          DC12, DC13, DC14, DC15, DC16, DC17, DC18, DC19, DC20, DC21, DC22,
          DC23, DC24, DC25;
      DC01 = DC02 = DC03 = DC04 = DC05 = dc(pp, 0);
      DC06 = DC07 = DC08 = DC09 = DC10 = dc(pv, 0);
      DC11 = DC12 = DC13 = DC14 = DC15 = dc(cur, 0);
      DC16 = DC17 = DC18 = DC19 = DC20 = dc(nx, 0);
      DC21 = DC22 = DC23 = DC24 = DC25 = dc(nn, 0);
      for (int b = 0; b <= last_col; ++b) {
        std::memcpy(ws, k.coef.data() + ((size_t)cur * k.bw + b) * 64,
                    sizeof(ws));
        if (b == 0 && b < last_col) {
          DC04 = DC05 = dc(pp, 1);
          DC09 = DC10 = dc(pv, 1);
          DC14 = DC15 = dc(cur, 1);
          DC19 = DC20 = dc(nx, 1);
          DC24 = DC25 = dc(nn, 1);
        }
        if (b + 1 < last_col) {
          DC05 = dc(pp, b + 2);
          DC10 = dc(pv, b + 2);
          DC15 = dc(cur, b + 2);
          DC20 = dc(nx, b + 2);
          DC25 = dc(nn, b + 2);
        }
        int al;
        if ((al = cb[1]) != 0 && ws[1] == 0) {  // AC01
          const long num = Q00 * (change_dc
              ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                 13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 +
                 3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 -
                 DC21 - DC22 + DC24 + DC25)
              : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
          ws[1] = (short)smooth_pred(num, Q01, al);
        }
        if ((al = cb[2]) != 0 && ws[8] == 0) {  // AC10
          const long num = Q00 * (change_dc
              ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                 13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
                 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
              : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
          ws[8] = (short)smooth_pred(num, Q10, al);
        }
        if ((al = cb[3]) != 0 && ws[16] == 0) {  // AC20
          const long num = Q00 * (change_dc
              ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                 14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 +
                 DC23)
              : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
          ws[16] = (short)smooth_pred(num, Q20, al);
        }
        if ((al = cb[4]) != 0 && ws[9] == 0) {  // AC11
          const long num = Q00 * (change_dc
              ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 +
                 DC21 - DC25)
              : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
                 DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09));
          ws[9] = (short)smooth_pred(num, Q11, al);
        }
        if ((al = cb[5]) != 0 && ws[2] == 0) {  // AC02
          const long num = Q00 * (change_dc
              ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                 14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
                 2 * DC19)
              : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
          ws[2] = (short)smooth_pred(num, Q02, al);
        }
        if (change_dc) {
          if ((al = cb[6]) != 0 && ws[3] == 0) {  // AC03
            const long num =
                Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
            ws[3] = (short)smooth_pred(num, Q03, al);
          }
          if ((al = cb[7]) != 0 && ws[10] == 0) {  // AC12
            const long num =
                Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
            ws[10] = (short)smooth_pred(num, Q12, al);
          }
          if ((al = cb[8]) != 0 && ws[17] == 0) {  // AC21
            const long num =
                Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
            ws[17] = (short)smooth_pred(num, Q21, al);
          }
          if ((al = cb[9]) != 0 && ws[24] == 0) {  // AC30
            const long num =
                Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
            ws[24] = (short)smooth_pred(num, Q30, al);
          }
          // the DC from the 5 x 5 DC values (its precision is known)
          const long num = Q00 *
              (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
               6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
               8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 -
               6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
               2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
          ws[0] = (short)smooth_pred(num, Q00, 0);
        }
        idct_islow(ws, k.q, plane + (size_t)cur * 8 * stride + b * 8,
                   stride);
        DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
        DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
        DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
        DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
        DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
      }
    }
  }
}

// cv2's CMYK (libjpeg's raw, Adobe-inverted samples) to its B, G, R
inline int cmyk_channel(int x, int k) { return k - (((255 - x) * k) >> 8); }

void decode_image(const DecodeTables& T, JpegFrame& f, bool gray,
                  unsigned char* out) {
  f.gray_out = gray;
  parse(f, true);
  // the output space cv2 asks for, and what jdcolor.c converts into it
  const bool four = f.ncomp == 4;
  if (f.kind == 3) {  // lossless: no colour conversion but RGB -> BGR
    const bool ok = four ? f.color == kCMYK
                         : (gray ? f.color == kGray : f.color == kRGB);
    if (!ok)
      jfail("lossless JPEG with " + std::to_string(f.ncomp) +
            (f.ncomp == 1 ? " component" : " components") + " has no " +
            (gray ? "gray" : "colour") +
            " output in libjpeg (it converts nothing in lossless mode)");
  }
  const int H = f.H, W = f.W;
  const bool only_y = gray && (f.color == kGray || f.color == kYCbCr);
  const int nc = only_y ? 1 : f.ncomp;
  const bool smooth = would_smooth(f);
  std::vector<unsigned char> full[4];
  long fstride[4];
  for (int c = 0; c < nc; ++c) {
    const JComp& k = f.comp[c];
    std::vector<unsigned char> plane;
    long stride;
    if (f.kind == 3) {  // jdlossls.c simple_upscale / noscale into 8 bits
      stride = k.dw;
      plane.resize((size_t)k.dw * k.dh);
      for (size_t i = 0; i < plane.size(); ++i)
        plane[i] = (unsigned char)(k.samp[i] << k.pt);
    } else {
      stride = (long)k.bw * 8;
      plane.resize((size_t)stride * k.hib * 8);
      if (smooth) {
        idct_smoothed(f, k, plane.data(), stride);
      } else {
        for (int by = 0; by < k.hib; ++by)
          for (int bx = 0; bx < k.wib; ++bx)
            idct_islow(k.coef.data() + ((size_t)by * k.bw + bx) * 64, k.q,
                       plane.data() + (size_t)by * 8 * stride + bx * 8, stride);
      }
    }
    const int hf = f.max_h / k.h, vf = f.max_v / k.v;
    if (hf == 1 && vf == 1) {
      full[c].swap(plane);
      fstride[c] = stride;
    } else {
      fstride[c] = (long)k.dw * hf;
      full[c].assign((size_t)fstride[c] * H, 0);
      upsample(f, k, plane.data(), stride, full[c].data(), fstride[c],
               f.kind == 3);
    }
  }
  for (int y = 0; y < H; ++y) {
    const unsigned char* a = full[0].data() + (long)y * fstride[0];
    if (four) {  // CMYK or YCCK to cv2's BGR or gray
      const unsigned char* p1 = full[1].data() + (long)y * fstride[1];
      const unsigned char* p2 = full[2].data() + (long)y * fstride[2];
      const unsigned char* p3 = full[3].data() + (long)y * fstride[3];
      for (int x = 0; x < W; ++x) {
        int c = a[x], m = p1[x], yy = p2[x];
        const int k = p3[x];
        if (f.color == kYCCK) {  // ycck_cmyk_convert
          const int l = a[x], cb = p1[x], cr = p2[x];
          c = clamp255(255 - (l + T.cr_r[cr]));
          m = clamp255(255 - (l + (int)((T.cb_g[cb] + T.cr_g[cr]) >> 16)));
          yy = clamp255(255 - (l + T.cb_b[cb]));
        }
        c = cmyk_channel(c, k);
        m = cmyk_channel(m, k);
        yy = cmyk_channel(yy, k);
        if (gray)
          out[(long)y * W + x] =
              (unsigned char)((yy * 1868 + m * 9617 + c * 4899 + 8192) >> 14);
        else {
          unsigned char* o = out + ((long)y * W + x) * 3;
          o[0] = (unsigned char)yy;
          o[1] = (unsigned char)m;
          o[2] = (unsigned char)c;
        }
      }
      continue;
    }
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
    if (f.color == kRGB) {  // rgb_rgb_convert into BGR
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
// H, W, components, format (0 baseline, 1 extended sequential, 2
// progressive, 3 lossless, 4 arithmetic-coded sequential, 5
// arithmetic-coded progressive), colour space (0 gray, 1 YCbCr, 2 RGB, 3
// CMYK, 4 YCCK), the offset and length of the first APP1 Exif payload
// after "Exif\0\0" (-1, 0 if none), then (h, v) sampling of each
// component.  Returns 0, or -1 with a message in err (errlen bytes) for a
// file it does not read.
int lvba_jpeg_info(const unsigned char* data, long n, long* info, char* err,
                   int errlen) {
  try {
    JpegFrame f;
    f.d = data;
    f.n = n;
    parse(f, false);
    long v[16] = {f.H,     f.W,        f.ncomp,   f.kind + (f.arith ? 3 : 0),
                  f.color, f.exif_off, f.exif_len};
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

// Decode a JPEG into out: (H, W) uint8 gray (gray != 0, cv2's
// IMREAD_GRAYSCALE: Y, or cv2's gray of CMYK) or (H, W, 3) BGR (cv2's
// IMREAD_COLOR), with H and W as lvba_jpeg_info gives them.  Returns 0,
// or -1 with a message in err.
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
