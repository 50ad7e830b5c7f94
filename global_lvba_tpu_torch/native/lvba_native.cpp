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
#include <cstdlib>
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
