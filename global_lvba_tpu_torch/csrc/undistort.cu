// Undistortion of every image of an export in one launch: cv2's remap
// (INTER_LINEAR, BORDER_CONSTANT 0) through cv2's CV_16SC2 undistortion
// map, bit for bit.
//
// Replaces no Pallas kernel: the JAX package undistorts on the host with
// cv2 (global_lvba_tpu/pipeline/outputs.py:292 undistort_image).  The map
// is computed once per camera on the host in float64 (kernels/undistort.py
// undistort_map): per output pixel the source pixel (int16 x, y) and a
// 5-bit fraction index, and the table holds cv2's 15-bit bilinear weights
// of each of the 1,024 fractions (their sum exactly 1 << 15).  A thread
// takes one output pixel of one image, reads the 2x2 source pixels (a tap
// outside the image reads 0, as the constant border does), and writes
// (sum w_k s_k + (1 << 14)) >> 15 clamped to 0..255 for each of the three
// channels: cv2's remapBilinear with FixedPtCast, integer arithmetic, so
// the output is bitwise the plain version's (undistort_plain) and
// repeatable.
//
// Grid: blockIdx.y an image, blockIdx.x a run of kThreads pixels of it.
// Bound: bytes.  The images are read once and written once (3 bytes a
// pixel each way), the map (6 bytes a pixel) and the 16 KB table stay in
// L2 across images; a block's pixels are neighbours along a row, so the
// 2x2 taps of a warp fall in a few lines.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lvba_error.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxImagesPerLaunch = 65535;

__global__ void __launch_bounds__(kThreads)
undistort_kernel(const uint8_t* __restrict__ src,
                 const short2* __restrict__ xy,
                 const int16_t* __restrict__ frac,
                 const int4* __restrict__ tab, int n0, int H, int W,
                 uint8_t* __restrict__ dst) {
  const int64_t p = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  const int64_t HW = (int64_t)H * W;
  if (p >= HW) return;
  const int64_t img = n0 + (int64_t)blockIdx.y;
  const short2 s = __ldg(xy + p);
  const int4 w = __ldg(tab + (__ldg(frac + p) & 1023));
  const uint8_t* im = src + img * HW * 3;
  const int x0 = s.x, y0 = s.y;
  const bool in_x0 = x0 >= 0 && x0 < W, in_x1 = x0 + 1 >= 0 && x0 + 1 < W;
  const bool in_y0 = y0 >= 0 && y0 < H, in_y1 = y0 + 1 >= 0 && y0 + 1 < H;
  const uint8_t* r0 = im + ((int64_t)y0 * W + x0) * 3;
  const uint8_t* r1 = r0 + (int64_t)W * 3;
  uint8_t* o = dst + (img * HW + p) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int a = (in_y0 && in_x0) ? r0[c] : 0;
    const int b = (in_y0 && in_x1) ? r0[3 + c] : 0;
    const int d = (in_y1 && in_x0) ? r1[c] : 0;
    const int e = (in_y1 && in_x1) ? r1[3 + c] : 0;
    int v = (a * w.x + b * w.y + d * w.z + e * w.w + (1 << 14)) >> 15;
    o[c] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
  }
}

}  // namespace

// dst (N, H, W, 3) uint8 from src (N, H, W, 3) uint8 through the map xy
// (H, W, 2) int16, frac (H, W) int16 and the weights tab (1024, 4) int32.
extern "C" int lvba_undistort(const uint8_t* src, const int16_t* xy,
                              const int16_t* frac, const int32_t* tab, int N,
                              int H, int W, uint8_t* dst, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t HW = (int64_t)H * W;
  const unsigned bx = static_cast<unsigned>((HW + kThreads - 1) / kThreads);
  for (int n0 = 0; n0 < N; n0 += kMaxImagesPerLaunch) {
    const unsigned by = static_cast<unsigned>(N - n0) < kMaxImagesPerLaunch
                            ? static_cast<unsigned>(N - n0)
                            : kMaxImagesPerLaunch;
    undistort_kernel<<<dim3(bx, by), kThreads, 0, s>>>(
        src, reinterpret_cast<const short2*>(xy), frac,
        reinterpret_cast<const int4*>(tab), n0, H, W, dst);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
