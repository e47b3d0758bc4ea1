// On-the-fly seam-select composite ("tiled"), for Hopper (sm_90a).
//
// Replaces the TPU kernel K6 of stitchingvideo_tpu/ops/pallas/composite.py:
//   _kernel (:173), behind composite_tiled_planar (:263), composite_tiled
//   (:248), kernel='tiled', and ops/pallas/remap.py remap_tiled (:17).
//
// What it computes, per panorama pixel with camera cam >= 0, source coords
// (sx, sy) and gain g, and channel c, every step rounded to float32 on its
// own (the library is built with -fmad=false):
//   x0 = floor(sx), y0 = floor(sy);
//   wx0 = bf16(max(0, 1 - |x0 - sx|)),  wx1 = bf16(max(0, 1 - |x0 + 1 - sx|))
//   wy0 =      max(0, 1 - |y0 - sy|),   wy1 =      max(0, 1 - |y0 + 1 - sy|)
//   r0  = v00*wx0 + v01*wx1,  r1 = v10*wx0 + v11*wx1     (uint8 taps as f32)
//   out = clamp(rint((r0*wy0 + r1*wy1) * g), 0, 255) as uint8.
// The TPU kernel builds the hats max(0, 1 - |w - s|) for every column w of a
// 384-wide source window and row of its 80 rows, rounds the x-hats to
// bfloat16, and contracts them against bfloat16 frames on the matrix unit
// with float32 accumulation, then sums the rows against the float32 y-hats.
// All but two hats an axis are exactly 0, the window origin is an integer
// whose subtraction is exact, and the products of a uint8 value and a
// bfloat16 weight are exact in float32, so the four-tap form above gives the
// same float32 values. The hats are evaluated by the reference's expression
// at both taps (wx1 is not fx: they can differ in the last bit). Uncovered
// pixels (cam = -1) are written 0. There is no fallback path, as in the
// reference: the wrapper refuses a LUT with fallback tiles.
//
// It reads the tile-major LUT of the tile build as it is (sx, sy, gain, cidx,
// [T, 1024] each, 16 bytes a pixel) and uint8 planar frames, and writes the
// [Hp, Wp, 3] uint8 panorama the reference returns.
//
// Bound on the card: memory bytes: the 32-byte sectors of the frame set its
// taps touch, 16 LUT bytes a pixel, 3 bytes out; about 25 float operations a
// pixel and channel. Design: one thread per pixel in tile-major order, so
// LUT loads coalesce; the 3-byte stores of neighbouring threads are adjacent.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 8, kTileW = 128, kP = kTileH * kTileW;

__device__ __forceinline__ float hat(float tap, float s) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(tap, s))));
}

__device__ __forceinline__ float to_bf16(float w) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

__global__ void composite_tiled_kernel(const uint8_t* __restrict__ frames,
                                       const float* __restrict__ sx,
                                       const float* __restrict__ sy,
                                       const float* __restrict__ gain,
                                       const int32_t* __restrict__ cidx,
                                       uint8_t* __restrict__ out,
                                       int N, int H, int W, int ntx,
                                       long long n, int Hp, int Wp) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int t = (int)(i / kP), q = (int)(i % kP);
  const int y = (t / ntx) * kTileH + q / kTileW;
  const int x = (t % ntx) * kTileW + q % kTileW;
  if (y >= Hp || x >= Wp) return;          // the tile grid's padding
  uint8_t* o = out + ((long long)y * Wp + x) * 3;
  const int cam = cidx[i];
  if (cam < 0) {
    o[0] = o[1] = o[2] = 0;
    return;
  }
  const float sxv = sx[i], syv = sy[i], g = gain[i];
  const float x0f = floorf(sxv), y0f = floorf(syv);
  const float wx0 = to_bf16(hat(x0f, sxv));
  const float wx1 = to_bf16(hat(__fadd_rn(x0f, 1.0f), sxv));
  const float wy0 = hat(y0f, syv);
  const float wy1 = hat(__fadd_rn(y0f, 1.0f), syv);
  // sx, sy are clipped to the frame, so the tap past its last row/column
  // has weight 0: clamp the index, never read past the frame
  const int x0 = (int)x0f, y0 = (int)y0f;
  const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
  const long long o00 = (long long)y0 * W + x0, o01 = (long long)y0 * W + x1;
  const long long o10 = (long long)y1 * W + x0, o11 = (long long)y1 * W + x1;
  const long long plane = (long long)H * W;
  const uint8_t* src = frames + (long long)cam * 3 * plane;
  for (int c = 0; c < 3; ++c, src += plane) {
    const float r0 = __fadd_rn(__fmul_rn((float)src[o00], wx0),
                               __fmul_rn((float)src[o01], wx1));
    const float r1 = __fadd_rn(__fmul_rn((float)src[o10], wx0),
                               __fmul_rn((float)src[o11], wx1));
    const float v = __fadd_rn(__fmul_rn(r0, wy0), __fmul_rn(r1, wy1));
    o[c] = (uint8_t)fminf(fmaxf(rintf(__fmul_rn(v, g)), 0.0f), 255.0f);
  }
}

}  // namespace

extern "C" int composite_tiled_launch(const void* frames, const void* sx,
                                      const void* sy, const void* gain,
                                      const void* cidx, void* out, int N,
                                      int H, int W, int ntx, int T, int Hp,
                                      int Wp, void* stream) {
  const long long n = (long long)T * kP;
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  composite_tiled_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const float*)sx, (const float*)sy,
      (const float*)gain, (const int32_t*)cidx, (uint8_t*)out, N, H, W, ntx,
      n, Hp, Wp);
  return (int)cudaGetLastError();
}

extern "C" const char* composite_tiled_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
