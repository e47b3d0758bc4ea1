// Seam-select composite of the video hot loop ("mat2"), for Hopper (sm_90a).
//
// Replaces the TPU kernels of stitchingvideo_tpu/ops/pallas/composite_mat2.py:
//   K1  _make_kernel_tile_batched (:624), the micro-batched kernel, and
//   K2  _make_kernel (:388), the single-frame-set kernel.
// One kernel with the batch B as a parameter serves both (B = 1 for K2).
//
// What it computes, per panorama pixel p and frame set b and channel c:
//   S   = a*ay*v00 + (127-a)*ay*v01 + a*(127-ay)*v10 + (127-a)*(127-ay)*v11
//         over the int8 (value-128) taps at (y0|y0+1, x0|x0+1) of p's camera,
//         exact in int32;
//   v   = f32(S) * f32(1/16129);
//   out = clamp(rint((v + 128) * gc), 0, 255) as uint8.
// The TPU kernel forms the same S as matmuls against hat matrices built per
// 8x128 tile over a source window; the weights a/ay and taps x0/y0 the port's
// build stores per pixel (ops/composite_mat2.py) are those matrices'
// non-zeros, in global frame coordinates. Uncovered pixels (tap_cw = -1)
// are written 0. A pixel of a fallback tile (tap_cw = -2; tap_xy is then
// its index into the fb_* arrays) takes the reference's exact float gather
// instead (_fallback_values, composite_mat2.py:551-573, which the reference
// runs in XLA after its kernels): weights ((1-fx)*(1-fy)) etc. on the +128
// values, summed left to right, times gain, 0 where uncovered.
//
// Bit-exactness: every float operation is __fsub_rn / __fmul_rn / __fadd_rn /
// rintf (round half to even), and the library is built with -fmad=false.
//
// Bound on the card: memory bytes. It reads, B times, the parts of the frame
// set (N*3*H*W int8) that its taps touch (not the outer columns a rig's LUT
// never samples), and once the LUT (tap_cw of every pixel, tap_xy and gc of
// a covered one; a fallback pixel's fb_* entry instead), and writes
// B*3*Hp*Wp uint8; it does about 12 integer and float operations a byte of
// output. chip_smoke.py's mat2_needs counts these bytes for a given LUT.
// Design: deliberately simple, one thread per output pixel, which reads its
// LUT entry once and loops over b and the 3 channels; neighbouring threads
// gather neighbouring source pixels, so the taps' loads mostly coalesce and
// the 2x2 reuse is served by L1/L2. cp.async/TMA staging of source rows and
// wider stores come in later changes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kUncovered = -1;
constexpr int kFallback = -2;

__device__ __forceinline__ uint8_t to_u8(float r) {
  return (uint8_t)fminf(fmaxf(rintf(r), 0.0f), 255.0f);
}

// The exact float gather of one fallback-tile pixel, for every frame set.
// Not inlined: inlined, it slowed the integer path of every other pixel by
// 15-21% on the H100 at the product size (same 40 registers); out of line
// the kernel is within 3-7% of one without a fallback path (PERF.md).
__device__ __noinline__ void fallback_pixel(
    const int8_t* __restrict__ frames, int j,
    const int32_t* __restrict__ fb_cam, const float* __restrict__ fb_sx,
    const float* __restrict__ fb_sy, const float* __restrict__ fb_gain,
    uint8_t* __restrict__ out, long long p, int B, int N, int H, int W,
    long long npix) {
  const int cam = fb_cam[j];
  if (cam < 0) {
    for (int bc = 0; bc < B * 3; ++bc) out[bc * npix + p] = 0;
    return;
  }
  const float sx = fb_sx[j], sy = fb_sy[j], gain = fb_gain[j];
  const float x0f = floorf(sx), y0f = floorf(sy);
  const float fx = __fsub_rn(sx, x0f), fy = __fsub_rn(sy, y0f);
  const int x0 = min(max((int)x0f, 0), W - 1);
  const int y0 = min(max((int)y0f, 0), H - 1);
  const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
  const float ax = __fsub_rn(1.0f, fx), ay = __fsub_rn(1.0f, fy);
  const float w00 = __fmul_rn(ax, ay), w01 = __fmul_rn(fx, ay);
  const float w10 = __fmul_rn(ax, fy), w11 = __fmul_rn(fx, fy);
  const long long o00 = (long long)y0 * W + x0, o01 = (long long)y0 * W + x1;
  const long long o10 = (long long)y1 * W + x0, o11 = (long long)y1 * W + x1;
  const long long plane = (long long)H * W;
  for (int b = 0; b < B; ++b) {
    const int8_t* src = frames + ((long long)b * N + cam) * 3 * plane;
    for (int c = 0; c < 3; ++c, src += plane) {
      float v = __fmul_rn(w00, __fadd_rn((float)src[o00], 128.0f));
      v = __fadd_rn(v, __fmul_rn(w01, __fadd_rn((float)src[o01], 128.0f)));
      v = __fadd_rn(v, __fmul_rn(w10, __fadd_rn((float)src[o10], 128.0f)));
      v = __fadd_rn(v, __fmul_rn(w11, __fadd_rn((float)src[o11], 128.0f)));
      out[((long long)b * 3 + c) * npix + p] = to_u8(__fmul_rn(v, gain));
    }
  }
}

__global__ void composite_mat2_kernel(const int8_t* __restrict__ frames,
                                      const int32_t* __restrict__ tap_xy,
                                      const int32_t* __restrict__ tap_cw,
                                      const float* __restrict__ gc,
                                      const int32_t* __restrict__ fb_cam,
                                      const float* __restrict__ fb_sx,
                                      const float* __restrict__ fb_sy,
                                      const float* __restrict__ fb_gain,
                                      uint8_t* __restrict__ out,
                                      int B, int N, int H, int W,
                                      long long npix) {
  const float kInv = (float)(1.0 / 16129.0);   // f32(1 / 127^2)
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  const int cw = tap_cw[p];
  if (cw == kUncovered) {
    for (int bc = 0; bc < B * 3; ++bc) out[bc * npix + p] = 0;
    return;
  }
  if (cw == kFallback) {
    fallback_pixel(frames, tap_xy[p], fb_cam, fb_sx, fb_sy, fb_gain, out, p,
                   B, N, H, W, npix);
    return;
  }
  const int cam = cw >> 16;
  const int a = (cw >> 8) & 0xff;
  const int ay = cw & 0xff;
  const int xy = tap_xy[p];
  const int x0 = xy & 0xffff;
  const int y0 = xy >> 16;
  // a tap on the frame's last row/column has weight 0 on its second tap
  // (the build guarantees it): clamp the index, never read past the frame
  const int x1 = min(x0 + 1, W - 1);
  const int y1 = min(y0 + 1, H - 1);
  const int w00 = a * ay, w01 = (127 - a) * ay;
  const int w10 = a * (127 - ay), w11 = (127 - a) * (127 - ay);
  const long long o00 = (long long)y0 * W + x0, o01 = (long long)y0 * W + x1;
  const long long o10 = (long long)y1 * W + x0, o11 = (long long)y1 * W + x1;
  const long long plane = (long long)H * W;
  const float g = gc[p];
  for (int b = 0; b < B; ++b) {
    const int8_t* src = frames + ((long long)b * N + cam) * 3 * plane;
    for (int c = 0; c < 3; ++c, src += plane) {
      const int s = w00 * src[o00] + w01 * src[o01] + w10 * src[o10] +
                    w11 * src[o11];
      const float v = __fmul_rn(__int2float_rn(s), kInv);
      out[((long long)b * 3 + c) * npix + p] =
          to_u8(__fmul_rn(__fadd_rn(v, 128.0f), g));
    }
  }
}

}  // namespace

extern "C" int composite_mat2_launch(const void* frames, const void* tap_xy,
                                     const void* tap_cw, const void* gc,
                                     const void* fb_cam, const void* fb_sx,
                                     const void* fb_sy, const void* fb_gain,
                                     void* out, int B, int N, int H, int W,
                                     long long npix, void* stream) {
  if (npix <= 0 || B <= 0) return 0;
  const int threads = 256;
  const long long blocks = (npix + threads - 1) / threads;
  composite_mat2_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const int8_t*)frames, (const int32_t*)tap_xy, (const int32_t*)tap_cw,
      (const float*)gc, (const int32_t*)fb_cam, (const float*)fb_sx,
      (const float*)fb_sy, (const float*)fb_gain, (uint8_t*)out, B, N, H, W,
      npix);
  return (int)cudaGetLastError();
}

extern "C" const char* composite_mat2_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
