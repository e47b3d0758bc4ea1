// Dual-slot feather blend of the video hot loop, for Hopper (sm_90a).
//
// Replaces the TPU kernel K4 of
// stitchingvideo_tpu/ops/pallas/composite_feather.py:
//   _fkernel (:354), behind composite_feather_planar (:456) and
//   compose_mode='feather'.
// The batch B is a parameter: B = 1 is composite_feather_planar; B > 1 is the
// micro-batch, which the reference maps frame set by frame set.
//
// What it computes, per panorama pixel p, frame set b and channel c. A pixel
// has two slots (its tile's lowest and highest camera); a live slot s has a
// tap origin (x0, y0), a camera, integer weights a/ay and a float weight gw:
//   S_s = a*ay*v00 + (127-a)*ay*v01 + a*(127-ay)*v10 + (127-a)*(127-ay)*v11
//         over the slot's int8 (value-128) taps, exact in int32;
//   v_s = f32(S_s) * f32(1/16129);
//   acc = v_0*gw_0, then acc + v_1*gw_1 where slot 1 is live;
//   out = clamp(rint(acc + 128*(gw_0 + gw_1)), 0, 255) as uint8.
// The TPU kernel forms S_s as int8 matmuls of an 80x256 source window (DMA'd
// from one of five band-shifted frame copies) against per-tile, per-slot hat
// matrices; the taps and weights stored per pixel (ops/composite_feather.py)
// are those matrices' non-zeros in global frame coordinates, with the band
// offset folded into x0, so this kernel reads the frames as they are. A slot
// that is not live for a pixel (tap_cw = -1, gw = 0) is skipped: the
// reference multiplies a finite value by 0 there, and adds slot 1 only on
// tiles with two cameras, where a dead slot 1 adds 0.
//
// A pixel of a fallback tile (slot 0's tap_cw = -2; its tap_xy is then the
// index j into the fb_* arrays, [F, 2] each) takes the reference's exact
// float dual gather instead (_fb_blend_values, :429-453, which the reference
// runs in XLA after its kernel): per slot the int8 taps interpolated in
// float32 with weights (1-fx)*(1-fy) etc., summed left to right, 128 added
// AFTERWARDS, times gw; slot 0 + slot 1. (The mat2 fallback adds 128 first.)
//
// Bit-exactness: every float operation is __fsub_rn / __fmul_rn / __fadd_rn /
// rintf (round half to even), and the library is built with -fmad=false.
//
// Bound on the card: memory bytes. It reads, B times, the 32-byte sectors of
// the frame set that the live slots' taps touch, once the state (tap_cw of
// both slots of every pixel; tap_xy and gw of a live slot; the fb_* entry of
// a fallback pixel), and writes B*3*Hp*Wp uint8.
// Design: one thread per output pixel reads its state once and loops over b
// and the 3 channels, so the state is read once a launch; see the note at the
// kernel on registers. The fallback path is out of line and holds nothing
// across its loops, to keep it off the other pixels' register budget.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFallback = -2;

__device__ __forceinline__ uint8_t to_u8(float r) {
  return (uint8_t)fminf(fmaxf(rintf(r), 0.0f), 255.0f);
}

// One slot of one fallback-tile pixel: clamped taps and float weights.
struct FloatTaps {
  int cam;                 // < 0: the slot is inactive
  int o00, o01, o10, o11;  // offsets into a channel plane
  float w00, w01, w10, w11, gw;
};

__device__ __forceinline__ FloatTaps float_taps(int cam, float sx, float sy,
                                                float gw, int H, int W) {
  FloatTaps t;
  t.cam = cam;
  t.gw = gw;
  const float x0f = floorf(sx), y0f = floorf(sy);
  const float fx = __fsub_rn(sx, x0f), fy = __fsub_rn(sy, y0f);
  const int x0 = min(max((int)x0f, 0), W - 1);
  const int y0 = min(max((int)y0f, 0), H - 1);
  const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
  const float ax = __fsub_rn(1.0f, fx), ay = __fsub_rn(1.0f, fy);
  t.w00 = __fmul_rn(ax, ay);
  t.w01 = __fmul_rn(fx, ay);
  t.w10 = __fmul_rn(ax, fy);
  t.w11 = __fmul_rn(fx, fy);
  t.o00 = y0 * W + x0;
  t.o01 = y0 * W + x1;
  t.o10 = y1 * W + x0;
  t.o11 = y1 * W + x1;
  return t;
}

// The exact float dual gather of one fallback-tile pixel, every frame set.
// Out of line, and it works its taps out again for every frame set and
// channel instead of holding both slots' in registers: these are a few
// thousand pixels, and a callee's registers count against every thread.
__device__ __noinline__ void fallback_pixel(
    const int8_t* __restrict__ frames, int j,
    const int32_t* __restrict__ fb_cam, const float* __restrict__ fb_sx,
    const float* __restrict__ fb_sy, const float* __restrict__ fb_gw,
    uint8_t* __restrict__ out, long long p, int B, int N, int H, int W,
    long long npix) {
  const long long plane = (long long)H * W;
#pragma unroll 1
  for (int bc = 0; bc < B * 3; ++bc) {
    const int b = bc / 3, c = bc % 3;
    // an inactive slot is (v8 + 128) * 0 = +0 in the reference
    float acc = 0.0f;
#pragma unroll 1
    for (int k = 2 * j; k < 2 * j + 2; ++k) {
      const int cam = fb_cam[k];
      if (cam < 0) continue;
      const FloatTaps t = float_taps(cam, fb_sx[k], fb_sy[k], fb_gw[k], H, W);
      const int8_t* src = frames + (((long long)b * N + cam) * 3 + c) * plane;
      float v = __fmul_rn(t.w00, (float)src[t.o00]);
      v = __fadd_rn(v, __fmul_rn(t.w01, (float)src[t.o01]));
      v = __fadd_rn(v, __fmul_rn(t.w10, (float)src[t.o10]));
      v = __fadd_rn(v, __fmul_rn(t.w11, (float)src[t.o11]));
      acc = __fadd_rn(acc, __fmul_rn(__fadd_rn(v, 128.0f), t.gw));
    }
    out[bc * npix + p] = to_u8(acc);
  }
}

// One live slot of one pixel: tap offsets, integer weights, float weight.
struct IntTaps {
  int cam;
  int o00, o01, o10, o11;  // offsets into a channel plane
  int w00, w01, w10, w11;
  float gw;
};

__device__ __forceinline__ IntTaps int_taps(int cw, const int32_t* tap_xy,
                                            const float* gw, long long p,
                                            int H, int W) {
  IntTaps t;
  t.cam = cw >> 16;
  t.gw = gw[p];
  const int a = (cw >> 8) & 0xff, ay = cw & 0xff;
  const int xy = tap_xy[p];
  const int x0 = xy & 0xffff, y0 = xy >> 16;
  // a tap on the window's last row/column has weight 0 on its second tap
  // (the build guarantees it): clamp the index, never read past the frame
  const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
  t.w00 = a * ay;
  t.w01 = (127 - a) * ay;
  t.w10 = a * (127 - ay);
  t.w11 = (127 - a) * (127 - ay);
  t.o00 = y0 * W + x0;
  t.o01 = y0 * W + x1;
  t.o10 = y1 * W + x0;
  t.o11 = y1 * W + x1;
  return t;
}

// v_s * gw_s of one slot, from the slot's channel plane.
__device__ __forceinline__ float slot_value(const IntTaps& t,
                                            const int8_t* src) {
  const float kInv = (float)(1.0 / 16129.0);   // f32(1 / 127^2)
  const int sum = t.w00 * src[t.o00] + t.w01 * src[t.o01] +
                  t.w10 * src[t.o10] + t.w11 * src[t.o11];
  return __fmul_rn(__fmul_rn(__int2float_rn(sum), kInv), t.gw);
}

// Registers decide this kernel's speed: it waits on gathers, so it needs
// many threads in flight. With both slots in one loop nest over (b, c) the
// compiler hoisted 24 tap addresses and took 127 registers: 0.47 ms at B=1
// and 3.63 ms at B=16 on the H100 at product size. Split by what is live,
// the one-slot pixels (90% of the rig's) run the seam-select loop and the
// two-slot pixels a flat loop that is not unrolled; with the launch bounds
// holding it to at most 42 registers: 0.15 ms and 1.17 ms (PERF.md,
// chip_smoke.py).
__global__ void __launch_bounds__(256, 6)
composite_feather_kernel(const int8_t* __restrict__ frames,
                         const int32_t* __restrict__ tap_xy,
                         const int32_t* __restrict__ tap_cw,
                         const float* __restrict__ gw,
                         const int32_t* __restrict__ fb_cam,
                         const float* __restrict__ fb_sx,
                         const float* __restrict__ fb_sy,
                         const float* __restrict__ fb_gw,
                         uint8_t* __restrict__ out,
                         int B, int N, int H, int W, long long npix) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  const int cw0 = tap_cw[p];
  if (cw0 == kFallback) {
    fallback_pixel(frames, tap_xy[p], fb_cam, fb_sx, fb_sy, fb_gw, out, p, B,
                   N, H, W, npix);
    return;
  }
  // slot s of the per-slot planes lies at s * npix
  const int cw1 = tap_cw[npix + p];
  if (cw0 < 0 && cw1 < 0) {
    for (int bc = 0; bc < B * 3; ++bc) out[bc * npix + p] = 0;
    return;
  }
  const long long plane = (long long)H * W;
  if (cw0 < 0 || cw1 < 0) {
    // one live slot; the other's weight is 0
    const IntTaps t = cw0 >= 0 ? int_taps(cw0, tap_xy, gw, p, H, W)
                               : int_taps(cw1, tap_xy + npix, gw + npix, p,
                                          H, W);
    const float restore = __fmul_rn(128.0f, __fadd_rn(t.gw, 0.0f));
    for (int b = 0; b < B; ++b) {
      const int8_t* src = frames + ((long long)b * N + t.cam) * 3 * plane;
      for (int c = 0; c < 3; ++c, src += plane) {
        const float acc = __fadd_rn(0.0f, slot_value(t, src));
        out[((long long)b * 3 + c) * npix + p] =
            to_u8(__fadd_rn(acc, restore));
      }
    }
    return;
  }
  const IntTaps t0 = int_taps(cw0, tap_xy, gw, p, H, W);
  const IntTaps t1 = int_taps(cw1, tap_xy + npix, gw + npix, p, H, W);
  const float restore = __fmul_rn(128.0f, __fadd_rn(t0.gw, t1.gw));
  const long long to_cam1 = (long long)(t1.cam - t0.cam) * 3 * plane;
#pragma unroll 1
  for (int bc = 0; bc < B * 3; ++bc) {
    const int b = bc / 3, c = bc - 3 * b;
    const int8_t* src =
        frames + (((long long)b * N + t0.cam) * 3 + c) * plane;
    const float acc = __fadd_rn(__fadd_rn(0.0f, slot_value(t0, src)),
                                slot_value(t1, src + to_cam1));
    out[bc * npix + p] = to_u8(__fadd_rn(acc, restore));
  }
}

}  // namespace

extern "C" int composite_feather_launch(
    const void* frames, const void* tap_xy, const void* tap_cw,
    const void* gw, const void* fb_cam, const void* fb_sx, const void* fb_sy,
    const void* fb_gw, void* out, int B, int N, int H, int W, long long npix,
    void* stream) {
  if (npix <= 0 || B <= 0) return 0;
  const int threads = 256;
  const long long blocks = (npix + threads - 1) / threads;
  composite_feather_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
      (const int8_t*)frames, (const int32_t*)tap_xy, (const int32_t*)tap_cw,
      (const float*)gw, (const int32_t*)fb_cam, (const float*)fb_sx,
      (const float*)fb_sy, (const float*)fb_gw, (uint8_t*)out, B, N, H, W,
      npix);
  return (int)cudaGetLastError();
}

extern "C" const char* composite_feather_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
