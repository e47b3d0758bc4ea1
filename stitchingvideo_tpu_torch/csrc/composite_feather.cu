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
// a fallback pixel) and the staging table, and writes B*3*Hp*Wp uint8.
// Design: the staged gather of staging.cuh, as K1/K2's. A block of 32x32
// pixels stages the boxes of both cameras its pixels tap (the staging table
// of ops/staging.py) into shared memory with 16-byte cp.async, a frame set
// a stage in a ring of two, and gathers every live slot's taps there; a
// thread owns 4 pixels of a row, 8 apart, reads their state once and stores
// 4 adjacent pixels as a 32-bit word a plane. Blocks whose boxes do not fit
// take a direct gather from device memory, out of line; so does the
// fallback path, which holds nothing across its loops, to keep it off the
// other pixels' register budget.
#include <cstdint>
#include <cuda_runtime.h>

#include "staging.cuh"

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

// One pixel of a block of the direct-gather branch, its taps from device
// memory: the one-thread-a-pixel kernel that served every block before the
// staged one. Registers decided its speed: with both slots in one loop nest
// over (b, c) the compiler hoisted 24 tap addresses and took 127 registers
// (0.47 ms at B=1 on the H100 at product size); split by what is live,
// one-slot pixels run the seam-select loop and two-slot pixels a flat loop
// that is not unrolled (PERF.md).
__device__ __forceinline__ void direct_pixel(
    const int8_t* __restrict__ frames, const int32_t* __restrict__ tap_xy,
    const int32_t* __restrict__ tap_cw, const float* __restrict__ gw,
    const int32_t* __restrict__ fb_cam, const float* __restrict__ fb_sx,
    const float* __restrict__ fb_sy, const float* __restrict__ fb_gw,
    uint8_t* __restrict__ out, long long p, int B, int N, int H, int W,
    long long npix) {
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

// A block of the direct-gather branch. Out of line: these are few blocks,
// and their code stays off the staged path's registers.
__device__ __noinline__ void direct_block(
    const int8_t* __restrict__ frames, const int32_t* __restrict__ tap_xy,
    const int32_t* __restrict__ tap_cw, const float* __restrict__ gw,
    const int32_t* __restrict__ fb_cam, const float* __restrict__ fb_sx,
    const float* __restrict__ fb_sy, const float* __restrict__ fb_gw,
    uint8_t* __restrict__ out, long long p, int n, int B, int N, int H, int W,
    long long npix) {
  for (int k = 0; k < n; ++k)
    direct_pixel(frames, tap_xy, tap_cw, gw, fb_cam, fb_sx, fb_sy, fb_gw,
                 out, p + k * staged::kLanes, B, N, H, W, npix);
}

// One live slot in a stage: the offsets of its taps (o00 | o10 << 16), its
// weights (staged::tap_weights) and gw; a slot that is not live is all 0.
struct StagedSlot {
  unsigned o, w;
  float gw;
};
__device__ __forceinline__ StagedSlot staged_slot(int cw, int xy, float gw,
                                                  const staged::Box& b0,
                                                  const staged::Box& b1,
                                                  int H) {
  if (cw < 0) return StagedSlot{0u, 0u, 0.0f};
  const int2 o = staged::tap_offsets(cw >> 16, xy & 0xffff, xy >> 16, b0, b1,
                                     H);
  return StagedSlot{(unsigned)o.x | (unsigned)o.y << 16,
                    staged::tap_weights(cw), gw};
}
// v * gw of a slot: f32(S) * f32(1/16129) * gw, each product rounded
__device__ __forceinline__ float staged_value(unsigned st, unsigned o,
                                              unsigned w, float gw) {
  const float kInv = (float)(1.0 / 16129.0);   // f32(1 / 127^2)
  const int sum = staged::tap_sum(st, o & 0xffff, o >> 16, w);
  return __fmul_rn(__fmul_rn(__int2float_rn(sum), kInv), gw);
}

// frame sets in the ring of K4's stages: one in flight while one is
// computed (with the second slots, a third would cost a block of the SM's
// six on the product rig)
constexpr int kSets = 2;
// dynamic shared memory of a K4 block: the stages, then the second slots
// (3 words of 4 pixels a thread)
constexpr int feather_shared(int stage_bytes) {
  return kSets * 3 * stage_bytes + 3 * 4 * staged::kPix * staged::kThreads;
}
static_assert(staged::fits_sm(feather_shared(staged::kBudget + 16)),
              "the staging budget must leave room for the launch bounds");

// K4: the staged composite. Per thread, for its 4 pixels, held in
// registers over the B*3 planes: the first live slot (slot 0 if live, else
// slot 1) and the restore term 128 * (gw0 + gw1). The second slot of a
// pixel with both live (10.5% of the product rig's pixels) waits in shared
// memory, read a word at a time by a thread that has such a pixel. Per
// plane and pixel:
//   acc = 0 + v_first * gw_first; acc = acc + v_second * gw_second;
//   out = clamp(rint(acc + restore)),
// which is the kernel's order: a slot that is not live has weight 0 and adds
// a zero, which leaves acc as it is. A fallback pixel gets all-zero slots
// and is overwritten by the exact float dual gather after the planes.
__global__ void __launch_bounds__(staged::kThreads, staged::kBlocksPerSM)
composite_feather_kernel(const int8_t* __restrict__ frames,
                         const int32_t* __restrict__ tap_xy,
                         const int32_t* __restrict__ tap_cw,
                         const float* __restrict__ gw,
                         const int32_t* __restrict__ fb_cam,
                         const float* __restrict__ fb_sx,
                         const float* __restrict__ fb_sy,
                         const float* __restrict__ fb_gw,
                         const int32_t* __restrict__ table,
                         uint8_t* __restrict__ out, int B, int N, int H,
                         int W, int Hp, int Wp, int stage_bytes) {
  using staged::kPix;
  extern __shared__ __align__(16) uint8_t smem[];
  const staged::Pixels px = staged::thread_pixels(Hp, Wp);
  const long long npix = (long long)Hp * Wp;
  const int4* slots = reinterpret_cast<const int4*>(table) + 2 * blockIdx.x;
  const staged::Box b0 = staged::box_of(slots[0]);
  const staged::Box b1 = staged::box_of(slots[1]);
  if (b0.cam == staged::kDirect) {
    direct_block(frames, tap_xy, tap_cw, gw, fb_cam, fb_sx, fb_sy, fb_gw, out,
                 px.p, px.n, B, N, H, W, npix);
    return;
  }
  const int nplanes = 3 * B;
  const long long HW = (long long)H * W;
  const staged::Copies cp = staged::block_copies(b0, b1, H, W);

  // the pixels' state
  int cw0[kPix], cw1[kPix], xy0[kPix], xy1[kPix];
  float gw0[kPix], gw1[kPix];
  staged::load_pixels(tap_cw, px, -1, cw0);
  staged::load_pixels(tap_cw + npix, px, -1, cw1);
  staged::load_pixels(tap_xy, px, 0, xy0);
  staged::load_pixels(tap_xy + npix, px, 0, xy1);
  staged::load_pixels(gw, px, 0.0f, gw0);
  staged::load_pixels(gw + npix, px, 0.0f, gw1);
  StagedSlot first[kPix];
  float restore[kPix];
  bool fallback = false, two = false;
  // the second slots in shared memory, word k of a thread's pixel k at
  // k * kThreads + threadIdx.x (offsets, weights, gw)
  unsigned* sec_o = reinterpret_cast<unsigned*>(smem + kSets * 3 *
                                                stage_bytes);
  unsigned* sec_w = sec_o + kPix * staged::kThreads;
  float* sec_g = reinterpret_cast<float*>(sec_w + kPix * staged::kThreads);
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    fallback |= cw0[k] == kFallback;
    const bool both = cw0[k] >= 0 && cw1[k] >= 0;
    two |= both;
    first[k] = cw0[k] >= 0 ? staged_slot(cw0[k], xy0[k], gw0[k], b0, b1, H)
                           : staged_slot(cw1[k], xy1[k], gw1[k], b0, b1, H);
    const StagedSlot second = both ? staged_slot(cw1[k], xy1[k], gw1[k], b0,
                                                 b1, H)
                                   : StagedSlot{0u, 0u, 0.0f};
    const int at = k * staged::kThreads + threadIdx.x;
    sec_o[at] = second.o;
    sec_w[at] = second.w;
    sec_g[at] = second.gw;
    restore[k] = __fmul_rn(128.0f, __fadd_rn(gw0[k], gw1[k]));
  }

  if (cp.n == 0) {
    // no live slot in the block: nothing to stage
    for (int i = 0; i < nplanes; ++i)
      staged::store_plane(out + i * npix, px, 0u);
  } else {
    staged::run_sets<kSets>(smem, stage_bytes, cp, frames, B, N, HW,
                            [&](unsigned st, int b) {
      uint8_t* dst = out + 3 * b * npix;
#pragma unroll
      for (int c = 0; c < 3; ++c, st += stage_bytes, dst += npix) {
        float acc[kPix];
#pragma unroll
        for (int k = 0; k < kPix; ++k)
          acc[k] = __fadd_rn(0.0f, staged_value(st, first[k].o, first[k].w,
                                                first[k].gw));
        if (two) {
#pragma unroll
          for (int k = 0; k < kPix; ++k) {
            const int at = k * staged::kThreads + threadIdx.x;
            acc[k] = __fadd_rn(acc[k], staged_value(st, sec_o[at], sec_w[at],
                                                    sec_g[at]));
          }
        }
        int q[kPix];
#pragma unroll
        for (int k = 0; k < kPix; ++k)
          q[k] = staged::rounded(__fadd_rn(acc[k], restore[k]));
        staged::store_plane(dst, px, staged::pack4(q[0], q[1], q[2], q[3]));
      }
    });
  }
  // store_plane wrote this thread's pixels' zeros from other lanes of its
  // warp: order those stores before the exact values that overwrite them
  __syncwarp();
  if (fallback)
    for (int k = 0; k < px.n; ++k) {
      const long long p = px.p + k * staged::kLanes;
      if (tap_cw[p] == kFallback)
        fallback_pixel(frames, tap_xy[p], fb_cam, fb_sx, fb_sy, fb_gw, out, p,
                       B, N, H, W, npix);
    }
}

}  // namespace

extern "C" int composite_feather_launch(
    const void* frames, const void* tap_xy, const void* tap_cw,
    const void* gw, const void* fb_cam, const void* fb_sx, const void* fb_sy,
    const void* fb_gw, const void* table, void* out, int B, int N, int H,
    int W, int Hp, int Wp, int stage_bytes, void* stream) {
  using namespace staged;
  if (Hp <= 0 || Wp <= 0 || B <= 0) return 0;
  if (stage_bytes < 16 || stage_bytes % 16 || stage_bytes > kBudget + 16)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)((Hp + kBlockH - 1) / kBlockH) *
                           ((Wp + kBlockW - 1) / kBlockW);
  const int smem = feather_shared(stage_bytes);
  const int e = shared_above_default(composite_feather_kernel, smem);
  if (e) return e;
  composite_feather_kernel<<<(unsigned)blocks, kThreads, smem,
                             (cudaStream_t)stream>>>(
      (const int8_t*)frames, (const int32_t*)tap_xy, (const int32_t*)tap_cw,
      (const float*)gw, (const int32_t*)fb_cam, (const float*)fb_sx,
      (const float*)fb_sy, (const float*)fb_gw, (const int32_t*)table,
      (uint8_t*)out, B, N, H, W, Hp, Wp, stage_bytes);
  return (int)cudaGetLastError();
}

// Blocks of K4 that an SM holds at once with stages of `stage_bytes`, into
// *blocks: a CUDA error, or 0.
extern "C" int composite_feather_blocks_per_sm(int stage_bytes, int* blocks) {
  const int smem = feather_shared(stage_bytes);
  const int e = staged::shared_above_default(composite_feather_kernel, smem);
  if (e) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, composite_feather_kernel, staged::kThreads, smem);
}

extern "C" const char* composite_feather_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
