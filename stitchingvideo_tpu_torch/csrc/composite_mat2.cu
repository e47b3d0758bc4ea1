// Seam-select composite of the video hot loop ("mat2"), for Hopper (sm_90a).
//
// Replaces the TPU kernels of stitchingvideo_tpu/ops/pallas/composite_mat2.py:
//   K1  _make_kernel_tile_batched (:624), the micro-batched kernel, and
//   K2  _make_kernel (:388), the single-frame-set kernel.
// One kernel with the batch B as a parameter serves both (B = 1 for K2).
// The file also holds K5, the single-class kernel of composite_mat.py, which
// is the same integer path without the fallback branch, and the pieces
// variant of K1/K2, the multiband warp stage, which is the same pixel
// function stored as bfloat16 windows (both below).
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
// a covered one; a fallback pixel's fb_* entry instead) and the staging
// table, and writes B*3*Hp*Wp uint8; it does about 12 integer and float
// operations a byte of output. chip_smoke.py's mat2_needs counts these bytes
// for a given LUT.
// Design (staged_kernel, one body for K1/K2, K5 and the pieces kernel): a
// gather with one thread a pixel issues a memory request for each of its 4
// one-byte taps and its store, and is bound by those requests and their
// latency, not by bytes. So a block of 32x32 pixels stages the source boxes
// its pixels tap into shared memory with 16-byte cp.async, a frame set (3
// planes) a stage in a ring of three (staging.cuh, the table from
// ops/staging.py), and gathers the taps there; a thread owns 4 pixels of a
// row, 8 apart, so that a warp's shared loads fall into few words, and
// stores 4 adjacent pixels as one word a plane after a transpose across its
// row's lanes: 32 bits of uint8 into the panorama (K1/K2, K5), 64 bits of
// bfloat16 into the window stack (pieces). Blocks whose boxes do not fit a
// stage take a direct gather from device memory (the per-pixel code, out
// of line).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "staging.cuh"

namespace {

constexpr int kUncovered = -1;
constexpr int kFallback = -2;

// round half to even, clamp to 0..255
__device__ __forceinline__ float quantize(float r) {
  return fminf(fmaxf(rintf(r), 0.0f), 255.0f);
}

// Where one pixel's value of frame set b and channel c goes. The pixel
// functions below are templated on one of these.
// The panorama, [B, 3, npix] uint8:
struct PanoU8 {
  uint8_t* __restrict__ out;   // already at pixel p
  long long npix;
  __device__ __forceinline__ void operator()(int b, int c, float r) const {
    out[((long long)b * 3 + c) * npix] = (uint8_t)quantize(r);
  }
};
// The window stack, [B, pieces, 3, win] bfloat16 (0..255 are exact in it):
struct WindowsBf16 {
  __nv_bfloat16* __restrict__ out;   // already at (piece, channel 0, pixel)
  long long win;                     // pixels of one window
  int planes;                        // pieces * 3, the planes of a frame set
  __device__ __forceinline__ void operator()(int b, int c, float r) const {
    out[((long long)b * planes + c) * win] = __float2bfloat16_rn(quantize(r));
  }
};

// An uncovered pixel: 0 in every frame set and channel.
template <class Store>
__device__ __forceinline__ void zero_pixel(Store store, int B) {
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < 3; ++c) store(b, c, 0.0f);
}

// The exact float gather of one fallback-tile pixel, for every frame set.
// Not inlined: inlined, it slowed the integer path of every other pixel by
// 15-21% on the H100 at the product size (same 40 registers); out of line
// the kernel is within 3-7% of one without a fallback path (PERF.md).
template <class Store>
__device__ __noinline__ void fallback_pixel(
    const int8_t* __restrict__ frames, int j,
    const int32_t* __restrict__ fb_cam, const float* __restrict__ fb_sx,
    const float* __restrict__ fb_sy, const float* __restrict__ fb_gain,
    Store store, int B, int N, int H, int W) {
  const int cam = fb_cam[j];
  if (cam < 0) {
    zero_pixel(store, B);
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
      store(b, c, __fmul_rn(v, gain));
    }
  }
}

// The integer path of one covered pixel, for every frame set: the 4 taps
// with their integer weights, the float tail, the store: the direct-gather
// blocks of every instantiation of the staged kernel below.
template <class Store>
__device__ __forceinline__ void integer_pixel(
    const int8_t* __restrict__ frames, int cw, int xy, float g, Store store,
    int B, int N, int H, int W) {
  const float kInv = (float)(1.0 / 16129.0);   // f32(1 / 127^2)
  const int cam = cw >> 16;
  const int a = (cw >> 8) & 0xff;
  const int ay = cw & 0xff;
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
  for (int b = 0; b < B; ++b) {
    const int8_t* src = frames + ((long long)b * N + cam) * 3 * plane;
    for (int c = 0; c < 3; ++c, src += plane) {
      const int s = w00 * src[o00] + w01 * src[o01] + w10 * src[o10] +
                    w11 * src[o11];
      const float v = __fmul_rn(__int2float_rn(s), kInv);
      store(b, c, __fmul_rn(__fadd_rn(v, 128.0f), g));
    }
  }
}

// Pixel p of a state: uncovered, fallback or integer path. Without a
// fallback path (K5's state) every negative tap_cw is an uncovered pixel.
template <bool kFallbackPath, class Store>
__device__ __forceinline__ void state_pixel(
    const int8_t* __restrict__ frames, const int32_t* __restrict__ tap_xy,
    const int32_t* __restrict__ tap_cw, const float* __restrict__ gc,
    const int32_t* __restrict__ fb_cam, const float* __restrict__ fb_sx,
    const float* __restrict__ fb_sy, const float* __restrict__ fb_gain,
    long long p, Store store, int B, int N, int H, int W) {
  const int cw = tap_cw[p];
  if (kFallbackPath ? cw == kUncovered : cw < 0) {
    zero_pixel(store, B);
    return;
  }
  if (kFallbackPath && cw == kFallback) {
    fallback_pixel(frames, tap_xy[p], fb_cam, fb_sx, fb_sy, fb_gain, store, B,
                   N, H, W);
    return;
  }
  integer_pixel(frames, cw, tap_xy[p], gc[p], store, B, N, H, W);
}

// The outputs of the staged kernel. Each gives the output index of a
// thread's first pixel (`at`; `source` maps it back to the panorama index),
// the planes of frame set b (`set`, channel 0; channel c at c * `chan`
// further) that store_plane writes at that index, and the store of one
// pixel at its output index (`pixel`) for the per-pixel paths.
// The panorama, [B, 3, Hp*Wp] uint8 (K1/K2, K5):
struct PanoOut {
  uint8_t* __restrict__ out;
  long long chan;                    // Hp * Wp
  __device__ __forceinline__ long long at(const staged::Pixels& px) const {
    return px.p;
  }
  __device__ __forceinline__ long long source(long long q) const { return q; }
  __device__ __forceinline__ uint8_t* set(int b) const {
    return out + 3 * b * chan;
  }
  __device__ __forceinline__ PanoU8 pixel(long long q) const {
    return PanoU8{out + q, chan};
  }
};
// The window stack, [B, pieces, 3, Hb*Wb] bfloat16, whose panorama is the
// pieces' windows stacked along rows ([pieces*Hb, Wb]): a row of the
// panorama lies in window k = row / Hb, and its pixel p at output index
// k * 3 * win + p - k * win = p + 2 * k * win of the plane.
struct WindowOut {
  __nv_bfloat16* __restrict__ out;
  long long chan;                    // win = Hb * Wb
  long long set_stride;              // pieces * 3 * win, a frame set
  int pieces, Hb;
  __device__ __forceinline__ long long at(const staged::Pixels& px) const {
    return px.p + 2 * min(px.y / Hb, pieces - 1) * chan;
  }
  // q lies in [3 * k * win, 3 * k * win + win) for the window k of its pixel
  __device__ __forceinline__ long long source(long long q) const {
    return q - 2 * (q / (3 * chan)) * chan;
  }
  __device__ __forceinline__ __nv_bfloat16* set(int b) const {
    return out + b * set_stride;
  }
  __device__ __forceinline__ WindowsBf16 pixel(long long q) const {
    return WindowsBf16{out + q, chan, pieces * 3};
  }
};

// A block of the direct-gather branch: each thread's pixels one by one,
// their taps from device memory. Out of line, as the fallback path: these
// are few blocks, and their code stays off the staged path's registers.
template <bool kFallbackPath, class Out>
__device__ __noinline__ void direct_block(
    const int8_t* __restrict__ frames, const int32_t* __restrict__ tap_xy,
    const int32_t* __restrict__ tap_cw, const float* __restrict__ gc,
    const int32_t* __restrict__ fb_cam, const float* __restrict__ fb_sx,
    const float* __restrict__ fb_sy, const float* __restrict__ fb_gain,
    Out out, const staged::Pixels px, int B, int N, int H, int W) {
  const long long q = out.at(px);
  for (int k = 0; k < px.n; ++k)
    state_pixel<kFallbackPath>(frames, tap_xy, tap_cw, gc, fb_cam, fb_sx,
                               fb_sy, fb_gain, px.p + k * staged::kLanes,
                               out.pixel(q + k * staged::kLanes), B, N, H, W);
}

// frame sets in the ring of a block's stages: two in flight while one is
// computed
constexpr int kSets = 3;
// dynamic shared memory of a block
constexpr int mat2_shared(int stage_bytes) { return kSets * 3 * stage_bytes; }
static_assert(staged::fits_sm(mat2_shared(staged::kBudget + 16)),
              "the staging budget must leave room for the launch bounds");

// The staged composite (staging.cuh) into `Out`, with or without the
// fallback path. Per thread, for its 4 pixels: the offsets of their taps in
// a stage, their four weights in one word and their gain, held in registers
// over the B*3 planes; per plane 16 one-byte shared-memory loads, the float
// tail, and one word stored. An uncovered or fallback pixel gets weights 0
// and gain 0 (value (0 + 128) * 0 = 0); a fallback pixel is then
// overwritten by the exact float gather after the planes.
//   K1/K2:  staged_kernel<PanoOut, true>
//   K5:     staged_kernel<PanoOut, false>
//   pieces: staged_kernel<WindowOut, true>
template <class Out, bool kFallbackPath>
__global__ void __launch_bounds__(staged::kThreads, staged::kBlocksPerSM)
staged_kernel(const int8_t* __restrict__ frames,
              const int32_t* __restrict__ tap_xy,
              const int32_t* __restrict__ tap_cw,
              const float* __restrict__ gc,
              const int32_t* __restrict__ fb_cam,
              const float* __restrict__ fb_sx,
              const float* __restrict__ fb_sy,
              const float* __restrict__ fb_gain,
              const int32_t* __restrict__ table, Out out, int B, int N,
              int H, int W, int Hp, int Wp, int stage_bytes) {
  using namespace staged;
  extern __shared__ __align__(16) uint8_t smem[];
  const float kInv = (float)(1.0 / 16129.0);   // f32(1 / 127^2)
  Pixels px = thread_pixels(Hp, Wp);
  const int4* slots = reinterpret_cast<const int4*>(table) + 2 * blockIdx.x;
  const Box b0 = box_of(slots[0]), b1 = box_of(slots[1]);
  if (b0.cam == kDirect) {
    direct_block<kFallbackPath>(frames, tap_xy, tap_cw, gc, fb_cam, fb_sx,
                                fb_sy, fb_gain, out, px, B, N, H, W);
    return;
  }
  const long long HW = (long long)H * W;
  const Copies cp = block_copies(b0, b1, H, W);

  // the pixels' state: tap_xy and gc of kernel pixels only (a third of the
  // window stack is uncovered)
  int cw[kPix], xy[kPix];
  float gk[kPix];
  load_pixels(tap_cw, px, -1, cw);
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    xy[k] = cw[k] >= 0 ? tap_xy[px.p + k * kLanes] : 0;
    gk[k] = cw[k] >= 0 ? gc[px.p + k * kLanes] : 0.0f;
  }
  int o00[kPix], o10[kPix];
  unsigned w[kPix];
  float g[kPix];
  bool fallback = false;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    fallback |= kFallbackPath && cw[k] == kFallback;
    const bool kern = cw[k] >= 0;
    const int2 o = kern ? tap_offsets(cw[k] >> 16, xy[k] & 0xffff,
                                      xy[k] >> 16, b0, b1, H)
                        : make_int2(0, 0);
    o00[k] = o.x;
    o10[k] = o.y;
    w[k] = kern ? tap_weights(cw[k]) : 0u;
    g[k] = kern ? gk[k] : 0.0f;
  }
  // from here px.p is the output index of the thread's first pixel
  px.p = out.at(px);

  if (cp.n == 0) {
    // no kernel pixel in the block: nothing to stage, zeros to store (a
    // word of zeros is its own transpose)
    for (int b = 0; b < B; ++b) {
      auto* dst = out.set(b);
      for (int c = 0; c < 3; ++c, dst += out.chan) put_word(dst, px, 0u);
    }
  } else {
    run_sets<kSets>(smem, stage_bytes, cp, frames, B, N, HW,
                    [&](unsigned st, int b) {
      auto* dst = out.set(b);
#pragma unroll
      for (int c = 0; c < 3; ++c, st += stage_bytes, dst += out.chan) {
        int q[kPix];
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          const int sum = tap_sum(st, o00[k], o10[k], w[k]);
          const float v = __fmul_rn(__int2float_rn(sum), kInv);
          q[k] = rounded(__fmul_rn(__fadd_rn(v, 128.0f), g[k]));
        }
        store_plane(dst, px, pack4(q[0], q[1], q[2], q[3]));
      }
    });
  }
  if (kFallbackPath) {
    // store_plane wrote this thread's pixels' zeros from other lanes of its
    // warp: order those stores before the exact values that overwrite them
    __syncwarp();
    if (fallback) {
      const long long p0 = out.source(px.p);
      for (int k = 0; k < px.n; ++k) {
        const long long p = p0 + k * kLanes;
        if (tap_cw[p] == kFallback)
          fallback_pixel(frames, tap_xy[p], fb_cam, fb_sx, fb_sy, fb_gain,
                         out.pixel(px.p + k * kLanes), B, N, H, W);
      }
    }
  }
}

// K1/K2 are staged_kernel<PanoOut, true>, above.
//
// The pieces variant of K1/K2, the warp stage of the multiband video mode
// (stitchingvideo_tpu/ops/pallas/composite_mat2.py:
// composite_mat2_planar_pieces (:986) and composite_mat2_planar_pieces_batched
// (:1029), the quantize=True / out_dtype=bf16 path of
// _make_kernel_tile_batched, :752-763), is staged_kernel<WindowOut, true>.
// The state is a mat2 state over the window stack: `pieces` windows of Hb x
// Wb pixels, one camera a window, the seam mask folded into the coverage,
// with its staging table over the stack. Pixel p of the stack is pixel
// p % win of window p / win; its value, quantised to 0..255 as the
// panorama's would be, is stored as bfloat16 into [B, pieces, 3, win], so
// that each window's three planes lie together for the pyramids that
// follow. A block may span two windows: each thread's pixels lie in one row,
// and so in one window. The reference drops tile groups without a covered
// pixel from its grid over a zero-filled output; here every thread writes,
// an uncovered block its zeros without staging anything (about a third of
// the stack at the product size), where a zero-fill pass would write the
// same bytes a second time.
// Bound on the card: memory bytes, as mat2, with 2 bytes a value written;
// on the H100 the staged kernel is held by that traffic (818 MB written of
// its 1.15 GB at B=8), not by its instructions (PERF.md).
//
// K5, the single-class materialized kernel ("mat",
// stitchingvideo_tpu/ops/pallas/composite_mat.py: _kernel (:150), behind
// composite_mat_planar (:248) and kernel='mat'), is staged_kernel<PanoOut,
// false>: mat2's integer path on a state built window by window as the
// reference's _materialize builds it (ops/composite_mat.py), with its own
// staging table. The TPU kernel forms S as a bf16 matmul (exact on int8
// values) of an 80x384 source window, sliced to its 256-wide band, against
// per-tile hat matrices, for both camera slots of the tile, and keeps the
// pixel's own slot (sel; the other slot's finite value is multiplied by 0).
// It has no fallback path, as in the reference: the wrapper refuses a LUT
// with fallback tiles, and every negative tap_cw is an uncovered pixel
// (gc = 0 in the reference), written 0. B > 1 is the micro-batch, which the
// reference maps frame set by frame set.

// Launch staged_kernel<Out, kFallbackPath> over the blocks of an Hp x Wp
// panorama: a CUDA error, or 0.
template <class Out, bool kFallbackPath>
int launch_staged(const void* frames, const void* tap_xy, const void* tap_cw,
                  const void* gc, const void* fb_cam, const void* fb_sx,
                  const void* fb_sy, const void* fb_gain, const void* table,
                  Out out, int B, int N, int H, int W, int Hp, int Wp,
                  int stage_bytes, void* stream) {
  using namespace staged;
  if (Hp <= 0 || Wp <= 0 || B <= 0) return 0;
  if (stage_bytes < 16 || stage_bytes % 16 || stage_bytes > kBudget + 16)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)((Hp + kBlockH - 1) / kBlockH) *
                           ((Wp + kBlockW - 1) / kBlockW);
  const int smem = mat2_shared(stage_bytes);
  auto* kernel = staged_kernel<Out, kFallbackPath>;
  const int e = shared_above_default(kernel, smem);
  if (e) return e;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)frames, (const int32_t*)tap_xy, (const int32_t*)tap_cw,
      (const float*)gc, (const int32_t*)fb_cam, (const float*)fb_sx,
      (const float*)fb_sy, (const float*)fb_gain, (const int32_t*)table, out,
      B, N, H, W, Hp, Wp, stage_bytes);
  return (int)cudaGetLastError();
}

// Blocks of staged_kernel<Out, kFallbackPath> that an SM holds at once with
// stages of `stage_bytes`, into *blocks: a CUDA error, or 0.
template <class Out, bool kFallbackPath>
int staged_blocks_per_sm(int stage_bytes, int* blocks) {
  const int smem = mat2_shared(stage_bytes);
  auto* kernel = staged_kernel<Out, kFallbackPath>;
  const int e = staged::shared_above_default(kernel, smem);
  if (e) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, staged::kThreads, smem);
}

}  // namespace

extern "C" int composite_mat2_launch(const void* frames, const void* tap_xy,
                                     const void* tap_cw, const void* gc,
                                     const void* fb_cam, const void* fb_sx,
                                     const void* fb_sy, const void* fb_gain,
                                     const void* table, void* out, int B,
                                     int N, int H, int W, int Hp, int Wp,
                                     int stage_bytes, void* stream) {
  return launch_staged<PanoOut, true>(
      frames, tap_xy, tap_cw, gc, fb_cam, fb_sx, fb_sy, fb_gain, table,
      PanoOut{(uint8_t*)out, (long long)Hp * Wp}, B, N, H, W, Hp, Wp,
      stage_bytes, stream);
}

extern "C" int composite_mat2_blocks_per_sm(int stage_bytes, int* blocks) {
  return staged_blocks_per_sm<PanoOut, true>(stage_bytes, blocks);
}

// The window stack: pieces windows of Hb x Wb, its panorama pieces*Hb x Wb.
extern "C" int composite_mat2_pieces_launch(
    const void* frames, const void* tap_xy, const void* tap_cw,
    const void* gc, const void* fb_cam, const void* fb_sx, const void* fb_sy,
    const void* fb_gain, const void* table, void* out, int B, int N, int H,
    int W, int pieces, int Hb, int Wb, int stage_bytes, void* stream) {
  if (pieces <= 0 || Hb <= 0) return 0;
  return launch_staged<WindowOut, true>(
      frames, tap_xy, tap_cw, gc, fb_cam, fb_sx, fb_sy, fb_gain, table,
      WindowOut{(__nv_bfloat16*)out, (long long)Hb * Wb,
                3LL * pieces * Hb * Wb, pieces, Hb},
      B, N, H, W, pieces * Hb, Wb, stage_bytes, stream);
}

extern "C" int composite_mat2_pieces_blocks_per_sm(int stage_bytes,
                                                   int* blocks) {
  return staged_blocks_per_sm<WindowOut, true>(stage_bytes, blocks);
}

extern "C" int composite_mat_launch(const void* frames, const void* tap_xy,
                                    const void* tap_cw, const void* gc,
                                    const void* table, void* out, int B,
                                    int N, int H, int W, int Hp, int Wp,
                                    int stage_bytes, void* stream) {
  return launch_staged<PanoOut, false>(
      frames, tap_xy, tap_cw, gc, nullptr, nullptr, nullptr, nullptr, table,
      PanoOut{(uint8_t*)out, (long long)Hp * Wp}, B, N, H, W, Hp, Wp,
      stage_bytes, stream);
}

extern "C" int composite_mat_blocks_per_sm(int stage_bytes, int* blocks) {
  return staged_blocks_per_sm<PanoOut, false>(stage_bytes, blocks);
}

extern "C" const char* composite_mat2_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
