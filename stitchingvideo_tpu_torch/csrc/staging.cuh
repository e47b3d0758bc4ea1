// Staged gather of the seam-select (mat2), single-class (mat), multiband
// warp (pieces) and feather kernels, for Hopper (sm_90a): what they share.
//
// A block of kThreads threads owns a square of kBlockH x kBlockW panorama
// pixels; a thread owns kPix pixels of one block row, kLanes apart. Before
// the block computes a plane (frame set b, channel c), it has copied the
// source boxes of its staging table (ops/staging.py: up to two boxes, one
// per camera, each holding every tap of the block's kernel pixels of that
// camera) from device memory into shared memory with 16-byte cp.async, in a
// ring of stages of a frame set each (run_sets), so that the next frame sets
// arrive while the current one is computed.
// The taps are then read from shared memory, and each plane's results are
// stored as words of 4 adjacent pixels: 32 bits of uint8, or 64 bits of
// bfloat16 (the multiband warp stage's windows).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace staged {

constexpr int kBlockH = 32, kBlockW = 32;   // ops/staging.py BLOCK_H/BLOCK_W
constexpr int kPix = 4;                     // pixels a thread
constexpr int kThreads = kBlockH * kBlockW / kPix;
constexpr int kBudget = 4192;               // ops/staging.py STAGE_BUDGET
constexpr int kChunks =                     // 16-byte copies a thread
    (kBudget / 16 + kThreads - 1) / kThreads;
constexpr int kDirect = -2;                 // ops/staging.py DIRECT
constexpr int kBlocksPerSM = 6;             // the kernels' launch bounds

static_assert(kThreads * kPix == kBlockH * kBlockW, "block shape");
static_assert(kBudget % 16 == 0, "budget in whole copies");

// Dynamic shared memory of kBlocksPerSM blocks that each take `bytes`, with
// the 1 KB a block reserves, fits an H100 SM's 228 KB.
constexpr bool fits_sm(int bytes) {
  return kBlocksPerSM * (bytes + 1024) <= 228 * 1024;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One slot of a block's staging table.
struct Box {
  int cam, row0, col0, rows, cols;
};
__device__ __forceinline__ Box box_of(int4 t) {
  return Box{t.x, t.y, t.z, t.w >> 16, t.w & 0xffff};
}

// The pixels of a thread: of its block's row `threadIdx.x / kLanes`, the
// kPix pixels l, l + kLanes, ... (l = threadIdx.x % kLanes), so that the
// lanes of a warp gather the taps of neighbouring pixels in each load (a
// warp's one-byte shared loads then fall into few 32-bit words, one pass of
// the banks). A plane's results are stored as 32-bit words of kPix adjacent
// pixels after a transpose across the row's lanes (store_plane).
constexpr int kLanes = kBlockW / kPix;      // threads of a block row
struct Pixels {
  long long p;   // panorama index of pixel l of the block row
  int y;         // the panorama row of the thread's pixels
  int n;         // of the thread's kPix pixels, how many lie in the panorama
  int nw;        // of the kPix pixels of its word, how many lie in it
  bool vec;      // rows of a multiple of kPix pixels: whole-word stores
};
__device__ __forceinline__ Pixels thread_pixels(int Hp, int Wp) {
  const int nbx = (Wp + kBlockW - 1) / kBlockW;
  const int by = blockIdx.x / nbx, bx = blockIdx.x - by * nbx;
  const int y = by * kBlockH + threadIdx.x / kLanes;
  const int l = threadIdx.x % kLanes;
  const int left = Wp - bx * kBlockW;       // columns of the block row
  Pixels px;
  px.p = (long long)y * Wp + bx * kBlockW + l;
  px.y = y;
  px.n = y < Hp ? max(0, min(kPix, (left - l + kLanes - 1) / kLanes)) : 0;
  px.nw = y < Hp ? max(0, min(kPix, left - kPix * l)) : 0;
  px.vec = Wp % kPix == 0;
  return px;
}

// The values of array `a` at the thread's pixels; `fill` off the panorama.
template <class T>
__device__ __forceinline__ void load_pixels(const T* __restrict__ a,
                                            const Pixels& px, T fill,
                                            T (&v)[kPix]) {
#pragma unroll
  for (int k = 0; k < kPix; ++k)
    v[k] = k < px.n ? a[px.p + k * kLanes] : fill;
}

// The word of kPix adjacent uint8 results that this lane stores, from the
// words of its row's lanes (byte k of `mine` is pixel l + k * kLanes): lane
// l takes byte l / 2 of the words of lanes 4 * (l % 2) + m of its row,
// m = 0..3, which are pixels 4 * l + m. Every lane of the warp takes part in
// the shuffles.
__device__ __forceinline__ unsigned row_word(unsigned mine) {
  static_assert(kPix == 4 && kLanes == 8, "the transpose is for 4 x 8");
  const int lane = threadIdx.x & 31, l = lane & 7;
  const int from = (lane & ~7) + 4 * (l & 1);
  const unsigned w0 = __shfl_sync(0xffffffffu, mine, from);
  const unsigned w1 = __shfl_sync(0xffffffffu, mine, from + 1);
  const unsigned w2 = __shfl_sync(0xffffffffu, mine, from + 2);
  const unsigned w3 = __shfl_sync(0xffffffffu, mine, from + 3);
  const unsigned sel = (l >> 1) | ((l >> 1) + 4) << 4;
  return __byte_perm(__byte_perm(w0, w1, sel), __byte_perm(w2, w3, sel),
                     0x5410);
}

// Store the word of pixels 4 * l .. 4 * l + 3 of the block row (l the
// thread's lane in its row; byte m is pixel 4 * l + m), from the panorama
// index px.p of pixel l: as one 32-bit word, byte by byte at a ragged edge.
__device__ __forceinline__ void put_word(uint8_t* __restrict__ plane,
                                         const Pixels& px, unsigned word) {
  uint8_t* dst = plane + px.p + 3 * (threadIdx.x % kLanes);
  if (px.vec && px.nw == kPix) {
    *reinterpret_cast<unsigned*>(dst) = word;
    return;
  }
  for (int k = 0; k < px.nw; ++k) dst[k] = (uint8_t)(word >> (8 * k));
}

// The bfloat16 bits of bytes k and k + 1 of `word`, in the low and the high
// half: a byte v as a float is exact, and v <= 255 has 8 significant bits,
// so the float's low 16 bits are 0 and its high 16 bits are v as a
// bfloat16.
__device__ __forceinline__ unsigned bf16_pair(unsigned word, int k) {
  const float lo = __uint2float_rn((word >> (8 * k)) & 0xffu);
  const float hi = __uint2float_rn((word >> (8 * k + 8)) & 0xffu);
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// put_word into a bfloat16 plane: the 4 pixels as 4 bfloat16 values (0..255
// are exact in it), one 8-byte store, 16-bit stores at a ragged edge.
__device__ __forceinline__ void put_word(__nv_bfloat16* __restrict__ plane,
                                         const Pixels& px, unsigned word) {
  const uint2 v = make_uint2(bf16_pair(word, 0), bf16_pair(word, 2));
  __nv_bfloat16* dst = plane + px.p + 3 * (threadIdx.x % kLanes);
  if (px.vec && px.nw == kPix) {
    *reinterpret_cast<uint2*>(dst) = v;
    return;
  }
  unsigned short* half = reinterpret_cast<unsigned short*>(dst);
  for (int k = 0; k < px.nw; ++k)
    half[k] = (unsigned short)((k < 2 ? v.x : v.y) >> (16 * (k & 1)));
}

// Store the thread's kPix uint8 results of one plane (byte k of `mine` is
// pixel l + k * kLanes), transposed across its row's lanes (row_word), into
// a uint8 or a bfloat16 plane.
template <class T>
__device__ __forceinline__ void store_plane(T* __restrict__ plane,
                                            const Pixels& px, unsigned mine) {
  put_word(plane, px, row_word(mine));
}

// The uint8 result of a value: rounded half to even (cvt.rni), then, in
// pack4, clamped to 0..255 (cvt.pack.sat).
__device__ __forceinline__ int rounded(float r) { return __float2int_rn(r); }
__device__ __forceinline__ unsigned pack4(int q0, int q1, int q2, int q3) {
  unsigned hi, d;
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;"
      : "=r"(hi) : "r"(q3), "r"(q2), "r"(0));
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;"
      : "=r"(d) : "r"(q1), "r"(q0), "r"(hi));
  return d;   // q0 | q1 << 8 | q2 << 16 | q3 << 24
}

// The copies of a block: chunk j (16 bytes) of the boxes, which lie one
// after the other in a stage, row-major with a pitch of their `cols` bytes,
// goes to byte 16 * j of the stage; this thread copies chunks threadIdx.x +
// i * kThreads. `src` is the chunk's offset from the plane of camera 0 of
// the frame set, -1 for none.
struct Copies {
  int src[kChunks];
  int n;   // chunks of the block
};
__device__ __forceinline__ Copies block_copies(const Box& b0, const Box& b1,
                                               int H, int W) {
  Copies cp;
  const int n0 = b0.cam >= 0 ? b0.rows * b0.cols / 16 : 0;
  const int n1 = b1.cam >= 0 ? b1.rows * b1.cols / 16 : 0;
  cp.n = n0 + n1;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    int j = threadIdx.x + i * kThreads;
    cp.src[i] = -1;
    if (j < cp.n) {
      const Box& b = j < n0 ? b0 : b1;
      if (j >= n0) j -= n0;
      const int per_row = b.cols / 16;
      const int r = j / per_row;
      cp.src[i] = (b.cam * 3 * H + b.row0 + r) * W + b.col0 +
                  16 * (j - r * per_row);
    }
  }
  return cp;
}

// Allow `kernel` the dynamic shared memory `bytes` if that is above the
// default 48 KB: a CUDA error, or 0.
template <class Kernel>
int shared_above_default(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Start the copies of frame set `f` (its 3 planes, if `go`) into `stage`,
// where the boxes of channel c lie at c * stage_bytes, and commit them as
// one group (an empty group if not `go`, so that every thread always has as
// many groups as frame sets started).
__device__ __forceinline__ void start_set(uint8_t* stage, int stage_bytes,
                                          const Copies& cp,
                                          const int8_t* __restrict__ f,
                                          long long HW, bool go) {
  if (go) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int k = 0; k < kChunks; ++k)
        if (cp.src[k] >= 0)
          cp_async16(stage + c * stage_bytes +
                         16 * (threadIdx.x + k * kThreads),
                     f + c * HW + cp.src[k]);
  }
  cp_async_commit();
}

// The B frame sets of a block with something to stage, in order, through a
// ring of R stages of a frame set each: while the block computes frame set
// b by set(stage, b) (`stage` a shared-window address), the copies of sets
// b + 1 .. b + R - 1 are in flight. Before set b, each thread waits for its
// copies of it, and at the barrier for everyone's; everyone has then also
// finished set b - 1, whose stage the copies of set b + R - 1 overwrite.
template <int R, class Set>
__device__ __forceinline__ void run_sets(uint8_t* smem, int stage_bytes,
                                         const Copies& cp,
                                         const int8_t* __restrict__ frames,
                                         int B, int N, long long HW,
                                         Set set) {
  static_assert(R >= 2, "a ring of at least two stages");
  const long long next = 3LL * N * HW;    // from a frame set to the next
  const int set_bytes = 3 * stage_bytes;
#pragma unroll
  for (int r = 0; r < R - 1; ++r)
    start_set(smem + r * set_bytes, stage_bytes, cp, frames + r * next, HW,
              r < B);
  for (int b = 0; b < B; ++b) {
    cp_async_wait<R - 2>();
    __syncthreads();
    const int ahead = b + R - 1;
    start_set(smem + ahead % R * set_bytes, stage_bytes, cp,
              frames + ahead * next, HW, ahead < B);
    set((unsigned)__cvta_generic_to_shared(smem) + b % R * set_bytes, b);
  }
  cp_async_wait<0>();
}

// The offset in a stage of a kernel pixel's top-left tap (x0, y0) of camera
// `cam`, which is one of the block's slots, and of the tap below it (the row
// clamped to the frame, as the gather clamps it). The tap right of either is
// the next byte: on the frame's last column its weight is 0, and the byte
// read lies in the stage (each stage has 16 bytes past its boxes).
__device__ __forceinline__ int2 tap_offsets(int cam, int x0, int y0,
                                            const Box& b0, const Box& b1,
                                            int H) {
  const bool in1 = cam == b1.cam;
  const Box& b = in1 ? b1 : b0;
  const int base = in1 ? b0.rows * b0.cols : 0;
  const int o00 = base + (y0 - b.row0) * b.cols + (x0 - b.col0);
  return make_int2(o00, o00 + (min(y0 + 1, H - 1) - y0) * b.cols);
}

// The four first-tap weights of a kernel pixel in one word: a | (127-a) << 8
// | ay << 16 | (127-ay) << 24, from tap_cw's a << 8 | ay.
__device__ __forceinline__ unsigned tap_weights(int cw) {
  const unsigned a = (cw >> 8) & 0xff, ay = cw & 0xff;
  return a | (127u - a) << 8 | ay << 16 | (127u - ay) << 24;
}

// One byte of shared memory at a shared-window address. The address is
// formed as a uniform stage address plus a per-thread offset, which the
// loads take as their register + uniform-register operands.
__device__ __forceinline__ unsigned lds_u8(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// S = a*ay*v00 + (127-a)*ay*v01 + a*(127-ay)*v10 + (127-a)*(127-ay)*v11 of
// the int8 taps at o00, o00+1 (row y0) and o10, o10+1 (row y1) of the stage
// at shared address `st`, as ay*h0 + (127-ay)*h1 with h = a*v0 + (127-a)*v1
// a row: the same exact int32 (|h| <= 16256 fits the 16-bit halves of
// dp2a).
__device__ __forceinline__ int tap_sum(unsigned st, int o00, int o10,
                                       unsigned w) {
  const unsigned r0 = __byte_perm(lds_u8(st + o00), lds_u8(st + o00 + 1),
                                  0x5140);
  const unsigned r1 = __byte_perm(lds_u8(st + o10), lds_u8(st + o10 + 1),
                                  0x5140);
  const int h0 = __dp4a((int)r0, (int)w, 0);   // bytes 2, 3 of r are 0
  const int h1 = __dp4a((int)r1, (int)w, 0);
  return __dp2a_hi((int)__byte_perm(h0, h1, 0x5410), (int)w, 0);
}

}  // namespace staged
