// Window-copy probe for Hopper (sm_90a): what does an asynchronous copy of a
// source window into shared memory cost at a given alignment of its origin?
//
// Replaces the TPU probe scripts/test_misaligned_dma.py: make_kernel (:21),
// which asks the same of an HBM -> VMEM async copy at 128- and 32-aligned
// lane offsets: 512 double-buffered copies of a [3, 32, 256] int8 window of
// a [3, H, W] frame at (oy, ox), and per window the sums over (channel,
// window row) of each of the 256 columns, written as float32 [2, 128].
//
// Here a block walks over windows blockIdx.x, blockIdx.x + gridDim.x, ...
// with two window buffers in shared memory: while it sums window i, the
// cp.async copies of window i + 1 are in flight (cp.async.cg 16-byte, or
// cp.async.ca 8- and 4-byte copies for origins that are only 8- or 4-aligned;
// VEC is the copy width). Thread t then sums column t over the 96 rows; sums
// of 96 int8 values are exact in float32 in any order, so the output is
// bit-exact against the plain version.
//
// A window whose origin lies outside the frame or is not VEC-aligned is not
// copied: its 256 outputs are NaN, which the comparison with the plain
// version shows (the origins live on the device; checking them on the host
// would put a synchronisation into every timed call).
//
// Bound on the card: bytes. The frame (6.3 MB at the probe's size) fits the
// L2 cache, so after the first call the copies measure the L2 -> shared
// memory path, which is what a staged gather kernel would see for a frame
// row it reads again; the byte bound counts each distinct frame byte once.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWinH = 32, kWinW = 256, kChannels = 3;
constexpr int kRows = kChannels * kWinH;           // 96 rows of 256 bytes
constexpr int kWinBytes = kRows * kWinW;           // 24,576
constexpr int kThreads = kWinW;                    // one thread a column

template <int VEC>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(VEC)
                 : "memory");
  }
}

template <int VEC>
__global__ void window_probe_kernel(const int8_t* __restrict__ frame,
                                    const int32_t* __restrict__ org,
                                    float* __restrict__ out, int nwin, int H,
                                    int W) {
  extern __shared__ __align__(16) int8_t smem[];   // 2 windows
  constexpr int kVecs = kWinW / VEC;               // copies a row

  auto origin_ok = [&](int w) {
    const int oy = org[2 * w], ox = org[2 * w + 1];
    return oy >= 0 && oy + kWinH <= H && ox >= 0 && ox + kWinW <= W &&
           ox % VEC == 0;
  };
  auto start_copies = [&](int w, int buf) {
    if (w < nwin && origin_ok(w)) {
      const int oy = org[2 * w], ox = org[2 * w + 1];
      for (int i = threadIdx.x; i < kRows * kVecs; i += kThreads) {
        const int row = i / kVecs, col = (i - row * kVecs) * VEC;
        const int c = row / kWinH, r = row - c * kWinH;
        cp_async<VEC>(smem + buf * kWinBytes + row * kWinW + col,
                      frame + ((long long)c * H + oy + r) * W + ox + col);
      }
    }
    // every thread commits a group each time, an empty one too, so that
    // "all but the newest group" below always means the window being summed
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  int buf = 0;
  start_copies(blockIdx.x, buf);
  for (int w = blockIdx.x; w < nwin; w += gridDim.x, buf ^= 1) {
    start_copies(w + gridDim.x, buf ^ 1);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    float acc = origin_ok(w) ? 0.0f : __int_as_float(0x7fc00000);   // NaN
    const int8_t* win = smem + buf * kWinBytes + threadIdx.x;
    for (int row = 0; row < kRows; ++row) acc += (float)win[row * kWinW];
    out[(long long)w * kWinW + threadIdx.x] = acc;
    __syncthreads();   // the next copies overwrite this buffer
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int VEC>
int launch(const void* frame, const void* org, void* out, int nwin, int H,
           int W, int blocks, cudaStream_t stream) {
  window_probe_kernel<VEC><<<blocks, kThreads, 2 * kWinBytes, stream>>>(
      (const int8_t*)frame, (const int32_t*)org, (float*)out, nwin, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// vec: bytes a copy (16, 8 or 4); W and the frame's address must be
// multiples of it. blocks: the grid (the wrapper passes the SM count).
extern "C" int window_probe_launch(const void* frame, const void* org,
                                   void* out, int nwin, int H, int W, int vec,
                                   int blocks, void* stream) {
  if (nwin <= 0) return 0;
  if (blocks < 1 || (vec != 16 && vec != 8 && vec != 4))
    return (int)cudaErrorInvalidValue;
  if (blocks > nwin) blocks = nwin;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec == 16) return launch<16>(frame, org, out, nwin, H, W, blocks, s);
  if (vec == 8) return launch<8>(frame, org, out, nwin, H, W, blocks, s);
  return launch<4>(frame, org, out, nwin, H, W, blocks, s);
}

extern "C" const char* window_probe_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
