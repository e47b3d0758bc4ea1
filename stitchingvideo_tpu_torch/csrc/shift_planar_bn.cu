// Band-shifted frame copies, for Hopper (sm_90a).
//
// Replaces the TPU kernel K3 of stitchingvideo_tpu/ops/pallas/composite_mat2.py:
// _make_shift_kernel (:869), launched by shift_planar_bn (:881).
//
// [B, N, 3, H, W] int8 -> [5, N, B, 3, H, W] int8: copy k is the frame moved
// left by 32*k columns with a zero tail, and the batch moves inside the
// camera axis. On the TPU these copies exist because Mosaic cannot DMA from
// a 32-column offset; the port's composite kernel folds the band offset into
// its addressing and does not read them. The kernel stays for the layout's
// other reader, the feather kernel of a later slice.
//
// Bound on the card: memory bytes, read once and write five times. One block
// per source row; each thread moves 4 bytes (so W % 4 == 0, which the
// wrapper checks): it reads its word once and writes it into every copy
// where it lands, and writes the zero word of each copy's tail at its own
// column. Every output word is written exactly once, and neighbouring
// threads touch neighbouring words, so loads and stores coalesce.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kShifts = 5;        // band offsets 0, 32, 64, 96, 128
constexpr int kStepWords = 32 / 4;

__global__ void shift_planar_bn_kernel(const int32_t* __restrict__ src,
                                       int32_t* __restrict__ dst, int B, int N,
                                       int rows, int W4) {
  const long long r = blockIdx.x;           // ((b * N) + n) * rows + row
  const int row = (int)(r % rows);
  const long long bn = r / rows;
  const int n = (int)(bn % N);
  const int b = (int)(bn / N);
  const int32_t* s = src + r * W4;
  const long long copy = (long long)N * B * rows * W4;
  int32_t* d = dst + (((long long)n * B + b) * rows + row) * W4;
  for (int w = threadIdx.x; w < W4; w += blockDim.x) {
    const int32_t v = s[w];
#pragma unroll
    for (int k = 0; k < kShifts; ++k) {
      const int sh = k * kStepWords;
      if (w >= sh) d[k * copy + w - sh] = v;
      if (w >= W4 - sh) d[k * copy + w] = 0;
    }
  }
}

}  // namespace

extern "C" int shift_planar_bn_launch(const void* src, void* dst, int B, int N,
                                      int rows, int W, void* stream) {
  if (B <= 0 || N <= 0 || rows <= 0 || W <= 0) return 0;
  const long long blocks = (long long)B * N * rows;
  shift_planar_bn_kernel<<<(unsigned)blocks, 128, 0, (cudaStream_t)stream>>>(
      (const int32_t*)src, (int32_t*)dst, B, N, rows, W / 4);
  return (int)cudaGetLastError();
}

extern "C" const char* shift_planar_bn_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
