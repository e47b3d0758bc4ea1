// Window-copy probe for Hopper (sm_90a): what does an asynchronous copy of a
// source window into shared memory cost at a given alignment of its origin?
//
// Replaces the TPU probe scripts/test_misaligned_dma.py: make_kernel (:21),
// which asks the same of an HBM -> VMEM async copy at 128- and 32-aligned
// lane offsets: 512 double-buffered copies of a [3, 32, 256] int8 window of
// a [3, H, W] frame at (oy, ox), each completed on a semaphore, and per
// window the sums over (channel, window row) of each of the 256 columns,
// written as float32 [2, 128].
//
// Hopper's counterpart of that DMA engine is the Tensor Memory Accelerator:
// one thread issues one cp.async.bulk.tensor of the whole window against a
// tensor map of the frame, and the copy completes on an mbarrier's
// transaction count. A tiled copy's box must start on a 16-byte boundary of
// the row (on the H100 an origin off it faults with an illegal instruction)
// and copies at its full rate only from a 32-byte boundary, the L2's sector
// (a box 16 bytes past one is slower than a box widened down to the sector,
// though that moves more bytes; measured in PERF.md). So a window
// whose column is off 32 bytes is copied as the 32-byte-aligned box that
// covers it, 288 columns wide, and the consumers read it at the byte offset
// d = ox % 32. The global address and the row stride must be multiples of
// 16 bytes (the wrapper checks both).
//
// The tensor maps: rank 3 over the frame seen as 2-byte elements (a box
// row holds at most 256 elements, and a row of 288 bytes is wanted), dims
// {W / 2, H, 3}, byte strides {W, H * W}, no interleave, no swizzle, no L2
// promotion (256-byte promotion slowed every case); boxes {128, 32, 3} (the
// window, 24,576 bytes, for an origin on a 32-byte boundary) and
// {144, 32, 3} (27,648 bytes, for any other). A copy's coordinates are
// {16 * (ox / 32), oy, 0}; where W is not a multiple of 32 a wide box may
// end up to 16 bytes past the row, which the copy fills with zeros that no
// sum reads. Both maps are encoded on the host in every call (a
// microsecond), so no map of a freed frame can outlive it, and are passed
// by value as __grid_constant__ kernel parameters. cuTensorMapEncodeTiled
// is reached through the runtime's driver entry point, so the library needs
// no -lcuda.
//
// The grid is persistent: the SMs times the blocks an SM holds (two, at four
// stages of one box each), capped at the window count; block b takes windows
// b, b + gridDim.x, ... Each stage has a full and an empty mbarrier. One
// thread of the producer warp waits for a stage to be empty, arms its full
// barrier with the box's bytes and issues the copy. Four consumer groups of
// two warps each own one stage: group q takes the block's windows q, q + 4,
// q + 8, ... (counting the windows it copies), waits for the full barrier,
// sums the window and releases the stage.
//
// The consumer costs less than the copy it follows and needs no other
// group: thread t of a group (64 threads) sums columns 4t .. 4t + 3 over all
// 96 rows, one 4-byte shared load a row where d = 0, else the two words that
// hold the 4 columns, funnel-shifted into place (d is the same for the whole
// window, so nothing diverges); a warp reads 128 consecutive bytes a row, so
// no bank conflicts. It keeps its 4 column sums packed two to a 32-bit word
// as 16-bit lanes of the bytes biased by 128 (b ^ 0x80 = b + 128, 0..255):
// 96 rows sum to at most 24,480, so no lane carries into the next and every
// step is an exact integer add. Each sum, less 96 * 128, is converted to
// float once and the 4 go out as one 16-byte store. A sum of 96 int8 values
// is an integer below 2^24 in magnitude, exact in float32 in any order, so
// the output is bit-exact against the plain version.
//
// A window whose origin lies outside the frame or off `align` is not copied
// (TMA's zero fill must not stand in for that check): its 256 outputs are
// NaN, which the comparison with the plain version shows. The origins live
// on the device, so the kernel checks them itself; producer and consumers
// apply the same check, so both skip such a window and advance the stage
// ring on the same schedule.
//
// Bound on the card: bytes. The probe's frame (6.3 MB) fits the 50 MB L2, so
// repeated calls measure the L2 -> shared memory path, which is what a
// staged gather kernel sees for a frame row it reads again; a frame of twice
// the L2 measures copies from HBM. The byte bound counts each distinct frame
// byte once.
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWinH = 32, kWinW = 256, kChannels = 3;
constexpr int kRows = kChannels * kWinH;            // 96 rows of 256 bytes
constexpr int kWinBytes = kRows * kWinW;            // 24,576
constexpr int kWideW = kWinW + 32;                  // the box off 32 bytes
constexpr int kWideBytes = kRows * kWideW;          // 27,648
constexpr int kStages = 4;
constexpr int kGroup = 64;                          // consumers of a stage
constexpr int kConsumers = kStages * kGroup;        // 256
constexpr int kThreads = 32 + kConsumers;           // producer warp first
constexpr uint32_t kBias = kRows * 128;             // the bias of a sum
constexpr int kSmemBytes = kStages * kWideBytes + 2 * kStages * 8 +
                           128;                     // + alignment slack

static_assert(kGroup * 4 == kWinW, "a thread sums 4 columns");
static_assert(kRows * 255 < 65536, "a packed 16-bit lane cannot carry");
static_assert(kWideBytes % 128 == 0, "stages stay 128-byte aligned");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_arrive_expect_tx(uint64_t* bar,
                                                     uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// one TMA copy of the box that starts at the 32-byte boundary `x32` (=
// ox / 32) of row oy, every channel, into `dst`, completing its bytes on
// `bar`
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                       int x32, int oy, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(16 * x32), "r"(oy), "r"(0), "r"(smem_addr(bar))
      : "memory");
}

// a thread's 4 columns (the 32-bit word at byte 4t + d of each row, rows
// `rs` bytes apart), biased by 128 and summed over the 96 rows: lo packs
// columns 0 and 2, hi 1 and 3 (low half first)
template <bool SHIFTED>
__device__ __forceinline__ void sum_rows(const uint8_t* st, int rs, int t,
                                         int d, uint32_t& lo, uint32_t& hi) {
  const uint32_t* p = (const uint32_t*)st + t + (d >> 2);
  const uint32_t sh = 8 * (d & 3);
  const int rw = rs / 4;                     // words a row
#pragma unroll 8
  for (int r = 0; r < kRows; ++r) {
    uint32_t x = p[r * rw];
    if (SHIFTED) x = __funnelshift_r(x, p[r * rw + 1], sh);
    const uint32_t y = x ^ 0x80808080u;                  // b + 128
    lo += y & 0x00ff00ffu;
    hi += (y >> 8) & 0x00ff00ffu;
  }
}

__device__ __forceinline__ bool origin_ok(int2 o, int H, int W, int align) {
  return o.x >= 0 && o.x <= H - kWinH && o.y >= 0 && o.y <= W - kWinW &&
         (o.y & (align - 1)) == 0;
}

__global__ void __launch_bounds__(kThreads)
    window_probe_kernel(const __grid_constant__ CUtensorMap map_exact,
                        const __grid_constant__ CUtensorMap map_wide,
                        const int2* __restrict__ org, float* __restrict__ out,
                        int nwin, int H, int W, int align) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = (uint8_t*)(((uintptr_t)smem_raw + 127) & ~(uintptr_t)127);
  uint8_t* stage = smem;                                   // kStages boxes
  uint64_t* full = (uint64_t*)(smem + kStages * kWideBytes);
  uint64_t* empty = full + kStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);                  // the producer's expect_tx
      bar_init(&empty[s], kGroup / 32);       // one arrival a warp of its group
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    // producer: one elected thread keeps up to kStages copies in flight
    if (threadIdx.x != 0) return;
    int k = 0;                                // windows copied so far
    int w = blockIdx.x;
    int2 o = w < nwin ? org[w] : int2{};
    for (; w < nwin; w += gridDim.x) {
      const int2 cur = o;
      if (w + (int)gridDim.x < nwin) o = org[w + gridDim.x];
      if (!origin_ok(cur, H, W, align)) continue;
      const int s = k % kStages;
      const bool wide = cur.y & 31;
      bar_wait(&empty[s], ((k / kStages) & 1) ^ 1);
      bar_arrive_expect_tx(&full[s], wide ? kWideBytes : kWinBytes);
      tma_box(stage + s * kWideBytes, wide ? &map_wide : &map_exact,
              cur.y >> 5, cur.x, &full[s]);
      ++k;
    }
    return;
  }

  // consumers: group q owns stage q
  const int ct = threadIdx.x - 32;
  const int q = ct / kGroup, t = ct % kGroup;
  float4* out4 = (float4*)out;
  int k = 0;
  int w = blockIdx.x;
  int2 o = w < nwin ? org[w] : int2{};
  for (; w < nwin; w += gridDim.x) {
    const int2 cur = o;
    if (w + (int)gridDim.x < nwin) o = org[w + gridDim.x];
    const bool ok = origin_ok(cur, H, W, align);
    if (k % kStages != q) {                   // another group's turn
      k += ok;
      continue;
    }
    if (!ok) {                                // not copied: NaN
      const float nan = __int_as_float(0x7fc00000);
      out4[(long long)w * kGroup + t] = make_float4(nan, nan, nan, nan);
      continue;
    }
    const int d = cur.y & 31;                 // the window's byte in its box
    bar_wait(&full[q], (k / kStages) & 1);
    const uint8_t* st = stage + q * kWideBytes;
    uint32_t lo = 0, hi = 0;
    if (d == 0) sum_rows<false>(st, kWinW, t, d, lo, hi);
    else sum_rows<true>(st, kWideW, t, d, lo, hi);
    __syncwarp();                             // the warp's reads are summed
    if ((t & 31) == 0) bar_arrive(&empty[q]);
    const int b = (int)kBias;
    out4[(long long)w * kGroup + t] = make_float4(
        (float)((int)(lo & 0xffffu) - b), (float)((int)(hi & 0xffffu) - b),
        (float)((int)(lo >> 16) - b), (float)((int)(hi >> 16) - b));
    ++k;
  }
}

__global__ void empty_kernel() {}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// error codes beyond cudaError_t's: a failed driver lookup, a failed encode
constexpr int kLookupFailed = 100000;     // + the lookup's query result
constexpr int kEncodeFailed = 200000;     // + the CUresult

int encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  static int status = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return kLookupFailed + (int)q;
    cached = (EncodeTiled)p;
    return 0;
  }();
  *fn = cached;
  return status;
}

// the kernel's shared memory opt-in and the blocks an SM holds, per device
int blocks_per_sm(int* blocks) {
  static int per_device[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && per_device[dev]) {
    *blocks = per_device[dev];
    return 0;
  }
  e = cudaFuncSetAttribute(window_probe_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(empty_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, window_probe_kernel,
                                                    kThreads, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  if (n < 1) return (int)cudaErrorInvalidConfiguration;
  if (dev < 64) per_device[dev] = n;
  *blocks = n;
  return 0;
}

// the persistent grid: the SMs times the blocks an SM holds
int grid_blocks(int* blocks) {
  int per_sm = 0, dev = 0, sms = 0;
  int rc = blocks_per_sm(&per_sm);
  if (rc != 0) return rc;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  *blocks = sms * per_sm;
  return 0;
}

}  // namespace

// frame: [3, H, W] int8 on the card, 16-byte aligned, W a multiple of 16;
// org: [nwin] int32 pairs (oy, ox); out: [nwin, 256] float32; align: a
// power of two that every column origin must be a multiple of.
extern "C" int window_probe_launch(const void* frame, const void* org,
                                   void* out, int nwin, int H, int W,
                                   int align, void* stream) {
  if (nwin <= 0) return 0;
  if (align < 1 || (align & (align - 1)) || H < kWinH || W < kWinW ||
      W % 16 || (uintptr_t)frame % 16)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = nullptr;
  int rc = encode_tiled(&encode);
  if (rc != 0) return rc;
  // the frame as 2-byte elements, boxes of 128 (exact) and 144 (wide) of
  // them a row
  CUtensorMap maps[2];
  const cuuint64_t dims[3] = {(cuuint64_t)W / 2, (cuuint64_t)H, kChannels};
  const cuuint64_t strides[2] = {(cuuint64_t)W, (cuuint64_t)H * W};
  const cuuint32_t unit[3] = {1, 1, 1};
  for (int m = 0; m < 2; ++m) {
    const cuuint32_t box[3] = {(cuuint32_t)(m ? kWideW : kWinW) / 2, kWinH,
                               kChannels};
    CUresult r = encode(&maps[m], CU_TENSOR_MAP_DATA_TYPE_UINT16, 3,
                        const_cast<void*>(frame), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return kEncodeFailed + (int)r;
  }
  int blocks = 0;
  rc = grid_blocks(&blocks);
  if (rc != 0) return rc;
  if (blocks > nwin) blocks = nwin;
  window_probe_kernel<<<blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      maps[0], maps[1], (const int2*)org, (float*)out, nwin, H, W, align);
  return (int)cudaGetLastError();
}

// the blocks of the probe kernel an SM holds (the occupancy query); its
// persistent grid is the SMs times these
extern "C" int window_probe_blocks_per_sm(int* blocks) {
  return blocks_per_sm(blocks);
}

// the windows a block keeps in flight: the stages of its ring
extern "C" int window_probe_stages(int* stages) {
  *stages = kStages;
  return 0;
}

// the launch floor: an empty kernel on the probe's grid, block and shared
// memory, for timing beside it
extern "C" int window_probe_empty_launch(void* stream) {
  int blocks = 0;
  int rc = grid_blocks(&blocks);
  if (rc != 0) return rc;
  empty_kernel<<<blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* window_probe_error_string(int e) {
  if (e >= kEncodeFailed) return "cuTensorMapEncodeTiled failed (CUresult "
                                 "= code - 200000)";
  if (e >= kLookupFailed) return "cuTensorMapEncodeTiled not found through "
                                 "the driver entry point (query result = "
                                 "code - 100000)";
  return cudaGetErrorString((cudaError_t)e);
}
