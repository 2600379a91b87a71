// K4 in bf16: the kk x kk stride-1 "same" convolution (kk = 1 or 3), zero
// padding kk/2, on Hopper's tensor cores:
//
//   out[b,y,x,co] = sum_{dy,dx,ci} x[b, y+dy-pad, x+dx-pad, ci] * w[dy,dx,ci,co]
//
// x is NHWC and w HWIO, both bf16; the sum is taken in fp32 and rounded to
// bf16 on the way out (round to nearest even). conv_same_f32.cu takes fp32.
//
// Replaces: scripts/bench_pallas_conv.py::_kernel (pallas_conv_same) for
// bf16 inputs. The TPU kernel keeps the whole padded image in VMEM and
// builds one (bh*W, kk*kk*Cin) patch matrix per row block for one MXU dot;
// its ``bh`` and H % bh == 0 are the TPU's tiling, not the function: any H
// and W are taken here.
//
// Bound on this card: at the probe's 64->64 shape (16 x 128^2) the conv is
// 19.33 GFLOP against 67 MB of x and y: 0.0195 ms on the tensor cores
// (989 TFLOP/s) and 0.020 ms of bytes (3.35 TB/s), the balance point;
// 32->64 and 64->32 are byte-bound (50 MB, 0.015 ms).
//
// Design: an implicit GEMM (M = output pixels, N = Cout, K = kk*kk*Cin)
// whose patch matrix is never formed, not even in shared memory.
//   - Persistent grid: one block per SM walks the output tiles with a
//     fixed stride. A tile is 4 rows x 64 columns of one image; each of
//     two consumer warpgroups takes 2 rows (wgmma's M is 64 pixels), each
//     k step for both rows against one B.
//   - Weights resident: a block stages its Cout slice of all kk*kk taps
//     once, K-major in 8 x 16-byte core matrices ([tap][Cin/8][NS][8]).
//     Where the whole of Cout does not fit beside a ring of two halos
//     (128->128 is 295 KB), the plan gives each block one slice of Cout,
//     and the tiles are walked once per slice.
//   - Halos by TMA (tma.cuh): one producer thread loads each tile's
//     (4+kk-1) x (64+kk-1) x Cin input halo into a ring of stages (2-4;
//     1 where two do not fit, Cin 128 at kk 3), one box per 8 channels,
//     so that shared memory holds [Cin/8][halo pixel][8]. The
//     tensor map fills out-of-bounds elements with zero: that fill is the
//     "same" padding and the ragged edge, and box coordinates may be
//     negative. Completion goes through one full and one empty mbarrier
//     per stage.
//   - wgmma m64nNk16 with A and B in shared memory, by descriptor, without
//     swizzle. A core matrix of A is 8 consecutive halo pixels x 16 bytes
//     (8 channels), so a tap (dy, dx) only moves A's start address, by
//     ((row + dy) * halo width + dx) * 16 bytes: no copy per tap. LBO is
//     the halo's chunk pitch, SBO 128 bytes. The fp32 accumulators stay in
//     registers (NS/2 per thread); N is issued as pieces of 64, 32 and 16.
//   - Epilogue: each warp rounds its 16 pixels x NS channels to bf16 into
//     a padded staging tile in shared memory (off the same banks) and
//     writes them as 16-byte vectors, contiguous in NHWC, masked at the
//     ragged edge.
// The launch plan (ring stages, Cout slices, grid, the shared-memory
// layout) is chosen in ops/conv_same.py::plan_bf16 and passed in.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

using jspsr::encode_tiled;
using jspsr::EncodeTiled;
using jspsr::mbar_arrive;
using jspsr::mbar_expect_tx;
using jspsr::mbar_init;
using jspsr::mbar_init_fence;
using jspsr::mbar_wait;
using jspsr::smem_u32;
using jspsr::tma_load_4d;

constexpr int kTileW = 64;      // output pixels per row: wgmma's M
constexpr int kWarpgroups = 2;  // consumers
constexpr int kRowsPerWg = 2;   // rows per consumer: accumulator sets
constexpr int kRows = kWarpgroups * kRowsPerWg;  // output rows per tile
constexpr int kConsumers = kWarpgroups * 128;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kSmemLimit = 232448;         // per block on sm_90
constexpr int kMaxStages = 4;

// byte offsets into the block's 128-byte aligned shared memory
struct Layout {
  int stages;   // halo stages in the ring
  int pitch;    // bytes per 8-channel chunk of one halo
  int ring;     // the ring: stages x (Cin/8) x pitch
  int weights;  // [tap][Cin/8][NS][8] bf16
  int staging;  // 8 warps x 16 pixels x (2 NS + 16) bytes
};

// wgmma shared-memory descriptor, no swizzle: start address, LBO (the
// stride between the two 8-element K halves of a k16 slab) and SBO (the
// stride between 8-row groups), all in 16-byte units
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (it sees the registers change only at the issue)
template <int N>
__device__ __forceinline__ void fence_acc(float* acc) {
#pragma unroll
  for (int q = 0; q < N; ++q) asm volatile("" : "+f"(acc[q])::"memory");
}

// D (64 x N, fp32) = A (64 x 16) B (16 x N) + (scale_d ? D : 0), A and B
// bf16 in shared memory; d holds the N/2 accumulators of this thread
__device__ __forceinline__ void wgmma_n16(float* d, uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n32(float* d, uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// one k16 step of a consumer row: all of the slice's NS output channels,
// in pieces of 64, 32 and 16 (accumulators of column group J at 4J..4J+3)
template <int NS>
__device__ __forceinline__ void mma_row(float* acc, uint64_t da, uint32_t b,
                                        uint32_t b_lbo, int scale_d) {
#pragma unroll
  for (int n = 0; n + 64 <= NS; n += 64)
    wgmma_n64(acc + n / 2, da, desc(b + n * 16, b_lbo, 128), scale_d);
  constexpr int r = NS % 64;
  if constexpr (r >= 32)
    wgmma_n32(acc + (NS - r) / 2, da, desc(b + (NS - r) * 16, b_lbo, 128),
              scale_d);
  if constexpr (r % 32 == 16)
    wgmma_n16(acc + (NS - 16) / 2, da, desc(b + (NS - 16) * 16, b_lbo, 128),
              scale_d);
}

// NS: output channels per block (Cout / n_split); KK: the kernel size, 1 or
// 3, a template argument so that the tap loop unrolls (faster on an H100
// than with the taps counted at run time)
template <int NS, int KK>
__global__ void __launch_bounds__(kThreads, 1)
conv_same_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __nv_bfloat16* __restrict__ w,
                      __nv_bfloat16* __restrict__ out, int h, int wd,
                      int cin, int cout, int n_split, int tiles_x,
                      int tiles_y, int n_tiles, Layout lay) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  unsigned char* smem = smem_raw + (base - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [stages]
  uint64_t* empty = full + lay.stages;                 // [stages]
  const uint32_t ring = base + lay.ring;
  const uint32_t wsm = base + lay.weights;
  const uint32_t stage_bytes = (cin / 8) * lay.pitch;

  const int tid = threadIdx.x;
  const int n0 = (blockIdx.x % n_split) * NS;
  const int first = blockIdx.x / n_split;
  const int step = gridDim.x / n_split;
  constexpr int kTaps = KK * KK, kPad = KK / 2;
  constexpr int kHc = kTileW + KK - 1;  // halo columns
  const int my_tiles =
      first < n_tiles ? (n_tiles - first + step - 1) / step : 0;

  if (tid == 0) {
    for (int s = 0; s < lay.stages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), kConsumers);
    }
    mbar_init_fence();
  }
  // the block's slice of every tap's weights, once, into K-major core
  // matrices: element e of [tap][Cin/8][NS] is the 16-byte row of channels
  // 8 (e / NS % (Cin/8)) .. +7 for output n0 + e % NS; neighbouring threads
  // write neighbouring rows (no bank conflicts) and read neighbouring
  // outputs of each channel (coalesced). Every thread runs the same number
  // of rounds, the last ones clamped to the last row (written twice, the
  // same bytes): a loop whose trip count differs between threads would
  // leave the warpgroups divergent in ptxas's view, and it would then
  // serialise every wgmma of the kernel.
  __nv_bfloat16* wst = reinterpret_cast<__nv_bfloat16*>(smem + lay.weights);
  const int rows = kTaps * (cin / 8) * NS;
  for (int r = 0; r < (rows + kThreads - 1) / kThreads; ++r) {
    const int e = min(tid + r * kThreads, rows - 1);
    const int n = e % NS, tc8 = e / NS;  // tc8 = tap * Cin/8 + ci/8
    const int tap = tc8 / (cin / 8), c8 = tc8 - tap * (cin / 8);
    const __nv_bfloat16* src =
        w + static_cast<int64_t>(tap * cin + c8 * 8) * cout + n0 + n;
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = src[j * cout];
    reinterpret_cast<uint4*>(wst)[e] = *reinterpret_cast<const uint4*>(v);
  }
  // written through the generic proxy, read by wgmma through the async one
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // the role, warp-uniform as the compiler can see (a shuffle of lane 0's)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == kWarpgroups) {  // the producer warp: one thread issues the TMA
    if (tid != kConsumers) return;
    constexpr uint32_t kBox = (kRows + KK - 1) * kHc * 16;
    for (int i = 0; i < my_tiles; ++i) {
      const int s = i % lay.stages;
      if (i >= lay.stages)
        mbar_wait(smem_u32(empty + s), (i / lay.stages - 1) & 1);
      int t = first + i * step;
      const int cx = t % tiles_x;
      t /= tiles_x;
      const int ry = t % tiles_y, b = t / tiles_y;
      const uint32_t bar = smem_u32(full + s);
      mbar_expect_tx(bar, kBox * (cin / 8));
      const uint32_t dst = ring + s * stage_bytes;
      for (int c = 0; c < cin / 8; ++c)
        tma_load_4d(dst + c * lay.pitch, &xmap, c * 8, cx * kTileW - kPad,
                    ry * kRows - kPad, b, bar);
    }
    return;
  }

  // consumers: warpgroup wg computes rows wg * kRowsPerWg .. + kRowsPerWg
  // - 1 of every tile, each k step for all of them against one B
  const int warp = (tid % 128) / 32, lane = tid % 32;
  constexpr int kAcc = NS / 2;
  constexpr int kRowPitch = NS * 2 + 16;  // staging row, bytes
  constexpr int kVecs = NS / 8;          // 16-byte vectors per pixel
  const uint32_t b_lbo = NS * 16;
  unsigned char* st = smem + lay.staging + (wg * 4 + warp) * 16 * kRowPitch;
  for (int i = 0; i < my_tiles; ++i) {
    const int s = i % lay.stages;
    int t = first + i * step;
    const int cx = t % tiles_x;
    t /= tiles_x;
    const int ry = t % tiles_y, b = t / tiles_y;
    // the tile's first k step overwrites the accumulators (scale-d 0), so
    // no other instruction defines them between the wgmma of two tiles
    float acc[kRowsPerWg][kAcc];
    mbar_wait(smem_u32(full + s), (i / lay.stages) & 1);
    wgmma_fence();
    const uint32_t halo = ring + s * stage_bytes;
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const int dy = tap / KK, dx = tap % KK;
      const uint32_t a0 =
          halo + ((wg * kRowsPerWg + dy) * kHc + dx) * 16;
      const uint32_t b0 = wsm + tap * cin * NS * 2;
      for (int ks = 0; ks < cin / 16; ++ks) {
#pragma unroll
        for (int r = 0; r < kRowsPerWg; ++r)
          mma_row<NS>(acc[r],
                      desc(a0 + r * kHc * 16 + 2 * ks * lay.pitch,
                           lay.pitch, 128),
                      b0 + ks * 2 * b_lbo, b_lbo, tap + ks > 0);
      }
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int r = 0; r < kRowsPerWg; ++r) fence_acc<kAcc>(acc[r]);
    mbar_arrive(smem_u32(empty + s));

#pragma unroll
    for (int r = 0; r < kRowsPerWg; ++r) {
      // rows lane/4 and lane/4 + 8 of the warp's 16 pixels, columns
      // 8J + 2(lane%4) and the next: wgmma's accumulator layout
#pragma unroll
      for (int j = 0; j < NS / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(st + (lane / 4) * kRowPitch +
                                           col * 2) =
            __floats2bfloat162_rn(acc[r][4 * j], acc[r][4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(st + (lane / 4 + 8) * kRowPitch +
                                           col * 2) =
            __floats2bfloat162_rn(acc[r][4 * j + 2], acc[r][4 * j + 3]);
      }
      __syncwarp();
      // 16 pixels x kVecs vectors, kVecs / 2 per lane; the ragged edge is
      // a predicate on each store, not a branch around the loop
      const int y = ry * kRows + wg * kRowsPerWg + r;
      const int x0 = cx * kTileW + warp * 16;
      __nv_bfloat16* orow =
          out + (static_cast<int64_t>(b) * h + y) * wd * cout + n0;
#pragma unroll
      for (int q = 0; q < kVecs / 2; ++q) {
        const int e = lane + 32 * q;
        const int m = e / kVecs, v = e - m * kVecs;
        const uint4 val =
            *reinterpret_cast<const uint4*>(st + m * kRowPitch + v * 16);
        if (y < h && x0 + m < wd)
          *reinterpret_cast<uint4*>(orow + static_cast<int64_t>(x0 + m) *
                                               cout + v * 8) = val;
      }
      __syncwarp();
    }
  }
}

template <int NS, int KK>
int launch(const CUtensorMap& map, const __nv_bfloat16* w, __nv_bfloat16* out,
           int h, int wd, int cin, int cout, int tiles_x, int tiles_y,
           int n_tiles, const Layout& lay, int smem, int grid,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_same_bf16_kernel<NS, KK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_same_bf16_kernel<NS, KK><<<grid, kThreads, smem, stream>>>(
      map, w, out, h, wd, cin, cout, cout / NS, tiles_x, tiles_y, n_tiles,
      lay);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound from Python with ctypes. x (B,H,W,Cin) and out
// (B,H,W,Cout) NHWC, w (kk,kk,Cin,Cout) HWIO, bf16, contiguous on the
// current device, 16-byte aligned. The plan (ops/conv_same.py::plan_bf16)
// gives the tile geometry (tile_w, rows: checked against this kernel's),
// the tile counts, the Cout slice ns, the shared-memory layout and size
// and the grid. Takes kk in {1, 3}, Cin in [16, 128] and Cout in [16,
// 128], both multiples of 16; anything else returns cudaErrorInvalidValue
// without launching. Launches on ``stream`` without synchronising and
// returns cudaGetLastError() (cudaErrorNotSupported where libcuda has no
// tensor-map encoder).
extern "C" int jspsr_conv_same_bf16(
    const void* x, const void* w, void* out, int64_t batch, int h, int wd,
    int cin, int cout, int kk, int tile_w, int rows, int tiles_x, int tiles_y,
    int n_tiles, int ns, int stages, int pitch, int ring, int weights,
    int staging, int smem, int grid, void* stream) {
  if (batch == 0 || h == 0 || wd == 0) return 0;
  const int n_split = ns > 0 ? cout / ns : 0;
  if ((kk != 1 && kk != 3) || cin < 16 || cin > 128 || cin % 16 != 0 ||
      cout < 16 || cout > 128 || ns < 16 || ns % 16 != 0 ||
      cout % ns != 0 || tile_w != kTileW || rows != kRows || stages < 1 ||
      stages > kMaxStages || smem > kSmemLimit || grid < 1 ||
      grid % n_split != 0 || ring < 16 * stages || pitch % 128 != 0 ||
      ring % 128 != 0 ||
      pitch < (kRows + kk - 1) * (kTileW + kk - 1) * 16)
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cin),
                              static_cast<cuuint64_t>(wd),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(cin) * 2,
      static_cast<cuuint64_t>(cin) * 2 * wd,
      static_cast<cuuint64_t>(cin) * 2 * wd * h};
  const cuuint32_t box[4] = {8, static_cast<cuuint32_t>(kTileW + kk - 1),
                             static_cast<cuuint32_t>(kRows + kk - 1), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay{stages, pitch, ring, weights, staging};
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define JSPSR_K4_CASE(N)                                                 \
  case N:                                                                \
    return kk == 1 ? launch<N, 1>(map, wb, ob, h, wd, cin, cout, tiles_x, \
                                  tiles_y, n_tiles, lay, smem, grid, s)   \
                   : launch<N, 3>(map, wb, ob, h, wd, cin, cout, tiles_x, \
                                  tiles_y, n_tiles, lay, smem, grid, s);
  switch (ns) {
    JSPSR_K4_CASE(16)
    JSPSR_K4_CASE(32)
    JSPSR_K4_CASE(48)
    JSPSR_K4_CASE(64)
    JSPSR_K4_CASE(80)
    JSPSR_K4_CASE(96)
    JSPSR_K4_CASE(112)
    JSPSR_K4_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef JSPSR_K4_CASE
}
