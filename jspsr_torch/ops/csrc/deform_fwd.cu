// Modulated deformable convolution forward for the SPN refinement head:
// one input and one output channel, 3x3 kernel, stride 1, dilation 1.
//
//   out[b,y,x] = bias + sum_t w[t] * m[b,t,y,x] * bilinear(x_b, py, px)
//   py = y - pad + t/3 + off[b,2t,y,x],  px = x - pad + t%3 + off[b,2t+1,y,x]
//
// Bilinear sampling takes the four corners around (py, px); a corner off
// the image contributes zero. This is the tent relu(1 - |i - p|) of the TPU
// kernel, including integer positions (ty = 0 weights the floor corner 1).
//
// Replaces: jspsr_tpu/ops/pallas_deform.py::_fwd_kernel. The TPU kernel
// turns sampling into per-tap one-hot matmuls, (H, P) tent matrices against
// the (H, W) image, which is O(H) work per sample and suits the MXU. Here
// the natural form is a direct gather.
//
// Bound on this card: bytes. Each output pixel reads 18 offsets (72 B) and
// 9 mask values (36 B) once, its share of the image (4 B) and writes 4 B:
// about 116 B of device memory against about 150 FLOP, far below the
// H100's balance point. In practice the bound is the rate at which those
// planes can be read: a kernel that only streams the same bytes once
// (bench_deform_fwd.py's read ceiling: about 70 % of the card's peak
// rate, launch included) and this kernel's TMA loads without their
// arithmetic run at the same rate; what is left is overlapping the
// arithmetic with the loads. The first
// version (one thread per pixel, 27 scalar plane loads and up to 36 cached
// corner gathers each) hid neither its latency nor its arithmetic behind
// the loads at the batch shapes. This one:
//   - Persistent grid: three blocks per SM (what their shared memory
//     allows; min(tiles, 3 x SMs) blocks), each walking output tiles of 4
//     rows x 64 columns of one image (a 256-byte TMA row per plane row)
//     with a fixed stride.
//   - TMA (tma.cuh): one producer thread per block loads each tile's 18
//     offset and 9 mask planes (3-D tensor maps over (W, H, 18 B) and (W,
//     H, 9 B), one box each) and a window of the image, the tile plus a
//     margin of at least 4 px, its left edge on a multiple of 4 columns (15
//     x 80 floats), into a ring of 2 stages of 32 KB on full and empty
//     mbarriers: up to six tiles' loads in flight per SM, while the
//     consumers compute. The tensor map's zero fill outside the image IS
//     the off-image-corner rule inside the window, and the ragged edge. A
//     box's rows may be at most 256 bytes here (a 76-float row raised an
//     illegal instruction on an H100), so the image's map is 4-D, (4, W/4,
//     H, B), and the window a box of (4, 20, 15, 1): rows of 16 bytes,
//     which land as 80-float rows.
//   - Compute from shared memory: 256 consumer threads, one pixel each,
//     with the per-pixel arithmetic of the first version in the same tap
//     order. The floor and the window index come from one add of 1.5 * 2^23
//     (the integer part lands in the mantissa) in place of two float->int
//     conversions, which run at a quarter of the FMA rate; the result is
//     floorf's wherever a corner can be on the image. A tap whose 2 x 2
//     block lies in the window reads it there; any other tap reads its
//     corners from global memory with the bounds test in float (offsets
//     are unbounded). ops/deform_cuda.fwd_window counts the two for given
//     offsets.
//   - Output: plain 4-byte stores; each warp writes 32 neighbouring pixels
//     of one row, one full 128-byte line, so wider stores would not lower
//     the transactions.
//   - Shapes that TMA cannot take: a tensor map needs 16-byte aligned
//     bases and row pitches (W % 4 == 0). Any other shape runs the same
//     kernel without the producer warp: all threads fill the same stage
//     layout with 4-byte cp.async copies (zero-filled off the image), two
//     stages deep, and compute from it as above.
//   - Tried on an H100 and dropped (PERF.md has the times): 8 x 64 tiles,
//     one block per SM and three stages (slower than the first version:
//     eight consumer warps per SM left the arithmetic's latency exposed);
//     a barrier per three taps so that compute starts on a tile's first
//     taps (slower: more TMA instructions and waits); a wider margin (the
//     global fallback is rare at the offsets tested).
//
// Positions are tested in float before any float->int conversion: offsets
// may be huge (tests use +-20 px scales) and converting an out-of-range
// float to int is undefined. The mask is zero-sum and signed; it is used
// as is.
//
// Row slabs (a spatially sharded forward, parallel/spatial.py): the output,
// the offsets and the mask may be a slab of Hs rows of the image, whose
// first row is image row y0 (``row0``), while x stays the whole image of H
// rows: output row h samples at image row y0 + h. The tiles walk the slab;
// each tile's window origin and positions are in image rows, and the image
// tensor map (and its zero fill off the image) stays on the whole image,
// so a slab's rows are the same bits as those rows of the whole output.
// y0 = 0 and Hs = H is the whole image, as before. Both modes take a slab
// (launch names deform_fwd_slab, deform_fwd_bf16_slab): the tile walk, the
// window origins, the TMA boxes and the cp.async fill are the same code
// for kBf16, which changes only a tap's value below.
//
// bf16-sampling mode (kBf16; the TPU kernel's sample_dtype='bfloat16',
// entry point jspsr_deform_fwd_bf16): each tap's row product rounds the
// four corners and the row weights (1 - ty, ty) to bf16, to nearest even,
// and sums in fp32: tmp_c = bf(v0c) bf(1-ty) + bf(v1c) bf(ty), then
// val = tmp_0 (1 - tx) + tmp_1 tx. A product of two bf16 values is exact
// in fp32, and the explicit _rn operations keep nvcc from contracting
// the column sum into an FMA, so val is the plain version's (ops/
// deform_conv.py) bit for bit. On the TPU the mode buys MXU rate; here it
// costs six conversions per tap and buys nothing: it exists so that a
// model trained with it computes the same function. The fp32 mode's code
// is untouched by the flag.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

using jspsr::aligned16;
using jspsr::encode_planes;
using jspsr::encode_tiled;
using jspsr::encode_window;
using jspsr::EncodeTiled;
using jspsr::mbar_arrive;
using jspsr::mbar_expect_tx;
using jspsr::mbar_init;
using jspsr::mbar_init_fence;
using jspsr::mbar_wait;
using jspsr::sm_count;
using jspsr::smem_u32;
using jspsr::tma_load_3d;
using jspsr::tma_load_4d;

constexpr int kTaps = 9;
constexpr int kTileH = 4;   // output rows per tile
constexpr int kTileW = 64;  // output columns per tile: a 256-byte TMA row
constexpr int kTilePx = kTileH * kTileW;
constexpr int kMargin = 4;  // window margin beyond the taps' reach
// the window: every corner of every tap with |offset| <= kMargin (the
// taps and the corner beside them reach 3 more), its left edge rounded
// down to a multiple of 4 columns (whole 16-byte groups: up to 3 more),
// its width rounded up to one
constexpr int kWinH = kTileH + 2 * kMargin + 3;
constexpr int kWinW = (kTileW + 2 * kMargin + 3 + 3 + 3) / 4 * 4;
constexpr int kConsumers = 256;
constexpr int kPxPerThread = kTilePx / kConsumers;
constexpr int kThreadsTma = kConsumers + 32;  // and one producer warp
constexpr int kStages = 2;  // either load path
constexpr int kBlocksPerSm = 3;  // what the shared memory allows
// one stage, in floats: offsets [18][4][64], mask [9][4][64], window
// [15][80]; each part starts on a 128-byte boundary
constexpr int kOffFloats = 2 * kTaps * kTilePx;
constexpr int kMaskFloats = kTaps * kTilePx;
constexpr int kWinFloats = kWinH * kWinW;
constexpr int kStageFloats = kOffFloats + kMaskFloats + kWinFloats;
constexpr int kStageBytes = (kStageFloats * 4 + 127) / 128 * 128;
constexpr int kBarBytes = 128;  // the mbarriers, ahead of the ring
constexpr int kSmem = 128 + kBarBytes + kStages * kStageBytes;
static_assert(kTilePx % kConsumers == 0, "pixels per thread");
static_assert(kOffFloats * 4 % 128 == 0 && kMaskFloats * 4 % 128 == 0,
              "stage parts on 128-byte boundaries");
static_assert(2 * kStages * 8 <= kBarBytes, "barriers");
static_assert(kBlocksPerSm * (kSmem + 1024) <= 233472,
              "shared memory per SM");
// the floor below: 1.5 * 2^23 puts a float's integer part in the mantissa
constexpr float kRound = 12582912.f;
constexpr int kRoundBits = 0x4B400000;

struct Params {
  const float* x;
  const float* weight;
  const float* bias;
  float* out;
  // the copy path reads the planes itself
  const float* offset;
  const float* mask;
  // h: the image's rows; hs: the slab's (output, offset and mask rows),
  // whose first is image row row0
  int h, w, pad, hs, row0, tiles_x, tiles_y, n_tiles;
};

// a tile of one image (its first row in the slab) and the origin of its
// window (in image rows)
struct Tile {
  int b, y0, x0, wy0, wx0;
};

__device__ __forceinline__ Tile tile_at(int t, const Params& p) {
  const int tx = t % p.tiles_x;
  t /= p.tiles_x;
  const int y0 = (t % p.tiles_y) * kTileH, x0 = tx * kTileW;
  // an arithmetic shift floors negative columns too
  return {t / p.tiles_y, y0, x0, y0 + p.row0 - p.pad - kMargin,
          ((x0 - p.pad - kMargin) >> 2) << 2};
}

// ``v`` rounded to bf16 (to nearest even) and back
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// this consumer thread's pixels of tile ``tl`` from one stage: the 9 taps
// added to ``acc`` in tap order
template <bool kBf16>
__device__ __forceinline__ void accumulate(float* acc, const float* st,
                                           const Tile& tl, const Params& p,
                                           const float* wt, int ctid) {
  const float* off = st;
  const float* msk = st + kOffFloats;
  const float* win = msk + kMaskFloats;
  const float* img = p.x + tl.b * (static_cast<int64_t>(p.h) * p.w);
  const float hmax = static_cast<float>(p.h - 1);
  const float wmax = static_cast<float>(p.w - 1);
#pragma unroll
  for (int k = 0; k < kPxPerThread; ++k) {
    const int q = ctid + k * kConsumers;
    const float fy =
        static_cast<float>(tl.y0 + p.row0 + q / kTileW - p.pad);
    const float fx = static_cast<float>(tl.x0 + q % kTileW - p.pad);
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const float py = (fy + static_cast<float>(t / 3)) +
                       off[(2 * t) * kTilePx + q];
      const float px = (fx + static_cast<float>(t % 3)) +
                       off[(2 * t + 1) * kTilePx + q];
      const float m = msk[t * kTilePx + q];
      // floor(py) and its offset in the window without a conversion:
      // exact for |py| < 2^22, which every position in the window is;
      // any other falls outside it (or is NaN) and is tested below as a
      // float, as floorf would leave it
      const float sy = __fadd_rn(py, kRound);
      const float sx = __fadd_rn(px, kRound);
      float y0f = __fsub_rn(sy, kRound);
      float x0f = __fsub_rn(sx, kRound);
      int ry = __float_as_int(sy) - (kRoundBits + tl.wy0);
      int rx = __float_as_int(sx) - (kRoundBits + tl.wx0);
      if (y0f > py) {
        y0f -= 1.f;
        --ry;
      }
      if (x0f > px) {
        x0f -= 1.f;
        --rx;
      }
      const float ty = py - y0f;
      const float tx = px - x0f;
      float v00 = 0.f, v01 = 0.f, v10 = 0.f, v11 = 0.f;
      if (static_cast<unsigned>(ry) <= static_cast<unsigned>(kWinH - 2) &&
          static_cast<unsigned>(rx) <= static_cast<unsigned>(kWinW - 2)) {
        // the 2 x 2 block lies in the window (zero off the image)
        const float* cell = win + ry * kWinW + rx;
        v00 = cell[0];
        v01 = cell[1];
        v10 = cell[kWinW];
        v11 = cell[kWinW + 1];
      } else if (y0f >= -1.f && y0f <= hmax && x0f >= -1.f && x0f <= wmax) {
        // some corner is on the image only if y0 in [-1, h-1] and x0 in
        // [-1, w-1]; inside that range the int conversion is exact and safe
        const int y0 = static_cast<int>(y0f);
        const int x0 = static_cast<int>(x0f);
        const bool vy0 = y0 >= 0, vy1 = y0 + 1 <= p.h - 1;
        const bool vx0 = x0 >= 0, vx1 = x0 + 1 <= p.w - 1;
        const float* row0 = img + static_cast<int64_t>(y0) * p.w;
        const float* row1 = row0 + p.w;
        if (vy0 && vx0) v00 = __ldg(row0 + x0);
        if (vy0 && vx1) v01 = __ldg(row0 + x0 + 1);
        if (vy1 && vx0) v10 = __ldg(row1 + x0);
        if (vy1 && vx1) v11 = __ldg(row1 + x0 + 1);
      }
      float val;
      if constexpr (kBf16) {
        const float r0 = bf16_round(1.f - ty), r1 = bf16_round(ty);
        const float tmp0 = __fadd_rn(__fmul_rn(bf16_round(v00), r0),
                                     __fmul_rn(bf16_round(v10), r1));
        const float tmp1 = __fadd_rn(__fmul_rn(bf16_round(v01), r0),
                                     __fmul_rn(bf16_round(v11), r1));
        val = __fadd_rn(__fmul_rn(tmp0, 1.f - tx), __fmul_rn(tmp1, tx));
      } else {
        val = (1.f - ty) * ((1.f - tx) * v00 + tx * v01) +
              ty * ((1.f - tx) * v10 + tx * v11);
      }
      acc[k] += wt[t] * (m * val);
    }
  }
}

__device__ __forceinline__ void store(const float* acc, const Tile& tl,
                                      const Params& p, int ctid) {
#pragma unroll
  for (int k = 0; k < kPxPerThread; ++k) {
    const int q = ctid + k * kConsumers;
    const int y = tl.y0 + q / kTileW, xo = tl.x0 + q % kTileW;
    if (y < p.hs && xo < p.w)
      p.out[(static_cast<int64_t>(tl.b) * p.hs + y) * p.w + xo] = acc[k];
  }
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// the copy path's fill of one stage: the layout TMA writes, element by
// element, zero off the image
__device__ __forceinline__ void copy_tile(float* st, const Tile& tl,
                                          const Params& p, int tid) {
  const int64_t hw = static_cast<int64_t>(p.h) * p.w;
  const int64_t hws = static_cast<int64_t>(p.hs) * p.w;  // a slab plane
  for (int e = tid; e < kStageFloats; e += kConsumers) {
    const float* src;
    int gy, gx, rows;
    if (e < kOffFloats + kMaskFloats) {
      const bool is_off = e < kOffFloats;
      const int e2 = is_off ? e : e - kOffFloats;
      const int plane = e2 / kTilePx, q = e2 % kTilePx;
      gy = tl.y0 + q / kTileW;
      gx = tl.x0 + q % kTileW;
      src = is_off ? p.offset + (tl.b * (2 * kTaps) + plane) * hws
                   : p.mask + (tl.b * kTaps + plane) * hws;
      rows = p.hs;
    } else {
      const int e2 = e - kOffFloats - kMaskFloats;
      gy = tl.wy0 + e2 / kWinW;
      gx = tl.wx0 + e2 % kWinW;
      src = p.x + tl.b * hw;
      rows = p.h;
    }
    const bool valid = gy >= 0 && gy < rows && gx >= 0 && gx < p.w;
    cp_async4(smem_u32(st + e),
              valid ? src + static_cast<int64_t>(gy) * p.w + gx : p.x, valid);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <bool kTma, bool kBf16>
__global__ void __launch_bounds__(kTma ? kThreadsTma : kConsumers,
                                  kBlocksPerSm)
deform_fwd_kernel(const __grid_constant__ CUtensorMap off_map,
                  const __grid_constant__ CUtensorMap mask_map,
                  const __grid_constant__ CUtensorMap x_map, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  unsigned char* smem = smem_raw + (base - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [kStages]
  uint64_t* empty = full + kStages;                    // [kStages]
  float* ring = reinterpret_cast<float*>(smem + kBarBytes);
  constexpr int kStageStride = kStageBytes / 4;  // floats

  const int tid = threadIdx.x;
  const int my_tiles =
      static_cast<int>(blockIdx.x) < p.n_tiles
          ? (p.n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
          : 0;

  if constexpr (kTma) {
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(smem_u32(full + s), 1);
        mbar_init(smem_u32(empty + s), kConsumers / 32);
      }
      mbar_init_fence();
    }
    __syncthreads();
    if (tid >= kConsumers) {  // the producer warp: one thread issues
      if (tid != kConsumers) return;
      constexpr uint32_t kTx = kStageFloats * 4;
      for (int i = 0; i < my_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages)
          mbar_wait(smem_u32(empty + s), (i / kStages - 1) & 1);
        const Tile tl = tile_at(blockIdx.x + i * gridDim.x, p);
        const uint32_t bar = smem_u32(full + s);
        const uint32_t dst = smem_u32(ring + s * kStageStride);
        mbar_expect_tx(bar, kTx);
        tma_load_3d(dst, &off_map, tl.x0, tl.y0, tl.b * 2 * kTaps, bar);
        tma_load_3d(dst + kOffFloats * 4, &mask_map, tl.x0, tl.y0,
                    tl.b * kTaps, bar);
        tma_load_4d(dst + (kOffFloats + kMaskFloats) * 4, &x_map, 0,
                    tl.wx0 / 4, tl.wy0, tl.b, bar);
      }
      return;
    }
  }

  float wt[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) wt[t] = __ldg(p.weight + t);
  const float bias = __ldg(p.bias);

  for (int i = 0; i < my_tiles; ++i) {
    const Tile tl = tile_at(blockIdx.x + i * gridDim.x, p);
    float acc[kPxPerThread];
#pragma unroll
    for (int k = 0; k < kPxPerThread; ++k) acc[k] = bias;
    if constexpr (kTma) {
      const int s = i % kStages;
      mbar_wait(smem_u32(full + s), (i / kStages) & 1);
      accumulate<kBf16>(acc, ring + s * kStageStride, tl, p, wt, tid);
      // every lane's reads of the stage are done before lane 0 frees it
      __syncwarp();
      if (tid % 32 == 0) mbar_arrive(smem_u32(empty + s));
    } else {
      if (i == 0) copy_tile(ring, tl, p, tid);
      if (i + 1 < my_tiles) {
        copy_tile(ring + ((i + 1) % kStages) * kStageStride,
                  tile_at(blockIdx.x + (i + 1) * gridDim.x, p), p, tid);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncthreads();
      accumulate<kBf16>(acc, ring + (i % kStages) * kStageStride, tl, p, wt,
                        tid);
      // the stage is refilled two tiles on
      __syncthreads();
    }
    store(acc, tl, p, tid);
  }
}

bool use_tma(const void* x, const void* offset, const void* mask, int w) {
  return w % 4 == 0 && aligned16(x) && aligned16(offset) && aligned16(mask);
}

// the kernel's dynamic shared-memory allowance, set once per device, and
// how many of its blocks one SM holds
template <bool kTma, bool kBf16>
cudaError_t prepare(int threads, int smem, int* blocks) {
  static int resident[64] = {};  // per device, 0 until asked
  return jspsr::resident_blocks(deform_fwd_kernel<kTma, kBf16>, threads,
                                smem, resident, blocks);
}

}  // namespace

// K1's tile and window, for the host's count of where its corners come
// from (ops/deform_cuda.fwd_window): tile rows, tile columns, margin,
// window rows, window columns.
extern "C" void jspsr_deform_fwd_window(int* out) {
  out[0] = kTileH;
  out[1] = kTileW;
  out[2] = kMargin;
  out[3] = kWinH;
  out[4] = kWinW;
}

// 1 where these tensors take the TMA path, 0 where they take the copy path.
extern "C" int jspsr_deform_fwd_path(const void* x, const void* offset,
                                     const void* mask, int w) {
  return use_tma(x, offset, mask, w) ? 1 : 0;
}

namespace {

// The launch of either mode. All tensors are contiguous fp32 on the
// current device: x (B,1,H,W), offset (B,18,Hs,W), mask (B,9,Hs,W), weight
// (9,), bias (1,), out (B,1,Hs,W), the slab of image rows [y0, y0 + Hs).
// Launches on ``stream`` without synchronising and returns
// cudaGetLastError(), or cudaErrorNotSupported where libcuda has no
// tensor-map encoder and the shape needs one.
template <bool kBf16>
int launch(const float* x, const float* offset, const float* mask,
           const float* weight, const float* bias, float* out, int64_t batch,
           int h, int w, int pad, int hs, int y0, void* stream) {
  if (y0 < 0 || hs < 0 || y0 > h - hs) return cudaErrorInvalidValue;
  if (batch == 0 || hs == 0 || w == 0) return 0;
  // the floor in accumulate() is exact below 2^22
  if (h >= (1 << 22) || w >= (1 << 22)) return cudaErrorInvalidValue;
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int tiles_y = (hs + kTileH - 1) / kTileH;
  const int64_t n_tiles = batch * tiles_x * tiles_y;
  if (n_tiles >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms == 0) return static_cast<int>(cudaGetLastError());
  const Params p{x, weight, bias, out, offset, mask, h, w, pad, hs, y0,
                 tiles_x, tiles_y, static_cast<int>(n_tiles)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap maps[3] = {};
  const bool tma = use_tma(x, offset, mask, w);
  int blocks = 0;
  const cudaError_t err =
      tma ? prepare<true, kBf16>(kThreadsTma, kSmem, &blocks)
          : prepare<false, kBf16>(kConsumers, kSmem, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: every block resident at once, none without a tile
  const int64_t slots = static_cast<int64_t>(sms) * blocks;
  const int grid = static_cast<int>(n_tiles < slots ? n_tiles : slots);
  if (tma) {
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    if (encode_planes(encode, &maps[0], offset, w, hs, batch * 2 * kTaps,
                      kTileW, kTileH, 2 * kTaps) != CUDA_SUCCESS ||
        encode_planes(encode, &maps[1], mask, w, hs, batch * kTaps, kTileW,
                      kTileH, kTaps) != CUDA_SUCCESS ||
        encode_window(encode, &maps[2], x, w, h, batch, kWinH, kWinW) !=
            CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
    deform_fwd_kernel<true, kBf16><<<grid, kThreadsTma, kSmem, s>>>(
        maps[0], maps[1], maps[2], p);
  } else {
    deform_fwd_kernel<false, kBf16><<<grid, kConsumers, kSmem, s>>>(
        maps[0], maps[1], maps[2], p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound from Python with ctypes: the fp32 mode and
// the bf16-sampling mode, each as ``launch`` above (hs = h, y0 = 0: the
// whole image).
extern "C" int jspsr_deform_fwd(const float* x, const float* offset,
                                const float* mask, const float* weight,
                                const float* bias, float* out, int64_t batch,
                                int h, int w, int pad, int hs, int y0,
                                void* stream) {
  return launch<false>(x, offset, mask, weight, bias, out, batch, h, w, pad,
                       hs, y0, stream);
}

extern "C" int jspsr_deform_fwd_bf16(const float* x, const float* offset,
                                     const float* mask, const float* weight,
                                     const float* bias, float* out,
                                     int64_t batch, int h, int w, int pad,
                                     int hs, int y0, void* stream) {
  return launch<true>(x, offset, mask, weight, bias, out, batch, h, w, pad,
                      hs, y0, stream);
}
