// Modulated deformable convolution backward: one input and one output
// channel, 3x3 kernel, stride 1, dilation 1. The forward is deform_fwd.cu:
//
//   out[b,y,x] = bias + sum_t w[t] * m[b,t,y,x] * val_t
//   val_t = (1-ty)((1-tx) v00 + tx v01) + ty((1-tx) v10 + tx v11)
//
// with (v00, v01, v10, v11) the four corners around (py, px) and ty, tx the
// fractional parts of the position. Given g = dL/dout, per pixel and tap:
//
//   d_mask[b,t]       = g w_t val_t
//   d_offset[b,2t]    = g w_t m_t [(1-tx)(v10-v00) + tx(v11-v01)]   (dy)
//   d_offset[b,2t+1]  = g w_t m_t [(1-ty)(v01-v00) + ty(v11-v10)]   (dx)
//   d_weight[t]       = sum over batch and pixels of g m_t val_t
//
// and, in K3 only, the input gradient: every tap scatters
// g w_t m_t times its four bilinear weights onto the corners it read,
//
//   d_x[b, y0+i, x0+j] += g w_t m_t (i ? ty : 1-ty) (j ? tx : 1-tx).
//
// The offset derivative is the floor-based one: the corners are fixed by
// floor(p) and only the fractional part moves, so at an integer position
// (ty = 0, the zero-offset init of the SPN generator and of NLSPN) d/dy is
// the forward difference v10 - v00, never the tent subgradient 0 that would
// freeze offset learning. Off-image corners are 0 in the forward and
// receive nothing in d_x.
//
// Replaces: jspsr_tpu/ops/pallas_deform.py::_bwd_kernel, need_dx=False
// (deform_bwd_kernel, K2: the SPN head detaches the DEM) and need_dx=True
// (deform_bwd_dx_kernel, K3: NLSPN propagates a feature that needs its
// gradient). The TPU kernel builds the corner one-hots and their
// differences (oy1 - oy0, ox1 - ox0) as (H, P) matrices for the MXU, and
// forms d_x as one more matmul per tap into an (H, W) accumulator that a
// sequential ("arbitrary") row-block grid axis carries from block to
// block. Here the corners are gathered directly, as in deform_fwd.cu, and
// d_x is a scatter.
//
// K2 (deform_bwd_kernel) is one launch that keeps the bytes in flight:
//   - Persistent grid, as K1's (deform_fwd.cu): min(tiles, SMs x resident
//     blocks) blocks, the resident count read once per device from
//     cudaOccupancyMaxActiveBlocksPerMultiprocessor (three: the shared
//     memory), each walking output tiles of 4 rows x 64 columns of one
//     image with a fixed stride (blockIdx.x + i * gridDim.x).
//   - TMA (tma.cuh): one producer thread per block loads each tile's 18
//     offset, 9 mask and 1 gradient planes and a window of the image (the
//     tile plus a margin of 4 px, its left edge on a multiple of 4 columns:
//     15 x 80 floats, zero off the image) into a ring of 2 stages of 32.8
//     KB on full and empty mbarriers, so the next tiles' loads overlap this
//     tile's arithmetic. A tap whose 2 x 2 block of corners lies in the
//     window reads it there; any other reads its corners from global memory
//     with the bounds test in float, so no corner read waits on a global
//     offset read. Shapes a tensor map cannot take (W % 4 != 0, a base not
//     on 16 bytes) fill the same stages with 4-byte cp.async copies, two
//     deep, without the producer warp: each thread its pixel of the 28
//     planes (one index computation for all 28: an index per element made
//     the copies, not the arithmetic, the bound) and a share of the window.
//   - 256 consumer threads, one pixel of the tile each, run pixel_backward
//     from the stage and write d_offset and d_mask straight to global
//     memory: each warp's store is one full 128-byte line of a plane.
//   - d_weight and d_bias are finished in the kernel, in a fixed order and
//     without float atomics: each consumer carries its pixels' 9 g m val
//     sums in registers across its tiles, and one warp (the producer,
//     which waits for each tile's planes anyway) sums the tiles' g in
//     double; the block sums them in double (warp shuffles, then the warps
//     in order) into one row of 10, writes
//     it to the caller's scratch, fences, and takes a ticket on a counter;
//     the block whose ticket is last sums the rows in block order (one
//     warp per value, in double), writes d_weight and d_bias and sets the
//     counter back to 0. The grid is the same on every call on one card,
//     so each sum is, bit for bit.
//
// Positions are tested against the image in float before any float->int
// conversion, exactly as in the forward.
//
// K2's bf16-sampling mode (kBf16; the TPU kernel's sample_dtype=
// 'bfloat16' with need_dx=False, entry point jspsr_deform_bwd_bf16): the
// forward's rounded row products (deform_fwd.cu), tmp_c = bf(v0c)
// bf(1-ty) + bf(v1c) bf(ty), give val = tmp_0 (1 - tx) + tmp_1 tx for
// d_mask and d_weight and d/dx = tmp_1 - tmp_0; d/dy takes the rounded
// corners against the exact row derivative, (1 - tx)(bf(v10) - bf(v00))
// + tx (bf(v11) - bf(v01)), as the TPU kernel's one-hot difference
// matmul does. Explicit _rn operations keep each rounding the plain
// version's.
//
// K2 on a row slab (a spatially sharded backward, parallel/spatial.py):
// the offsets, the mask, g and their gradients may be a slab of Hs rows of
// the image, whose first is image row y0 (``row0``), while x stays the
// whole image: slab row h is image row y0 + h, so d_offset and d_mask are
// those rows of the whole image's, bit for bit, and d_weight and d_bias
// are the slab's share (the caller's gradient reduction sums the slabs').
// y0 = 0 and Hs = H is the whole image, as before. Both modes take a slab
// (deform_bwd_slab, deform_bwd_bf16_slab): the slab planes and row0 are
// the same code for kBf16, which changes only pixel_backward's values.
//
// K3 (deform_bwd_dx_kernel) is K2 with the input gradient: K2's
// persistent grid, 4 x 64 tiles, ring, pixel code and per-block rows of
// d_weight and d_bias, in ONE launch that also scatters d_x. Every
// scatter needs its image's fixed-point scale (below), which needs all of
// the image's (or slab's) pixels summed first, so the launch runs in three
// phases split by two grid-wide barriers:
//   1. every block zeroes its share of the d_x accumulator and of its
//      scatter window, and the blocks sum the images' L1 bounds in chunks
//      (the producer has already issued its first two tiles' loads, which
//      land meanwhile);
//   2. the tiles, as K2's, each consumer also scattering its pixel's d_x
//      contributions; the tile's scale comes with its stage (the producer,
//      or warp 0 on the copy path, sums the image's chunks into L_b);
//   3. the accumulator back to fp32 over the whole images, and block 0
//      sums the blocks' rows into d_weight and d_bias (no ticket counter:
//      the barrier has ordered the rows).
// The barrier is cooperative_groups' grid.sync() in a cooperative launch
// (cudaLaunchCooperativeKernel), whose grid the runtime starts only when
// every block of it can be resident at once, so the barrier never waits on
// a block that another stream's kernels keep from starting; a refused
// launch raises, nothing falls back. The grid is K2's, min(tiles, SMs x
// resident blocks), the resident count read from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, as a cooperative launch
// requires. The barrier also orders the zero fill before every scatter and
// every scatter before the conversion. The call puts one kernel on the card:
// no memset, no reduction, no second launch.
//
// K3's scatter goes through a shared-memory window first. Around its 4 x
// 64 tile a block keeps a window of (4 + 2M) x (64 + 2M) cells, M = 4. A
// corner inside the window is added there (a shared-memory atomic); one
// outside it (an offset beyond about M - 1 px from the tile, or a tile at
// the image edge) goes to a global atomic into the d_x accumulator;
// off-image corners receive nothing. After a barrier of the consumers
// every in-image window cell that is not 0 is flushed with one global
// atomic and set back to 0 for the block's next tile: windows of
// neighbouring tiles overlap, so the flush stays atomic. At NLSPN's
// offsets of about 1.5 px that takes the global atomics from up to 36 per
// pixel (4 corners x 9 taps) to at most 864 / 256 = 3.4 flushes plus the
// few corners that leave the window (ops/deform_cuda.py::dx_atomics
// counts both from the offsets: 2.9 per pixel at 2 x 128^2). Blocks run in
// no order on this card, so nothing like the TPU's carried accumulator
// exists; an inverse gather over a fixed window is not exact because
// offsets are unbounded (tests use 20 px).
//
// d_x is bitwise reproducible: it is summed in fixed point. Every
// contribution v becomes the integer round(v * 2^k) (__float2ll_rn; the
// scaling by a power of two is exact), the window cells and the global
// accumulator hold 64-bit integers, and integer addition is associative,
// so neither the order in which the atomics land nor the tile shape
// matters. Phase 3 turns the accumulator back into fp32, acc * 2^-k, one
// rounding. k is chosen per image on the device, with no host sync, from
// the image's L1 norm of contributions,
//   L_b = sum over its pixels p of |g_p| * sum_t |w_t| |m_{p,t}|,
// which phase 1 sums in double in a fixed order: chunks of kBoundChunk
// pixels, each thread its strided pixels in turn, then block_sum's shuffle
// tree into one partial per chunk; one warp then sums an image's partials
// (each lane its strided share in order, then a shuffle tree). So L_b, and
// k, are the same on every run; any other order may move k, and with it
// every bit of d_x. A tap's four corner weights are in
// [0, 1] and sum to 1, so the magnitudes of all of an image's
// contributions sum to at most L_b, and k is the largest with
//   L_b * 2^k <= 2^61:
// no partial sum can pass 2^62, whatever the order, roundings included
// (at most 2^-1 each, 36 per pixel). The resolution is absolute, 2^-k <
// 2^-60 L_b: a pixel that receives n terms whose magnitudes sum to A is
// off by at most n 2^-61 L_b, so by at most 2^-55.8 L_b / A of A (n <=
// 36), below 1e-5 while A is above 2^-39 L_b. A typical pixel's A is about
// L_b / (H*W) (2^-14 L_b at 128^2); a few entries of g 10^6 times the rest
// shrink that share by about 2^20, to about 2^-34. chip_smoke.py phase 3c
// checks such a g. A bound from the call's maxima, 36 B*H*W max|g| max|w|
// max|m|, is 36 B max|g| max|w| max|m| / mean(|g| sum_t |w_t m_t|) times
// L_b (more than 2^20 at 16 x 128^2 with such a g) and misses 1e-5 of the
// magnitude sum there. One image's k does not depend on the other images
// of the batch. An L_b that is NaN, inf or beyond fp32's range (a NaN or
// inf among that image's g, w or m) makes phase 3 write NaN over the
// image, as a float sum would have given NaN or inf; a NaN offset, as in
// the forward, reads no corner and scatters nothing.
//
// On sm_90a a 64-bit shared-memory atomicAdd compiles to a compare-and-
// swap loop (ATOMS.CAST.SPIN.64), only the 32-bit one to a native add
// (ATOMS.ADD). So a window cell is two 32-bit words, lo and hi: a
// contribution q adds its low word to lo, learns from the old value that
// atomicAdd returns whether lo wrapped, and adds its high word plus that
// carry to hi. Each wrap is counted by the one add that made it, so hi:lo
// ends as the exact 64-bit sum mod 2^64, in any order; the flush joins
// the two words into one global 64-bit add (RED.E.ADD.64, native).
// Contributions that round to 0 (the corners of weight 0 at integer
// positions) are skipped.
//
// Bound on this card: bytes, or the atomics. Each pixel reads 18 offsets
// (72 B), 9 mask values (36 B), g (4 B) and its image neighbourhood (4 B
// new per pixel; the re-reads of neighbours hit shared memory or L1/L2),
// and writes 18 offset gradients (72 B) and 9 mask gradients (36 B): about
// 224 B against about 300 FLOP; d_x adds phase 1's second read of g and
// the mask (40 B), its accumulator's zero fill (8 B), its read and its
// fp32 write-back (12 B). K3's up to 36 corner contributions per pixel go
// to pairs of native 32-bit shared-memory atomics; about 3 per pixel reach
// L2. Positions and corners are recomputed from the inputs rather than
// saved by the forward (saving them would cost more bytes than the
// arithmetic costs time). On a small call (a row slab of 16k pixels) the
// launch and the two grid barriers, a few microseconds each, are most of
// the time.
//
// K3 on a row slab (deform_bwd_dx_slab, deform_bwd_dx_bf16_slab; NLSPN's
// propagation under a spatial sharding, and an SPN head whose DEM needs
// its gradient): K2's slab planes and row0, while x and the d_x
// accumulator stay the whole image. The tiles walk the slab, and their
// output rows, window origins and global-atomic fallback are image rows
// row0 + h: a slab scatters its own contributions into the whole image's
// d_x. Phase 1 sums L_b over the slab's own pixels, which bounds every
// contribution the slab scatters, so the fixed point stays safe; phase 3
// converts the whole image once, with that slab's scale. d_offset and
// d_mask come from K2's per-pixel code, so they are those rows of the
// whole image's K3 output, bit for bit. The slabs' d_x are then summed in
// fp32, in space order, by the caller (parallel/spatial.py's row gather),
// not in the fixed point: each slab's own scale makes that sum
// deterministic but not bit-equal to one whole-image launch.
//
// K3's bf16-sampling mode (kBf16 of deform_bwd_dx_kernel; the TPU
// kernel's sample_dtype='bfloat16' with need_dx=True, entry point
// jspsr_deform_bwd_dx_bf16): the TPU kernel rounds only its two image
// products (pallas_deform.py:184-188,213,224) and keeps wy, wx and g w m in
// fp32 for the d_x matmul (:227-232), so d_offset, d_mask and d_weight are
// K2's bf16 mode's and d_x is K3's fp32 mode's, bounds and fixed point as
// they are. No shipped model reaches it (NLSPN samples in fp32, the SPN
// head detaches the DEM); the op's autograd does.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cfloat>
#include <type_traits>

#include "tma.cuh"

namespace {

constexpr int kTaps = 9;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// d_x's fixed point: an image's L1 norm of contributions scales to at most
// 2^kFixedBits, and the pixels that sum it into one partial
constexpr int kFixedBits = 61;
constexpr int kBoundChunk = kThreads * 4;

// K2's tile, window and ring (K1's: deform_fwd.cu), which K3 shares
namespace k2 {
constexpr int kTileH = 4;   // output rows per tile
constexpr int kTileW = 64;  // output columns per tile: a 256-byte TMA row
constexpr int kTilePx = kTileH * kTileW;
constexpr int kMargin = 4;  // window margin beyond the taps' reach
// every corner of every tap with |offset| <= kMargin, the left edge on a
// multiple of 4 columns, the width a whole number of 16-byte groups
constexpr int kWinH = kTileH + 2 * kMargin + 3;
constexpr int kWinW = (kTileW + 2 * kMargin + 3 + 3 + 3) / 4 * 4;
constexpr int kConsumers = kThreads;         // one pixel of the tile each
constexpr int kThreadsTma = kConsumers + 32;  // and one producer warp
constexpr int kStages = 2;
constexpr int kBlocksPerSm = 3;  // what the shared memory allows
// one stage, in floats: offsets [18][4][64], mask [9][4][64], g [4][64],
// window [15][80]; the planes (offsets, mask, g) are 28 consecutive planes
// of a tile, each part starts on a 128-byte boundary
constexpr int kOffFloats = 2 * kTaps * kTilePx;
constexpr int kMaskFloats = kTaps * kTilePx;
constexpr int kPlaneFloats = kOffFloats + kMaskFloats + kTilePx;
constexpr int kWinFloats = kWinH * kWinW;
constexpr int kStageFloats = kPlaneFloats + kWinFloats;
constexpr int kStageBytes = (kStageFloats * 4 + 127) / 128 * 128;
constexpr int kBarBytes = 128;  // the mbarriers, ahead of the ring
constexpr int kSmem = 128 + kBarBytes + kStages * kStageBytes;
constexpr int kSums = kTaps + 1;  // a block's row: d_weight's 9, d_bias
static_assert(kTilePx == kConsumers, "one pixel per consumer");
static_assert(kPlaneFloats * 4 % 128 == 0, "window on a 128-byte boundary");
static_assert(2 * kStages * 8 <= kBarBytes, "barriers");
static_assert(kBlocksPerSm * (kSmem + 1024) <= 233472 &&
                  (kBlocksPerSm + 1) * (kSmem + 1024) > 233472,
              "the shared memory holds exactly kBlocksPerSm blocks per SM");
}  // namespace k2

// K3's scatter window around K2's tile (ops/deform_cuda.py's DX_TILE and
// DX_MARGIN, checked against jspsr_deform_bwd_dx_window when the library
// is loaded): two 32-bit words per cell, after K2's ring; each stage's
// fixed-point scale sits behind the mbarriers
namespace k3 {
constexpr int kMargin = 4;
constexpr int kWinH = k2::kTileH + 2 * kMargin;
constexpr int kWinW = k2::kTileW + 2 * kMargin;
constexpr int kCells = kWinH * kWinW;
constexpr int kScaleOff = 2 * k2::kStages * 8;
constexpr int kSmem = k2::kSmem + 2 * kCells * 4;
static_assert(kScaleOff + k2::kStages * 4 <= k2::kBarBytes, "scales");
static_assert(k2::kBlocksPerSm * (kSmem + 1024) <= 233472,
              "the window keeps K2's blocks per SM");
}  // namespace k3

int64_t k3_chunks(int64_t hw) { return (hw + kBoundChunk - 1) / kBoundChunk; }

// The scale of one image's fixed point: 2^k as a float (to scale a
// contribution) and 2^-k as a double (to scale the sum back); ``ok`` is
// false when the image's L1 bound is NaN, inf or beyond fp32's range.
struct FixedScale {
  float scale;
  double inv;
  bool ok;
};

__device__ __forceinline__ FixedScale fixed_scale(double bound) {
  FixedScale s{0.f, 0.0, false};
  if (!(bound <= static_cast<double>(FLT_MAX))) return s;  // NaN, inf, huge
  // 2^k must be a float: k <= 126, so an image whose bound is below about
  // 2^-65 keeps fewer than 2^61 units (nothing to bound: every
  // contribution is 0)
  int k = 126;
  if (bound > 0.0) {
    int e;
    frexp(bound, &e);  // bound < 2^e, e <= 128: k >= -67
    k = min(kFixedBits - e, 126);
  }
  s.scale = ldexpf(1.f, k);
  s.inv = ldexp(1.0, -k);
  s.ok = true;
  return s;
}

// K2 scatters nothing
struct NoScatter {};

// K3: one corner's contribution in fixed point, into the block's window
// (hi:lo word pairs) where the corner lies inside it, else straight to the
// d_x accumulator (two's-complement integers added as unsigned: the same
// bits as a signed sum). One corner at a time: issuing a tap's four
// low-word adds before their high words, to overlap the round trips, held
// registers that spilled and made K3 slower on an H100.
struct WindowScatter {
  unsigned* lo;              // [k3::kCells], shared
  unsigned* hi;              // [k3::kCells], shared
  unsigned long long* dimg;  // this image's d_x accumulator
  float scale;
  int wy0, wx0, w;
  __device__ __forceinline__ void operator()(int yc, int xc, float v) const {
    const unsigned long long q =
        static_cast<unsigned long long>(__float2ll_rn(v * scale));
    if (q == 0ull) return;
    const int ry = yc - wy0, rx = xc - wx0;
    if (static_cast<unsigned>(ry) < k3::kWinH &&
        static_cast<unsigned>(rx) < k3::kWinW) {
      const int c = ry * k3::kWinW + rx;
      const unsigned ql = static_cast<unsigned>(q);
      const unsigned old = atomicAdd(lo + c, ql);
      const unsigned carry = (old + ql < old) ? 1u : 0u;
      atomicAdd(hi + c, static_cast<unsigned>(q >> 32) + carry);
    } else {
      atomicAdd(dimg + static_cast<int64_t>(yc) * w + xc, q);
    }
  }
};

// ``v`` rounded to bf16 (to nearest even) and back
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// K2's window of the image in shared memory around its tile: k2::kWinH x
// k2::kWinW cells from image row wy0, column wx0 (floats: a corner's floor
// is compared with them before any conversion), zero off the image
struct Window {
  const float* cells;
  float wy0, wx0;
};

// One output pixel's 9 taps: writes d_offset and d_mask, writes g m_t
// val_t to dw and hands every in-bounds corner's share of d_x to
// ``scatter`` (K3's; K2's NoScatter takes nothing); with kBf16 the
// bf16-sampling mode's values and derivatives. ``img`` is the pixel's
// image; ``off`` and ``msk`` point at the pixel in channel 0 of planes
// ``in_plane`` floats apart, ``doff`` and ``dmsk`` of planes ``out_plane``
// apart. A tap whose 2 x 2 block of corners lies in ``win`` reads it
// there, the same floats as from the image; any other tap reads its
// corners from ``img``.
template <bool kBf16, class Scatter>
__device__ __forceinline__ void pixel_backward(
    const float* __restrict__ img, const Window& win,
    const float* __restrict__ off, const float* __restrict__ msk,
    int64_t in_plane, const float* __restrict__ weight,
    float* __restrict__ doff, float* __restrict__ dmsk, int64_t out_plane,
    float g, int y, int xo, int h, int w, int pad, float (&dw)[kTaps],
    const Scatter& scatter) {
  constexpr bool kScatter = !std::is_same<Scatter, NoScatter>::value;
  const float hmax = static_cast<float>(h - 1);
  const float wmax = static_cast<float>(w - 1);
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const float py =
        static_cast<float>(y - pad + t / 3) + off[(2 * t) * in_plane];
    const float px =
        static_cast<float>(xo - pad + t % 3) + off[(2 * t + 1) * in_plane];
    const float m = msk[t * in_plane];
    const float y0f = floorf(py);
    const float x0f = floorf(px);
    const float ty = py - y0f;
    const float tx = px - x0f;
    const float gw = g * __ldg(weight + t);
    const float gwm = gw * m;
    float v00 = 0.f, v01 = 0.f, v10 = 0.f, v11 = 0.f;
    bool in_window = false;
    // exact: both are integers, and a NaN or a far position fails
    const float ry = y0f - win.wy0, rx = x0f - win.wx0;
    if (ry >= 0.f && ry <= static_cast<float>(k2::kWinH - 2) && rx >= 0.f &&
        rx <= static_cast<float>(k2::kWinW - 2)) {
      const float* cell = win.cells + static_cast<int>(ry) * k2::kWinW +
                          static_cast<int>(rx);
      v00 = cell[0];
      v01 = cell[1];
      v10 = cell[k2::kWinW];
      v11 = cell[k2::kWinW + 1];
      in_window = true;
    }
    // some corner lies on the image
    const bool near =
        y0f >= -1.f && y0f <= hmax && x0f >= -1.f && x0f <= wmax;
    if (!in_window && near) {
      const int y0 = static_cast<int>(y0f);
      const int x0 = static_cast<int>(x0f);
      const bool vy0 = y0 >= 0, vy1 = y0 + 1 <= h - 1;
      const bool vx0 = x0 >= 0, vx1 = x0 + 1 <= w - 1;
      const int64_t r0 = static_cast<int64_t>(y0) * w;
      const int64_t r1 = r0 + w;
      if (vy0 && vx0) v00 = __ldg(img + r0 + x0);
      if (vy0 && vx1) v01 = __ldg(img + r0 + x0 + 1);
      if (vy1 && vx0) v10 = __ldg(img + r1 + x0);
      if (vy1 && vx1) v11 = __ldg(img + r1 + x0 + 1);
    }
    if constexpr (kScatter) {
      if (near) {
        const int y0 = static_cast<int>(y0f);
        const int x0 = static_cast<int>(x0f);
        const bool vy0 = y0 >= 0, vy1 = y0 + 1 <= h - 1;
        const bool vx0 = x0 >= 0, vx1 = x0 + 1 <= w - 1;
        const float gy0 = gwm * (1.f - ty), gy1 = gwm * ty;
        if (vy0 && vx0) scatter(y0, x0, gy0 * (1.f - tx));
        if (vy0 && vx1) scatter(y0, x0 + 1, gy0 * tx);
        if (vy1 && vx0) scatter(y0 + 1, x0, gy1 * (1.f - tx));
        if (vy1 && vx1) scatter(y0 + 1, x0 + 1, gy1 * tx);
      }
    }
    if constexpr (kBf16) {
      const float b00 = bf16_round(v00), b01 = bf16_round(v01);
      const float b10 = bf16_round(v10), b11 = bf16_round(v11);
      const float r0 = bf16_round(1.f - ty), r1 = bf16_round(ty);
      const float tmp0 = __fadd_rn(__fmul_rn(b00, r0), __fmul_rn(b10, r1));
      const float tmp1 = __fadd_rn(__fmul_rn(b01, r0), __fmul_rn(b11, r1));
      const float cx = 1.f - tx;
      const float val = __fadd_rn(__fmul_rn(tmp0, cx), __fmul_rn(tmp1, tx));
      dmsk[t * out_plane] = __fmul_rn(gw, val);
      doff[(2 * t) * out_plane] = __fmul_rn(
          gwm, __fadd_rn(__fmul_rn(__fsub_rn(b10, b00), cx),
                         __fmul_rn(__fsub_rn(b11, b01), tx)));
      doff[(2 * t + 1) * out_plane] = __fmul_rn(gwm, __fsub_rn(tmp1, tmp0));
      dw[t] = __fmul_rn(g * m, val);
    } else {
      // each a * b + c * d as fma(a, b, c * d), written out: left to the
      // compiler, the contraction changed with the code around it (K3's
      // scatter made it fma(c, d, a * b)), and with it the bits of
      // d_offset and d_mask, which K2 and K3 share
      const float cx = 1.f - tx, cy = 1.f - ty;
      const float top = __fmaf_rn(cx, v00, __fmul_rn(tx, v01));
      const float bot = __fmaf_rn(cx, v10, __fmul_rn(tx, v11));
      const float val = __fmaf_rn(cy, top, __fmul_rn(ty, bot));
      dmsk[t * out_plane] = gw * val;
      doff[(2 * t) * out_plane] = gwm * (bot - top);
      doff[(2 * t + 1) * out_plane] = gwm * __fmaf_rn(
          cy, v01 - v00, __fmul_rn(ty, v11 - v10));
      dw[t] = g * m * val;
    }
  }
}

// The launch's inputs and outputs (contiguous fp32; offset, mask, g,
// d_offset and d_mask the slab of hs rows whose first is image row row0,
// x the whole image), and its finish's scratch: one row of k2::kSums
// doubles per block; K2's ticket counter, 0 at the launch and left at 0;
// K3's whole-image d_x and its scratch: the fixed-point accumulator (B*H*W),
// the images' L1 bounds (B) and phase 1's partials (``chunks`` per image)
struct K2Params {
  const float* x;
  const float* offset;
  const float* mask;
  const float* weight;
  const float* grad_out;
  float* d_offset;
  float* d_mask;
  float* d_weight;
  float* d_bias;
  double* rows;
  unsigned* counter;
  int h, w, pad, hs, row0, tiles_x, tiles_y, n_tiles;
  float* d_x;
  unsigned long long* acc;
  double* bound;
  double* part;
  int64_t batch, chunks;
};

// a tile of one image (its first row in the slab) and the origin of its
// window (in image rows; an arithmetic shift floors negative columns too)
struct K2Tile {
  int b, y0, x0, wy0, wx0;
};

__device__ __forceinline__ K2Tile k2_tile(int t, const K2Params& p) {
  const int tx = t % p.tiles_x;
  t /= p.tiles_x;
  const int y0 = (t % p.tiles_y) * k2::kTileH, x0 = tx * k2::kTileW;
  return {t / p.tiles_y, y0, x0, y0 + p.row0 - p.pad - k2::kMargin,
          ((x0 - p.pad - k2::kMargin) >> 2) << 2};
}

// this consumer thread's pixel of tile ``tl`` from one stage: its
// d_offset and d_mask written, its g m_t val_t added to dw, its d_x
// contributions handed to ``scatter``
template <bool kBf16, class Scatter>
__device__ __forceinline__ void k2_pixel(const float* st, const K2Tile& tl,
                                         const K2Params& p, int ctid,
                                         float (&dw)[kTaps],
                                         const Scatter& scatter) {
  const int y = tl.y0 + ctid / k2::kTileW, xo = tl.x0 + ctid % k2::kTileW;
  if (y >= p.hs || xo >= p.w) return;
  const int64_t hws = static_cast<int64_t>(p.hs) * p.w;  // a slab plane
  const int64_t q = static_cast<int64_t>(y) * p.w + xo;
  float px_dw[kTaps];
  pixel_backward<kBf16>(
      p.x + tl.b * (static_cast<int64_t>(p.h) * p.w),
      Window{st + k2::kPlaneFloats, static_cast<float>(tl.wy0),
             static_cast<float>(tl.wx0)},
      st + ctid, st + k2::kOffFloats + ctid, k2::kTilePx, p.weight,
      p.d_offset + tl.b * (2 * kTaps) * hws + q,
      p.d_mask + tl.b * kTaps * hws + q, hws,
      st[k2::kOffFloats + k2::kMaskFloats + ctid], p.row0 + y, xo, p.h, p.w,
      p.pad, px_dw, scatter);
#pragma unroll
  for (int t = 0; t < kTaps; ++t) dw[t] += px_dw[t];
}

// One warp's share of d_bias from a tile's stage: each lane adds its
// strided eighth of the g plane (zero off the slab) to ``gsum``, in double:
// d_bias is held to a relative tolerance, and a float sum of a million g
// carries about 1e-4 of rounding, more than a sum near 0 allows. One warp
// per block does it (the TMA path's producer, idle while the consumers
// compute), so the consumers carry no double (which cost 2-5 % on an H100
// at 16 and 50 x 128^2).
__device__ __forceinline__ void k2_tile_gsum(const float* st, int lane,
                                             double& gsum) {
  const float* g = st + k2::kOffFloats + k2::kMaskFloats;
#pragma unroll
  for (int k = 0; k < k2::kTilePx / 32; ++k) gsum += g[lane + 32 * k];
}

// the TMA path's loads of tile ``tl`` into the stage at shared address
// ``dst``, counted on the full barrier ``bar``
__device__ __forceinline__ void k2_load(const K2Tile& tl, uint32_t dst,
                                        uint32_t bar,
                                        const CUtensorMap& off_map,
                                        const CUtensorMap& mask_map,
                                        const CUtensorMap& g_map,
                                        const CUtensorMap& x_map) {
  jspsr::mbar_expect_tx(bar, k2::kStageFloats * 4);
  jspsr::tma_load_3d(dst, &off_map, tl.x0, tl.y0, tl.b * 2 * kTaps, bar);
  jspsr::tma_load_3d(dst + k2::kOffFloats * 4, &mask_map, tl.x0, tl.y0,
                     tl.b * kTaps, bar);
  jspsr::tma_load_3d(dst + (k2::kOffFloats + k2::kMaskFloats) * 4, &g_map,
                     tl.x0, tl.y0, tl.b, bar);
  jspsr::tma_load_4d(dst + k2::kPlaneFloats * 4, &x_map, 0, tl.wx0 / 4,
                     tl.wy0, tl.b, bar);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// the copy path's fill of one stage: the layout the TMA path's loads
// write, zero off the slab and off the image; each thread copies its own
// pixel of the tile's 28 planes (one index, 28 copies), then its share of
// the window
__device__ __forceinline__ void k2_copy_tile(float* st, const K2Tile& tl,
                                             const K2Params& p, int tid) {
  const int64_t hws = static_cast<int64_t>(p.hs) * p.w;  // a slab plane
  const int y = tl.y0 + tid / k2::kTileW, xo = tl.x0 + tid % k2::kTileW;
  const bool valid = y < p.hs && xo < p.w;
  const int64_t q = valid ? static_cast<int64_t>(y) * p.w + xo : 0;
  // planes 0-17 the offsets, 18-26 the mask, 27 g
  const float* off = p.offset + tl.b * (2 * kTaps) * hws + q;
  const float* msk = p.mask + tl.b * kTaps * hws + q;
  const uint32_t dst = jspsr::smem_u32(st + tid);
#pragma unroll
  for (int k = 0; k < 2 * kTaps; ++k)
    cp_async4(dst + k * k2::kTilePx * 4, off + k * hws, valid);
#pragma unroll
  for (int k = 0; k < kTaps; ++k)
    cp_async4(dst + (2 * kTaps + k) * k2::kTilePx * 4, msk + k * hws, valid);
  cp_async4(dst + 3 * kTaps * k2::kTilePx * 4, p.grad_out + tl.b * hws + q,
            valid);
  const float* img = p.x + tl.b * (static_cast<int64_t>(p.h) * p.w);
  for (int e = tid; e < k2::kWinFloats; e += k2::kConsumers) {
    const int gy = tl.wy0 + e / k2::kWinW, gx = tl.wx0 + e % k2::kWinW;
    const bool in = gy >= 0 && gy < p.h && gx >= 0 && gx < p.w;
    cp_async4(jspsr::smem_u32(st + k2::kPlaneFloats + e),
              in ? img + static_cast<int64_t>(gy) * p.w + gx : p.x, in);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The block's d_weight and d_bias sums from every thread's (dw, gsum), in a
// fixed order (warp shuffles, then its kWarpsB warps in order), written by
// its last warp's first k2::kSums lanes as the block's row of ``rows``.
// Every thread of the block calls it.
template <int kWarpsB>
__device__ __forceinline__ void k2_row(const float (&dw)[kTaps], double gsum,
                                       const K2Params& p) {
  __shared__ double warp_sums[kWarpsB][k2::kSums];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < k2::kSums; ++c) {
    double v = c < kTaps ? static_cast<double>(dw[c % kTaps]) : gsum;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
    if (lane == 0) warp_sums[warp][c] = v;
  }
  __syncthreads();
  if (warp == kWarpsB - 1 && lane < k2::kSums) {
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < kWarpsB; ++k) s += warp_sums[k][lane];
    p.rows[blockIdx.x * k2::kSums + lane] = s;
  }
}

// d_weight and d_bias from the grid's rows, summed in block order (one
// warp per value: each lane its strided share in double, then a fixed
// shuffle tree). Every thread of one block calls it.
template <int kWarpsB>
__device__ __forceinline__ void k2_sum_rows(const K2Params& p) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int c = warp; c < k2::kSums; c += kWarpsB) {
    double v = 0.0;
    for (int r = lane; r < static_cast<int>(gridDim.x); r += 32)
      v += __ldcg(p.rows + r * k2::kSums + c);  // from L2, past this SM's L1
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) {
      if (c < kTaps)
        p.d_weight[c] = static_cast<float>(v);
      else
        *p.d_bias = static_cast<float>(v);
    }
  }
}

// K2's d_weight and d_bias from every thread's sums (dw, gsum): the
// block's row (k2_row); the block whose ticket on the counter comes last
// sums the rows (k2_sum_rows) and sets the counter back to 0. Every thread
// of the block calls it. The last warp writes the row, fences and takes
// the ticket: a fence waits for its thread's own stores, and in the TMA
// path that warp, the producer, has written nothing else.
template <int kWarpsB>
__device__ __forceinline__ void k2_finish(const float (&dw)[kTaps],
                                          double gsum, const K2Params& p) {
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  k2_row<kWarpsB>(dw, gsum, p);
  if (warp == kWarpsB - 1) {
    // the row is visible before the ticket says so
    if (lane < k2::kSums) __threadfence();
    __syncwarp();
    if (lane == 0) last = atomicAdd(p.counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  k2_sum_rows<kWarpsB>(p);
  if (threadIdx.x == 0) *p.counter = 0u;  // every block has its ticket
}

// A block's sum of one double per thread of its first kThreads, in a fixed
// order (a warp shuffle tree, then the warps' sums in turn); thread 0
// holds the result. Every thread of the block calls it.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sum[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0 && threadIdx.x < kThreads)
    warp_sum[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 1; k < kWarps; ++k) v += warp_sum[k];
  }
  return v;
}

// K3's phase 1: the accumulator zeroed (16-byte stores, every thread of the
// grid its strided share; the scratch starts on 16 bytes), the block's
// window zeroed, and the chunks' partial bounds: chunk c of the batch's
// B * chunks (kBoundChunk pixels of image c / chunks's slab, which
// ``part[c]`` receives) summed by the block's first kThreads threads, each
// its strided pixels in turn, then block_sum (NaN and inf carry through).
// Every thread of the block calls it.
__device__ __forceinline__ void k3_phase1(const K2Params& p, unsigned* lo,
                                          unsigned* hi) {
  const int64_t n = p.batch * p.h * p.w;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  ulonglong2* acc2 = reinterpret_cast<ulonglong2*>(p.acc);
  for (int64_t i = i0; i < n / 2; i += stride)
    acc2[i] = make_ulonglong2(0ull, 0ull);
  if (i0 == 0 && (n & 1)) p.acc[n - 1] = 0ull;
  for (int e = threadIdx.x; e < k3::kCells; e += blockDim.x) {
    lo[e] = 0u;
    hi[e] = 0u;
  }
  const int64_t hws = static_cast<int64_t>(p.hs) * p.w;
  float aw[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) aw[t] = fabsf(__ldg(p.weight + t));
  for (int64_t c = blockIdx.x; c < p.batch * p.chunks; c += gridDim.x) {
    const int64_t b = c / p.chunks;
    const int64_t p0 = (c % p.chunks) * kBoundChunk;
    const int64_t p1 = p0 + kBoundChunk < hws ? p0 + kBoundChunk : hws;
    const float* g = p.grad_out + b * hws;
    const float* m = p.mask + b * kTaps * hws;
    double s = 0.0;
    if (threadIdx.x < kThreads) {
      // a thread's kBoundChunk / kThreads pixels loaded together, then
      // summed in turn
      constexpr int kPer = kBoundChunk / kThreads;
      float gv[kPer], mv[kPer][kTaps];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int64_t q = p0 + threadIdx.x + k * kThreads;
        const bool in = q < p1;
        gv[k] = in ? g[q] : 0.f;
#pragma unroll
        for (int t = 0; t < kTaps; ++t) mv[k][t] = in ? m[t * hws + q] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (p0 + threadIdx.x + k * kThreads < p1) {
          float wm = 0.f;
#pragma unroll
          for (int t = 0; t < kTaps; ++t) wm += aw[t] * fabsf(mv[k][t]);
          s += static_cast<double>(fabsf(gv[k])) * static_cast<double>(wm);
        }
      }
    }
    s = block_sum(s);
    if (threadIdx.x == 0) p.part[c] = s;
    __syncthreads();  // thread 0 has read warp_sum before the next chunk
  }
}

// The scale of tile ``tl``'s image, on lane 0 of the warp that calls it:
// the image's L1 bound summed from its phase-1 partials in a fixed order
// (each lane its strided share, then a shuffle tree), unless the block's
// previous tile (``last_b``, its scale ``last``) was of the same image.
// The image's first tile leaves its bound in ``bound`` for phase 3. A
// whole warp calls it.
__device__ __forceinline__ float k3_tile_scale(const K2Params& p,
                                               const K2Tile& tl, int lane,
                                               int& last_b, float& last) {
  if (tl.b != last_b) {
    double v = 0.0;
    for (int64_t c = lane; c < p.chunks; c += 32)
      v += __ldcg(p.part + tl.b * p.chunks + c);  // from L2, past L1
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0 && tl.y0 == 0 && tl.x0 == 0) p.bound[tl.b] = v;
    last = fixed_scale(v).scale;  // not ok: phase 3 writes NaN instead
    last_b = tl.b;
  }
  return last;
}

// K3's scatter for tile ``tl``: its window's origin in image rows, its
// image's accumulator and scale
__device__ __forceinline__ WindowScatter k3_scatter(unsigned* lo,
                                                    unsigned* hi,
                                                    const K2Tile& tl,
                                                    const K2Params& p,
                                                    float scale) {
  return {lo, hi, p.acc + tl.b * (static_cast<int64_t>(p.h) * p.w), scale,
          p.row0 + tl.y0 - k3::kMargin, tl.x0 - k3::kMargin, p.w};
}

// K3's flush of tile ``tl``'s window: every in-image cell that is not 0
// added to the accumulator with one global atomic, and every cell set back
// to 0; by the kConsumers threads (``ctid``)
__device__ __forceinline__ void k3_flush(unsigned* lo, unsigned* hi,
                                         const K2Tile& tl, const K2Params& p,
                                         int ctid) {
  const WindowScatter sc = k3_scatter(lo, hi, tl, p, 0.f);
  for (int e = ctid; e < k3::kCells; e += k2::kConsumers) {
    const unsigned long long v =
        (static_cast<unsigned long long>(hi[e]) << 32) | lo[e];
    lo[e] = 0u;
    hi[e] = 0u;
    const int yc = sc.wy0 + e / k3::kWinW, xc = sc.wx0 + e % k3::kWinW;
    if (v != 0ull && yc >= 0 && yc < p.h && xc >= 0 && xc < p.w)
      atomicAdd(sc.dimg + static_cast<int64_t>(yc) * p.w + xc, v);
  }
}

// K3's phase 3: the accumulator back to fp32 over the whole images, one
// rounding (int64 -> double is exact below 2^53; above, double then float
// round), NaN over an image whose bound is not ok; every thread of the
// grid its strided share
__device__ __forceinline__ void k3_to_float(const K2Params& p) {
  const int64_t hw = static_cast<int64_t>(p.h) * p.w;
  const int64_t n = p.batch * hw;
  const long long* acc = reinterpret_cast<const long long*>(p.acc);
  int64_t cached = -1;
  FixedScale fs{0.f, 0.0, false};
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t b = i / hw;
    if (b != cached) {
      fs = fixed_scale(__ldcg(p.bound + b));
      cached = b;
    }
    p.d_x[i] = fs.ok ? static_cast<float>(
                           static_cast<double>(__ldcg(acc + i)) * fs.inv)
                     : __int_as_float(0x7fc00000);
  }
}

// the consumers' barrier (named barrier 1: the TMA path's producer warp
// takes no part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(k2::kConsumers) : "memory");
}

// K2 (kDx false) and K3 (kDx true): the persistent grid over 4 x 64 tiles
// of the slab (B, Hs, W) of image rows [row0, row0 + Hs); kTma the TMA
// path (a producer warp and 256 consumers), else the cp.async path (256
// threads that copy and compute); kBf16 the bf16-sampling mode. K2
// finishes d_weight and d_bias through the ticket counter; K3 runs its
// three phases around two grid barriers (the header note).
template <bool kTma, bool kBf16, bool kDx>
__device__ __forceinline__ void backward_tiles(const CUtensorMap& off_map,
                                               const CUtensorMap& mask_map,
                                               const CUtensorMap& g_map,
                                               const CUtensorMap& x_map,
                                               const K2Params& p) {
  using jspsr::smem_u32;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  unsigned char* smem = smem_raw + (base - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [kStages]
  uint64_t* empty = full + k2::kStages;                // [kStages]
  float* scales = reinterpret_cast<float*>(smem + k3::kScaleOff);  // K3
  float* ring = reinterpret_cast<float*>(smem + k2::kBarBytes);
  constexpr int kStageStride = k2::kStageBytes / 4;  // floats
  // K3's window, after the ring
  unsigned* win_lo =
      reinterpret_cast<unsigned*>(ring + k2::kStages * kStageStride);
  unsigned* win_hi = win_lo + k3::kCells;

  const int tid = threadIdx.x;
  const int my_tiles =
      static_cast<int>(blockIdx.x) < p.n_tiles
          ? (p.n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
          : 0;
  float dw[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) dw[t] = 0.f;
  double gsum = 0.0;  // this lane's share of d_bias, in the summing warp
  int last_b = -1;    // K3: the image of the block's last scaled tile
  float last_scale = 0.f;

  if constexpr (kTma) {
    if (tid == 0) {
      for (int s = 0; s < k2::kStages; ++s) {
        // K3's producer arrives once more, with the tile's scale
        jspsr::mbar_init(smem_u32(full + s), kDx ? 2 : 1);
        // the consumer warps, and the producer once it has summed g
        jspsr::mbar_init(smem_u32(empty + s), k2::kConsumers / 32 + 1);
      }
      jspsr::mbar_init_fence();
    }
    __syncthreads();
    if constexpr (kDx) {
      // the first stages' loads land during phase 1
      if (tid == k2::kConsumers)
        for (int i = 0; i < min(my_tiles, k2::kStages); ++i)
          k2_load(k2_tile(blockIdx.x + i * gridDim.x, p),
                  smem_u32(ring + i * kStageStride), smem_u32(full + i),
                  off_map, mask_map, g_map, x_map);
      k3_phase1(p, win_lo, win_hi);
      cooperative_groups::this_grid().sync();
    }
    if (tid >= k2::kConsumers) {
      // the producer warp: lane 0 issues tile i's loads (K3: the warp
      // then puts its scale in the stage), then the warp sums tile i - 1's
      // g, which has landed, and frees its stage
      const int lane = tid - k2::kConsumers;
      for (int i = 0; i <= my_tiles; ++i) {
        if (i < my_tiles) {
          const int s = i % k2::kStages;
          const K2Tile tl = k2_tile(blockIdx.x + i * gridDim.x, p);
          if (lane == 0 && (!kDx || i >= k2::kStages)) {
            if (i >= k2::kStages)
              jspsr::mbar_wait(smem_u32(empty + s),
                               (i / k2::kStages - 1) & 1);
            k2_load(tl, smem_u32(ring + s * kStageStride),
                    smem_u32(full + s), off_map, mask_map, g_map, x_map);
          }
          if constexpr (kDx) {
            const float scale = k3_tile_scale(p, tl, lane, last_b,
                                              last_scale);
            if (lane == 0) {
              scales[s] = scale;
              jspsr::mbar_arrive(smem_u32(full + s));
            }
          }
        }
        if (i >= 1) {
          const int s = (i - 1) % k2::kStages;
          jspsr::mbar_wait(smem_u32(full + s), ((i - 1) / k2::kStages) & 1);
          k2_tile_gsum(ring + s * kStageStride, lane, gsum);
          __syncwarp();
          if (lane == 0) jspsr::mbar_arrive(smem_u32(empty + s));
        }
      }
    } else {
      for (int i = 0; i < my_tiles; ++i) {
        const int s = i % k2::kStages;
        jspsr::mbar_wait(smem_u32(full + s), (i / k2::kStages) & 1);
        const K2Tile tl = k2_tile(blockIdx.x + i * gridDim.x, p);
        const float* st = ring + s * kStageStride;
        if constexpr (kDx)
          k2_pixel<kBf16>(st, tl, p, tid, dw,
                          k3_scatter(win_lo, win_hi, tl, p, scales[s]));
        else
          k2_pixel<kBf16>(st, tl, p, tid, dw, NoScatter{});
        // every lane's reads of the stage are done before lane 0 frees it
        __syncwarp();
        if (tid % 32 == 0) jspsr::mbar_arrive(smem_u32(empty + s));
        if constexpr (kDx) {
          consumers_sync();  // every scatter into the window has landed
          k3_flush(win_lo, win_hi, tl, p, tid);
          consumers_sync();  // the window is 0 before the next scatter
        }
      }
    }
  } else {
    // the last warp sums each tile's g too
    constexpr int kSummer = k2::kConsumers / 32 - 1;
    if constexpr (kDx) {
      // the first tile's copies land during phase 1
      if (my_tiles > 0) k2_copy_tile(ring, k2_tile(blockIdx.x, p), p, tid);
      k3_phase1(p, win_lo, win_hi);
      cooperative_groups::this_grid().sync();
    }
    for (int i = 0; i < my_tiles; ++i) {
      if (!kDx && i == 0) k2_copy_tile(ring, k2_tile(blockIdx.x, p), p, tid);
      if (i + 1 < my_tiles) {
        k2_copy_tile(ring + ((i + 1) % k2::kStages) * kStageStride,
                     k2_tile(blockIdx.x + (i + 1) * gridDim.x, p), p, tid);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      const K2Tile tl = k2_tile(blockIdx.x + i * gridDim.x, p);
      if constexpr (kDx) {
        if (tid < 32) {
          const float scale = k3_tile_scale(p, tl, tid, last_b, last_scale);
          if (tid == 0) scales[0] = scale;
        }
      }
      __syncthreads();
      const float* st = ring + (i % k2::kStages) * kStageStride;
      if constexpr (kDx)
        k2_pixel<kBf16>(st, tl, p, tid, dw,
                        k3_scatter(win_lo, win_hi, tl, p, scales[0]));
      else
        k2_pixel<kBf16>(st, tl, p, tid, dw, NoScatter{});
      if (tid / 32 == kSummer) k2_tile_gsum(st, tid % 32, gsum);
      // the stage is refilled two tiles on; K3's window and scale are
      // reused after the next tile's barrier
      __syncthreads();
      if constexpr (kDx) k3_flush(win_lo, win_hi, tl, p, tid);
    }
  }
  constexpr int kWarpsB = (kTma ? k2::kThreadsTma : k2::kConsumers) / 32;
  if constexpr (kDx) {
    k2_row<kWarpsB>(dw, gsum, p);
    // every scatter, flush and row is in before phase 3 reads them
    cooperative_groups::this_grid().sync();
    // block 0's chain of loads for the rows first, beside the others'
    // conversion
    if (blockIdx.x == 0) k2_sum_rows<kWarpsB>(p);
    k3_to_float(p);
  } else {
    k2_finish<kWarpsB>(dw, gsum, p);
  }
}

// K2: no input gradient, d_weight and d_bias finished in the kernel
template <bool kTma, bool kBf16>
__global__ void __launch_bounds__(kTma ? k2::kThreadsTma : k2::kConsumers,
                                  k2::kBlocksPerSm)
deform_bwd_kernel(const __grid_constant__ CUtensorMap off_map,
                  const __grid_constant__ CUtensorMap mask_map,
                  const __grid_constant__ CUtensorMap g_map,
                  const __grid_constant__ CUtensorMap x_map,
                  const K2Params p) {
  backward_tiles<kTma, kBf16, false>(off_map, mask_map, g_map, x_map, p);
}

// K3: K2 with d_x, one cooperative launch
template <bool kTma, bool kBf16>
__global__ void __launch_bounds__(kTma ? k2::kThreadsTma : k2::kConsumers,
                                  k2::kBlocksPerSm)
deform_bwd_dx_kernel(const __grid_constant__ CUtensorMap off_map,
                     const __grid_constant__ CUtensorMap mask_map,
                     const __grid_constant__ CUtensorMap g_map,
                     const __grid_constant__ CUtensorMap x_map,
                     const K2Params p) {
  backward_tiles<kTma, kBf16, true>(off_map, mask_map, g_map, x_map, p);
}

bool k2_use_tma(const void* x, const void* offset, const void* mask,
                const void* grad_out, int w) {
  return w % 4 == 0 && jspsr::aligned16(x) && jspsr::aligned16(offset) &&
         jspsr::aligned16(mask) && jspsr::aligned16(grad_out);
}

int64_t k2_tiles(int64_t batch, int hs, int w) {
  return batch * ((hs + k2::kTileH - 1) / k2::kTileH) *
         ((w + k2::kTileW - 1) / k2::kTileW);
}

// the rows of K2's and K3's finish on the current device: one per block of
// their persistent grid, at most kBlocksPerSm per SM (0 where the runtime
// cannot count the SMs)
int64_t k2_rows(int64_t batch, int hs, int w) {
  return std::min<int64_t>(k2_tiles(batch, hs, w),
                           int64_t{jspsr::sm_count()} * k2::kBlocksPerSm);
}

// the kernel's dynamic shared-memory allowance, set once per device, and
// how many of its blocks one SM holds
template <bool kTma, bool kBf16, bool kDx>
cudaError_t bwd_prepare(int* blocks) {
  static int resident[64] = {};  // per device, 0 until asked
  constexpr int kThreadsB = kTma ? k2::kThreadsTma : k2::kConsumers;
  if constexpr (kDx)
    return jspsr::resident_blocks(deform_bwd_dx_kernel<kTma, kBf16>,
                                  kThreadsB, k3::kSmem, resident, blocks);
  else
    return jspsr::resident_blocks(deform_bwd_kernel<kTma, kBf16>, kThreadsB,
                                  k2::kSmem, resident, blocks);
}

// K2 (kDx false) or K3 on the slab of image rows [row0, row0 + hs) that
// ``p`` describes, as jspsr_deform_bwd and jspsr_deform_bwd_dx describe
// them; ``p``'s grid fields are filled here
template <bool kBf16, bool kDx>
int launch_bwd(K2Params p, int64_t batch, void* stream) {
  if (p.row0 < 0 || p.hs < 0 || p.row0 > p.h - p.hs)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || p.hs == 0 || p.w == 0) return 0;
  const int64_t n_tiles = k2_tiles(batch, p.hs, p.w);
  if (n_tiles >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = jspsr::sm_count();
  if (sms == 0) return static_cast<int>(cudaGetLastError());
  const bool tma = k2_use_tma(p.x, p.offset, p.mask, p.grad_out, p.w);
  int blocks = 0;
  const cudaError_t err = tma ? bwd_prepare<true, kBf16, kDx>(&blocks)
                              : bwd_prepare<false, kBf16, kDx>(&blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: every block resident at once, none without a tile, no
  // more than k2_rows sized the rows for
  const int64_t slots =
      static_cast<int64_t>(sms) * std::min(blocks, k2::kBlocksPerSm);
  const int grid = static_cast<int>(std::min(n_tiles, slots));
  p.tiles_x = (p.w + k2::kTileW - 1) / k2::kTileW;
  p.tiles_y = (p.hs + k2::kTileH - 1) / k2::kTileH;
  p.n_tiles = static_cast<int>(n_tiles);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap maps[4] = {};
  if (tma) {
    const jspsr::EncodeTiled encode = jspsr::encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    using jspsr::encode_planes;
    if (encode_planes(encode, &maps[0], p.offset, p.w, p.hs,
                      batch * 2 * kTaps, k2::kTileW, k2::kTileH,
                      2 * kTaps) != CUDA_SUCCESS ||
        encode_planes(encode, &maps[1], p.mask, p.w, p.hs, batch * kTaps,
                      k2::kTileW, k2::kTileH, kTaps) != CUDA_SUCCESS ||
        encode_planes(encode, &maps[2], p.grad_out, p.w, p.hs, batch,
                      k2::kTileW, k2::kTileH, 1) != CUDA_SUCCESS ||
        jspsr::encode_window(encode, &maps[3], p.x, p.w, p.h, batch,
                             k2::kWinH, k2::kWinW) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = tma ? k2::kThreadsTma : k2::kConsumers;
  if constexpr (kDx) {
    // the grid barrier needs every block resident: a cooperative launch,
    // which the runtime refuses (an error, no fallback) rather than start
    // a grid that it cannot hold at once
    void* args[] = {&maps[0], &maps[1], &maps[2], &maps[3], &p};
    const void* fn =
        tma ? reinterpret_cast<const void*>(deform_bwd_dx_kernel<true, kBf16>)
            : reinterpret_cast<const void*>(
                  deform_bwd_dx_kernel<false, kBf16>);
    const cudaError_t rc = cudaLaunchCooperativeKernel(
        fn, dim3(grid), dim3(threads), args, k3::kSmem, s);
    if (rc != cudaSuccess) {
      cudaGetLastError();  // the error is returned, not left behind
      return static_cast<int>(rc);
    }
  } else if (tma) {
    deform_bwd_kernel<true, kBf16><<<grid, threads, k2::kSmem, s>>>(
        maps[0], maps[1], maps[2], maps[3], p);
  } else {
    deform_bwd_kernel<false, kBf16><<<grid, threads, k2::kSmem, s>>>(
        maps[0], maps[1], maps[2], maps[3], p);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2's launch parameters (K3's fields left empty)
template <bool kBf16>
int launch_k2(const float* x, const float* offset, const float* mask,
              const float* weight, const float* grad_out, float* d_offset,
              float* d_mask, float* d_weight, float* d_bias, double* rows,
              unsigned* counter, int64_t batch, int h, int w, int pad, int hs,
              int y0, void* stream) {
  K2Params p{};
  p.x = x;
  p.offset = offset;
  p.mask = mask;
  p.weight = weight;
  p.grad_out = grad_out;
  p.d_offset = d_offset;
  p.d_mask = d_mask;
  p.d_weight = d_weight;
  p.d_bias = d_bias;
  p.rows = rows;
  p.counter = counter;
  p.h = h;
  p.w = w;
  p.pad = pad;
  p.hs = hs;
  p.row0 = y0;
  p.batch = batch;
  return launch_bwd<kBf16, false>(p, batch, stream);
}

// K3's scratch (jspsr_deform_bwd_dx_scratch words) laid out: the
// accumulator, the bounds, phase 1's partials, the blocks' rows
template <bool kBf16>
int launch_k3(const float* x, const float* offset, const float* mask,
              const float* weight, const float* grad_out, float* d_offset,
              float* d_mask, float* d_weight, float* d_bias,
              long long* scratch, float* d_x, int64_t batch, int h, int w,
              int pad, int hs, int y0, void* stream) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t chunks = k3_chunks(static_cast<int64_t>(hs) * w);
  K2Params p{};
  p.x = x;
  p.offset = offset;
  p.mask = mask;
  p.weight = weight;
  p.grad_out = grad_out;
  p.d_offset = d_offset;
  p.d_mask = d_mask;
  p.d_weight = d_weight;
  p.d_bias = d_bias;
  p.h = h;
  p.w = w;
  p.pad = pad;
  p.hs = hs;
  p.row0 = y0;
  p.d_x = d_x;
  p.acc = reinterpret_cast<unsigned long long*>(scratch);
  p.bound = reinterpret_cast<double*>(scratch + batch * hw);
  p.part = p.bound + batch;
  p.rows = p.part + batch * chunks;
  p.batch = batch;
  p.chunks = chunks;
  return launch_bwd<kBf16, true>(p, batch, stream);
}

}  // namespace

// The rows of K2's scratch on the current device: one row of d_weight's 9
// sums and d_bias's per block of its persistent grid over a slab of H rows
// (jspsr_deform_bwd's ``rows``).
extern "C" int64_t jspsr_deform_bwd_rows(int64_t batch, int h, int w) {
  return k2_rows(batch, h, w);
}

// K3's tile (rows, columns) and window margin, in that order.
extern "C" void jspsr_deform_bwd_dx_window(int* out) {
  out[0] = k2::kTileH;
  out[1] = k2::kTileW;
  out[2] = k3::kMargin;
}

// Plain C entry points, bound from Python with ctypes. All tensors are
// contiguous fp32 on the current device: x (B,1,H,W), offset (B,18,H,W),
// mask (B,9,H,W), weight (9,), grad_out (B,1,H,W); outputs d_offset
// (B,18,H,W), d_mask (B,9,H,W), d_weight (9,), d_bias (1,) and, for
// jspsr_deform_bwd_dx, d_x (B,1,H,W). Each takes a row slab: offset, mask,
// grad_out, d_offset and d_mask of hs rows, image rows [y0, y0 + hs) of x
// (hs = h, y0 = 0: the whole image); d_x is the whole image's (B,1,H,W)
// either way. Each launches one kernel on ``stream`` without synchronising
// and returns its launch's error (cudaErrorNotSupported where libcuda has
// no tensor-map encoder and the shape needs one); an empty batch or slab
// launches nothing and writes nothing.
//
// K2 writes d_weight and d_bias itself, in one launch, through ``rows``
// (jspsr_deform_bwd_rows rows of 10 doubles, written before they are read)
// and ``counter``, one unsigned int that is 0 when the kernel starts and
// that its last block sets back to 0. One counter serves every K2 launch
// on one stream: the launches of a stream run one after the other, each
// leaves the counter at 0 for the next, and no other kernel touches it.
// Two streams need two counters, as two launches on them may run at once.
extern "C" int jspsr_deform_bwd(const float* x, const float* offset,
                                const float* mask, const float* weight,
                                const float* grad_out, float* d_offset,
                                float* d_mask, float* d_weight, float* d_bias,
                                double* rows, unsigned* counter, int64_t batch,
                                int h, int w, int pad, int hs, int y0,
                                void* stream) {
  return launch_k2<false>(x, offset, mask, weight, grad_out, d_offset, d_mask,
                          d_weight, d_bias, rows, counter, batch, h, w, pad,
                          hs, y0, stream);
}

// K2's bf16-sampling mode: as jspsr_deform_bwd.
extern "C" int jspsr_deform_bwd_bf16(const float* x, const float* offset,
                                     const float* mask, const float* weight,
                                     const float* grad_out, float* d_offset,
                                     float* d_mask, float* d_weight,
                                     float* d_bias, double* rows,
                                     unsigned* counter, int64_t batch, int h,
                                     int w, int pad, int hs, int y0,
                                     void* stream) {
  return launch_k2<true>(x, offset, mask, weight, grad_out, d_offset, d_mask,
                         d_weight, d_bias, rows, counter, batch, h, w, pad,
                         hs, y0, stream);
}

// K3's scratch, in int64 words, written by the kernel before it is read
// (nothing to zero): the whole images' d_x accumulator (B*H*W), the
// images' L1 bounds (B doubles), phase 1's partials (one double per chunk
// of each image's slab of hs rows) and the blocks' rows of d_weight and
// d_bias (K2's rows, 10 doubles each).
extern "C" int64_t jspsr_deform_bwd_dx_scratch(int64_t batch, int h, int w,
                                               int hs) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  return batch * (hw + 1 + k3_chunks(static_cast<int64_t>(hs) * w)) +
         k2_rows(batch, hs, w) * k2::kSums;
}

// K3: one cooperative launch, as the header note describes it. All tensors
// as for jspsr_deform_bwd (the same row slab), plus ``scratch``
// (jspsr_deform_bwd_dx_scratch words, its start on 16 bytes) and d_x
// (B,1,H,W), the whole images'. No counter: the grid barrier orders the
// rows, so launches on any streams may run at once.
extern "C" int jspsr_deform_bwd_dx(const float* x, const float* offset,
                                   const float* mask, const float* weight,
                                   const float* grad_out, float* d_offset,
                                   float* d_mask, float* d_weight,
                                   float* d_bias, long long* scratch,
                                   float* d_x, int64_t batch, int h, int w,
                                   int pad, int hs, int y0, void* stream) {
  return launch_k3<false>(x, offset, mask, weight, grad_out, d_offset,
                          d_mask, d_weight, d_bias, scratch, d_x, batch, h,
                          w, pad, hs, y0, stream);
}

// K3's bf16-sampling mode: as jspsr_deform_bwd_dx.
extern "C" int jspsr_deform_bwd_dx_bf16(const float* x, const float* offset,
                                        const float* mask,
                                        const float* weight,
                                        const float* grad_out,
                                        float* d_offset, float* d_mask,
                                        float* d_weight, float* d_bias,
                                        long long* scratch, float* d_x,
                                        int64_t batch, int h, int w, int pad,
                                        int hs, int y0, void* stream) {
  return launch_k3<true>(x, offset, mask, weight, grad_out, d_offset, d_mask,
                         d_weight, d_bias, scratch, d_x, batch, h, w, pad, hs,
                         y0, stream);
}
