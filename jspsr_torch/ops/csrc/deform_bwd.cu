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
// K3's scatter goes through a shared-memory window first. A block owns an
// 8 x 32 output tile (one thread per pixel; a warp is one row, so each of
// its offset, mask and gradient reads is one coalesced 128-byte line) and
// keeps a window of (8 + 2M) x (32 + 2M) cells around it, M = 4. A corner
// inside the window is added there (a shared-memory atomic); one outside
// it (an offset beyond about M - 1 px from the tile, or a tile at the
// image edge) goes to a global atomic into the d_x accumulator that the
// caller zeroes; off-image corners still receive nothing. After a barrier
// every in-image window cell that is not 0 is flushed with one global
// atomic: windows of neighbouring tiles overlap, so the flush stays
// atomic. At NLSPN's offsets of about 1.5 px that takes the global atomics
// from up to 36 per pixel (4 corners x 9 taps) to at most 640 / 256 = 2.5
// flushes plus the few corners that leave the window
// (ops/deform_cuda.py::dx_atomics counts both from the offsets). Blocks
// run in no order on this card, so nothing like the TPU's carried
// accumulator exists; an inverse gather over a fixed window is not exact
// because offsets are unbounded (tests use 20 px). Its d_weight is reduced
// in the block (block_dweight: warp shuffles, then the warps in a fixed
// order) into one row of 9 partials per block, which the caller sums.
//
// d_x is bitwise reproducible: it is summed in fixed point. Every
// contribution v becomes the integer round(v * 2^k) (__float2ll_rn; the
// scaling by a power of two is exact), the window cells and the global
// accumulator hold 64-bit integers, and integer addition is associative,
// so the order in which the atomics land no longer matters. A last pass
// (dx_fixed_to_float_kernel) turns the accumulator back into fp32, acc *
// 2^-k, one rounding. k is chosen per image on the device, with no host
// sync, from the image's L1 norm of contributions,
//   L_b = sum over its pixels p of |g_p| * sum_t |w_t| |m_{p,t}|,
// which a first pass (dx_bounds_kernel) sums in double: each block one
// chunk of kBoundChunk pixels, reduced in a fixed order into one partial;
// the block that finishes last (an integer counter) sums each image's
// partials in a fixed order, so L_b, and k, are the same on every run. A
// tap's four corner weights are in [0, 1] and sum to 1, so the magnitudes
// of all of an image's contributions sum to at most L_b, and k is the
// largest with
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
// inf among that image's g, w or m) makes the last pass write NaN over the
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
// 224 B against about 300 FLOP; d_x adds the bounds pass's second read of
// g and the mask (40 B), its accumulator's zero fill (8 B), its read and
// its fp32 write-back (12 B). K3's up to 36 corner contributions per pixel
// go to pairs of native 32-bit shared-memory atomics; about 2 per pixel
// reach L2. Positions and corners are recomputed from the inputs rather
// than saved by the forward (saving them would cost more bytes than the
// arithmetic costs time).
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
// K3 on a row slab (deform_bwd_dx_slab, deform_bwd_dx_bf16_slab; NLSPN's
// propagation under a spatial sharding, and an SPN head whose DEM needs
// its gradient): the slab planes and row0 as K2's, while x and the d_x
// accumulator stay the whole image. Each block's 8 x 32 tile is a tile of
// the slab (a last tile row that passes the slab's Hs rows is partial, as
// at the image's bottom), and its output rows, its window origin and its
// global-atomic fallback are image rows row0 + h: a slab scatters its own
// contributions into the whole image's d_x. The bounds pass sums L_b over
// the slab's own pixels, which bounds every contribution the slab
// scatters, so the fixed point stays safe; the last pass converts the
// whole image once, with that slab's scale. d_offset, d_mask and the
// d_weight partials come from the per-pixel code K2 runs, so d_offset and
// d_mask are those rows of the whole image's K3 output, bit for bit. The
// slabs' d_x are then summed in fp32, in space order, by the caller
// (parallel/spatial.py's row gather), not in the fixed point: each slab's
// own scale makes that sum deterministic but not bit-equal to one
// whole-image launch.
//
// K3's bf16-sampling mode (the same flag on deform_bwd_dx_kernel; the TPU
// kernel's sample_dtype='bfloat16' with need_dx=True, entry point
// jspsr_deform_bwd_dx_bf16): the TPU kernel rounds only its two image
// products (pallas_deform.py:184-188,213,224) and keeps wy, wx and g w m in
// fp32 for the d_x matmul (:227-232), so d_offset, d_mask and d_weight are
// K2's bf16 mode's and d_x is K3's fp32 mode's, bounds pass and fixed point
// as they are. No shipped model reaches it (NLSPN samples in fp32, the SPN
// head detaches the DEM); the op's autograd does.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cfloat>

#include "tma.cuh"

namespace {

constexpr int kTaps = 9;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// K3's tile and window (ops/deform_cuda.py's DX_TILE and DX_MARGIN, checked
// against jspsr_deform_bwd_dx_window when the library is loaded)
constexpr int kTileH = 8;
constexpr int kTileW = 32;
constexpr int kMargin = 4;
static_assert(kTileH * kTileW == kThreads, "K3: one thread per tile pixel");
constexpr int kWinH = kTileH + 2 * kMargin;
constexpr int kWinW = kTileW + 2 * kMargin;
// d_x's fixed point: an image's L1 norm of contributions scales to at most
// 2^kFixedBits, and the pixels that sum it into one partial
constexpr int kFixedBits = 61;
constexpr int kBoundChunk = kThreads * 4;

// K2's tile, window and ring (K1's: deform_fwd.cu)
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
struct NoScatter {
  __device__ void operator()(int, int, float) const {}
};

// K3: in fixed point, into the block's window (hi:lo word pairs) where the
// corner lies inside it, else straight to the d_x accumulator
// (two's-complement integers added as unsigned: the same bits as a signed
// sum)
struct WindowScatter {
  unsigned* lo;              // [kWinH * kWinW], shared
  unsigned* hi;              // [kWinH * kWinW], shared
  unsigned long long* dimg;  // this image's d_x accumulator
  float scale;
  int wy0, wx0, w;
  __device__ void operator()(int yc, int xc, float v) const {
    const unsigned long long q =
        static_cast<unsigned long long>(__float2ll_rn(v * scale));
    if (q == 0ull) return;
    const int ry = yc - wy0, rx = xc - wx0;
    if (static_cast<unsigned>(ry) < kWinH &&
        static_cast<unsigned>(rx) < kWinW) {
      const int c = ry * kWinW + rx;
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
// val_t to dw and hands every in-bounds corner's share of d_x to ``scatter``;
// with kBf16 the bf16-sampling mode's values and derivatives. ``img`` is
// the pixel's image; ``off`` and ``msk`` point at the pixel in channel 0
// of planes ``in_plane`` floats apart, ``doff`` and ``dmsk`` of planes
// ``out_plane`` apart. With kWindow (K2, which scatters nothing) a tap
// whose 2 x 2 block of corners lies in ``win`` reads it there, the same
// floats as from the image; any other tap reads its corners from ``img``.
template <bool kBf16, bool kWindow, class Scatter>
__device__ __forceinline__ void pixel_backward(
    const float* __restrict__ img, const Window& win,
    const float* __restrict__ off, const float* __restrict__ msk,
    int64_t in_plane, const float* __restrict__ weight,
    float* __restrict__ doff, float* __restrict__ dmsk, int64_t out_plane,
    float g, int y, int xo, int h, int w, int pad, float (&dw)[kTaps],
    const Scatter& scatter) {
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
    if constexpr (kWindow) {
      // exact: both are integers, and a NaN or a far position fails
      const float ry = y0f - win.wy0, rx = x0f - win.wx0;
      if (ry >= 0.f && ry <= static_cast<float>(k2::kWinH - 2) &&
          rx >= 0.f && rx <= static_cast<float>(k2::kWinW - 2)) {
        const float* cell = win.cells + static_cast<int>(ry) * k2::kWinW +
                            static_cast<int>(rx);
        v00 = cell[0];
        v01 = cell[1];
        v10 = cell[k2::kWinW];
        v11 = cell[k2::kWinW + 1];
        in_window = true;
      }
    }
    if (!in_window && y0f >= -1.f && y0f <= hmax && x0f >= -1.f &&
        x0f <= wmax) {
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
      const float gy0 = gwm * (1.f - ty), gy1 = gwm * ty;
      if (vy0 && vx0) scatter(y0, x0, gy0 * (1.f - tx));
      if (vy0 && vx1) scatter(y0, x0 + 1, gy0 * tx);
      if (vy1 && vx0) scatter(y0 + 1, x0, gy1 * (1.f - tx));
      if (vy1 && vx1) scatter(y0 + 1, x0 + 1, gy1 * tx);
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
      const float top = (1.f - tx) * v00 + tx * v01;
      const float bot = (1.f - tx) * v10 + tx * v11;
      const float val = (1.f - ty) * top + ty * bot;
      dmsk[t * out_plane] = gw * val;
      doff[(2 * t) * out_plane] = gwm * (bot - top);
      doff[(2 * t + 1) * out_plane] =
          gwm * ((1.f - ty) * (v01 - v00) + ty * (v11 - v10));
      dw[t] = g * m * val;
    }
  }
}

// The block's 9 d_weight sums: a warp-shuffle sum, then the warps summed
// in a fixed order, one row of partials per block. Every thread of the
// block calls it; it ends after a __syncthreads.
__device__ __forceinline__ void block_dweight(const float (&dw)[kTaps],
                                              float* __restrict__ row) {
  __shared__ float warp_sums[kWarps][kTaps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    float v = dw[t];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
    if (lane == 0) warp_sums[warp][t] = v;
  }
  __syncthreads();
  if (threadIdx.x < kTaps) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += warp_sums[k][threadIdx.x];
    row[threadIdx.x] = s;
  }
}

// K2's launch: its inputs and outputs (contiguous fp32; offset, mask, g,
// d_offset and d_mask the slab of hs rows whose first is image row row0,
// x the whole image), and its finish's scratch: one row of k2::kSums
// doubles per block, and the ticket counter, 0 at the launch and left at 0
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
// d_offset and d_mask written, its g m_t val_t added to dw
template <bool kBf16>
__device__ __forceinline__ void k2_pixel(const float* st, const K2Tile& tl,
                                         const K2Params& p, int ctid,
                                         float (&dw)[kTaps]) {
  const int y = tl.y0 + ctid / k2::kTileW, xo = tl.x0 + ctid % k2::kTileW;
  if (y >= p.hs || xo >= p.w) return;
  const int64_t hws = static_cast<int64_t>(p.hs) * p.w;  // a slab plane
  const int64_t q = static_cast<int64_t>(y) * p.w + xo;
  float px_dw[kTaps];
  pixel_backward<kBf16, true>(
      p.x + tl.b * (static_cast<int64_t>(p.h) * p.w),
      Window{st + k2::kPlaneFloats, static_cast<float>(tl.wy0),
             static_cast<float>(tl.wx0)},
      st + ctid, st + k2::kOffFloats + ctid, k2::kTilePx, p.weight,
      p.d_offset + tl.b * (2 * kTaps) * hws + q,
      p.d_mask + tl.b * kTaps * hws + q, hws,
      st[k2::kOffFloats + k2::kMaskFloats + ctid], p.row0 + y, xo, p.h, p.w,
      p.pad, px_dw, NoScatter{});
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

// K2's d_weight and d_bias from every thread's sums (dw, gsum), in a fixed
// order: the block's sums (warp shuffles, then its kWarpsB warps in order)
// as one row of ``rows``; the block whose ticket on the counter comes last
// sums the rows in block order (one warp per value: each lane its strided
// share in double, then a fixed shuffle tree), writes d_weight and d_bias
// and sets the counter back to 0. Every thread of the block calls it. The
// last warp writes the row, fences and takes the ticket: a fence waits for
// its thread's own stores, and in the TMA path that warp, the producer, has
// written nothing else.
template <int kWarpsB>
__device__ __forceinline__ void k2_finish(const float (&dw)[kTaps],
                                          double gsum, const K2Params& p) {
  __shared__ double warp_sums[kWarpsB][k2::kSums];
  __shared__ bool last;
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
  if (warp == kWarpsB - 1) {
    if (lane < k2::kSums) {
      double s = 0.0;
#pragma unroll
      for (int k = 0; k < kWarpsB; ++k) s += warp_sums[k][lane];
      p.rows[blockIdx.x * k2::kSums + lane] = s;
      __threadfence();  // the row is visible before the ticket says so
    }
    __syncwarp();
    if (lane == 0) last = atomicAdd(p.counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
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
  if (threadIdx.x == 0) *p.counter = 0u;  // every block has its ticket
}

// K2: the persistent grid over 4 x 64 tiles of the slab (B, Hs, W) of image
// rows [row0, row0 + Hs), no input gradient, d_weight and d_bias finished
// in the kernel; kTma the TMA path (a producer warp and 256 consumers),
// else the cp.async path (256 threads that copy and compute); kBf16 the
// bf16-sampling mode
template <bool kTma, bool kBf16>
__global__ void __launch_bounds__(kTma ? k2::kThreadsTma : k2::kConsumers,
                                  k2::kBlocksPerSm)
deform_bwd_kernel(const __grid_constant__ CUtensorMap off_map,
                  const __grid_constant__ CUtensorMap mask_map,
                  const __grid_constant__ CUtensorMap g_map,
                  const __grid_constant__ CUtensorMap x_map,
                  const K2Params p) {
  using jspsr::smem_u32;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  unsigned char* smem = smem_raw + (base - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [kStages]
  uint64_t* empty = full + k2::kStages;                // [kStages]
  float* ring = reinterpret_cast<float*>(smem + k2::kBarBytes);
  constexpr int kStageStride = k2::kStageBytes / 4;  // floats

  const int tid = threadIdx.x;
  const int my_tiles =
      static_cast<int>(blockIdx.x) < p.n_tiles
          ? (p.n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
          : 0;
  float dw[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) dw[t] = 0.f;
  double gsum = 0.0;  // this lane's share of d_bias, in the summing warp

  if constexpr (kTma) {
    if (tid == 0) {
      for (int s = 0; s < k2::kStages; ++s) {
        jspsr::mbar_init(smem_u32(full + s), 1);
        // the consumer warps, and the producer once it has summed g
        jspsr::mbar_init(smem_u32(empty + s), k2::kConsumers / 32 + 1);
      }
      jspsr::mbar_init_fence();
    }
    __syncthreads();
    if (tid >= k2::kConsumers) {
      // the producer warp: lane 0 issues tile i's loads, then the warp
      // sums tile i - 1's g, which has landed, and frees its stage
      const int lane = tid - k2::kConsumers;
      constexpr uint32_t kTx = k2::kStageFloats * 4;
      for (int i = 0; i <= my_tiles; ++i) {
        if (i < my_tiles && lane == 0) {
          const int s = i % k2::kStages;
          if (i >= k2::kStages)
            jspsr::mbar_wait(smem_u32(empty + s), (i / k2::kStages - 1) & 1);
          const K2Tile tl = k2_tile(blockIdx.x + i * gridDim.x, p);
          const uint32_t bar = smem_u32(full + s);
          const uint32_t dst = smem_u32(ring + s * kStageStride);
          jspsr::mbar_expect_tx(bar, kTx);
          jspsr::tma_load_3d(dst, &off_map, tl.x0, tl.y0,
                             tl.b * 2 * kTaps, bar);
          jspsr::tma_load_3d(dst + k2::kOffFloats * 4, &mask_map, tl.x0,
                             tl.y0, tl.b * kTaps, bar);
          jspsr::tma_load_3d(dst + (k2::kOffFloats + k2::kMaskFloats) * 4,
                             &g_map, tl.x0, tl.y0, tl.b, bar);
          jspsr::tma_load_4d(dst + k2::kPlaneFloats * 4, &x_map, 0,
                             tl.wx0 / 4, tl.wy0, tl.b, bar);
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
        k2_pixel<kBf16>(ring + s * kStageStride,
                        k2_tile(blockIdx.x + i * gridDim.x, p), p, tid, dw);
        // every lane's reads of the stage are done before lane 0 frees it
        __syncwarp();
        if (tid % 32 == 0) jspsr::mbar_arrive(smem_u32(empty + s));
      }
    }
    k2_finish<k2::kThreadsTma / 32>(dw, gsum, p);
  } else {
    // the last warp sums each tile's g too
    constexpr int kSummer = k2::kConsumers / 32 - 1;
    for (int i = 0; i < my_tiles; ++i) {
      if (i == 0) k2_copy_tile(ring, k2_tile(blockIdx.x, p), p, tid);
      if (i + 1 < my_tiles) {
        k2_copy_tile(ring + ((i + 1) % k2::kStages) * kStageStride,
                     k2_tile(blockIdx.x + (i + 1) * gridDim.x, p), p, tid);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncthreads();
      const float* st = ring + (i % k2::kStages) * kStageStride;
      k2_pixel<kBf16>(st, k2_tile(blockIdx.x + i * gridDim.x, p), p, tid,
                      dw);
      if (tid / 32 == kSummer) k2_tile_gsum(st, tid % 32, gsum);
      // the stage is refilled two tiles on
      __syncthreads();
    }
    k2_finish<k2::kConsumers / 32>(dw, gsum, p);
  }
}

// K3: one block per 8 x 32 tile of one image's slab of image rows [row0,
// row0 + hs) (the whole image: hs = h, row0 = 0), d_x through the window
// into the whole image's fixed-point accumulator ``d_x_fixed``, scaled by
// the image's L1 bound in ``bound``; kBf16 the bf16-sampling mode (its d_x
// is the fp32 mode's)
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
deform_bwd_dx_kernel(const float* __restrict__ x,
                     const float* __restrict__ offset,
                     const float* __restrict__ mask,
                     const float* __restrict__ weight,
                     const float* __restrict__ grad_out,
                     const double* __restrict__ bound,
                     float* __restrict__ d_offset, float* __restrict__ d_mask,
                     float* __restrict__ d_weight_partial,
                     unsigned long long* __restrict__ d_x_fixed, int h, int w,
                     int tiles_x, int tiles_y, int pad, int hs, int row0) {
  __shared__ unsigned win_lo[kWinH * kWinW];
  __shared__ unsigned win_hi[kWinH * kWinW];
  const int64_t blk = blockIdx.x;
  const int tx_i = static_cast<int>(blk % tiles_x);
  const int64_t rest = blk / tiles_x;
  const int ty_i = static_cast<int>(rest % tiles_y);
  const int64_t b = rest / tiles_y;
  // the tile's first row in the slab, and in the image
  const int ty0 = ty_i * kTileH, tx0 = tx_i * kTileW;
  const int iy0 = row0 + ty0;
  const int ys = ty0 + threadIdx.x / kTileW;  // the pixel's slab row
  const int xo = tx0 + threadIdx.x % kTileW;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t hws = static_cast<int64_t>(hs) * w;  // a slab plane
  unsigned long long* dimg = d_x_fixed + b * hw;
  // not ok: the last pass writes NaN, the scatter's values do not matter
  const FixedScale fs = fixed_scale(bound[b]);

  for (int e = threadIdx.x; e < kWinH * kWinW; e += kThreads) {
    win_lo[e] = 0u;
    win_hi[e] = 0u;
  }
  __syncthreads();

  float dw[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) dw[t] = 0.f;
  // no early return: every thread takes part in the barriers below
  if (ys < hs && xo < w) {
    const int64_t p = static_cast<int64_t>(ys) * w + xo;
    const WindowScatter scatter{win_lo, win_hi, dimg, fs.scale,
                                iy0 - kMargin, tx0 - kMargin, w};
    pixel_backward<kBf16, false>(
        x + b * hw, Window{}, offset + b * (2 * kTaps) * hws + p,
        mask + b * kTaps * hws + p, hws, weight,
        d_offset + b * (2 * kTaps) * hws + p, d_mask + b * kTaps * hws + p,
        hws, grad_out[b * hws + p], row0 + ys, xo, h, w, pad, dw, scatter);
  }
  // its __syncthreads also ends every scatter into the window
  block_dweight(dw, d_weight_partial + blk * kTaps);

  for (int e = threadIdx.x; e < kWinH * kWinW; e += kThreads) {
    const unsigned long long v =
        (static_cast<unsigned long long>(win_hi[e]) << 32) | win_lo[e];
    const int yc = iy0 - kMargin + e / kWinW;
    const int xc = tx0 - kMargin + e % kWinW;
    if (v != 0ull && yc >= 0 && yc < h && xc >= 0 && xc < w)
      atomicAdd(dimg + static_cast<int64_t>(yc) * w + xc, v);
  }
}

// A block's sum of one double per thread, in a fixed order (a warp
// shuffle tree, then the warps' sums in turn); thread 0 holds the result.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sum[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 1; k < kWarps; ++k) v += warp_sum[k];
  }
  return v;
}

// K3's first pass: one block per chunk of kBoundChunk pixels of one image
// (``chunks`` per image) writes the chunk's sum of |g_p| * sum_t |w_t|
// |m_{p,t}| to ``part`` (NaN and inf carry through); the block that counts
// itself last on ``done`` (zeroed by the caller) then sums each image's
// partials in a fixed order into ``bound`` (one warp per image: each lane
// its strided share in order, then a fixed shuffle tree).
__global__ void __launch_bounds__(kThreads)
dx_bounds_kernel(const float* __restrict__ grad_out,
                 const float* __restrict__ weight,
                 const float* __restrict__ mask, int64_t batch, int64_t hw,
                 int64_t chunks, double* __restrict__ part,
                 double* __restrict__ bound, unsigned* __restrict__ done) {
  __shared__ bool last;
  const int64_t b = blockIdx.x / chunks;
  const int64_t p0 = (blockIdx.x % chunks) * kBoundChunk;
  const int64_t p1 = p0 + kBoundChunk < hw ? p0 + kBoundChunk : hw;
  float aw[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) aw[t] = fabsf(__ldg(weight + t));
  const float* g = grad_out + b * hw;
  const float* m = mask + b * kTaps * hw;
  double s = 0.0;
  for (int64_t p = p0 + threadIdx.x; p < p1; p += kThreads) {
    float wm = 0.f;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) wm += aw[t] * fabsf(m[t * hw + p]);
    s += static_cast<double>(fabsf(g[p])) * static_cast<double>(wm);
  }
  s = block_sum(s);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = s;
    __threadfence();  // the partial is visible before the count says so
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  const int lane = threadIdx.x & 31;
  for (int64_t img = threadIdx.x >> 5; img < batch; img += kWarps) {
    double v = 0.0;
    for (int64_t c = lane; c < chunks; c += 32)
      v += __ldcg(part + img * chunks + c);  // from L2, past this SM's L1
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) bound[img] = v;
  }
}

// K3's last pass: the fixed-point accumulator back to fp32, one rounding
// (int64 -> double is exact below 2^53; above, double then float round);
// ``per_image`` blocks stride over each image's hw pixels
__global__ void __launch_bounds__(kThreads)
dx_fixed_to_float_kernel(const long long* __restrict__ d_x_fixed,
                         const double* __restrict__ bound,
                         float* __restrict__ d_x, int64_t hw,
                         int64_t per_image) {
  const int64_t b = blockIdx.x / per_image;
  const FixedScale fs = fixed_scale(bound[b]);
  const long long* acc = d_x_fixed + b * hw;
  float* out = d_x + b * hw;
  for (int64_t i = (blockIdx.x % per_image) * kThreads + threadIdx.x; i < hw;
       i += per_image * kThreads)
    out[i] = fs.ok ? static_cast<float>(static_cast<double>(acc[i]) * fs.inv)
                   : __int_as_float(0x7fc00000);
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

// the rows of K2's finish on the current device: one per block of its
// persistent grid, at most kBlocksPerSm per SM (0 where the runtime cannot
// count the SMs)
int64_t k2_rows(int64_t batch, int hs, int w) {
  return std::min<int64_t>(k2_tiles(batch, hs, w),
                           int64_t{jspsr::sm_count()} * k2::kBlocksPerSm);
}

// the kernel's dynamic shared-memory allowance, set once per device, and
// how many of its blocks one SM holds
template <bool kTma, bool kBf16>
cudaError_t k2_prepare(int* blocks) {
  static int resident[64] = {};  // per device, 0 until asked
  return jspsr::resident_blocks(
      deform_bwd_kernel<kTma, kBf16>,
      kTma ? k2::kThreadsTma : k2::kConsumers, k2::kSmem, resident, blocks);
}

// K2 on the slab of image rows [y0, y0 + hs) (the whole image: hs = h,
// y0 = 0), as jspsr_deform_bwd describes it
template <bool kBf16>
int launch_k2(const float* x, const float* offset, const float* mask,
              const float* weight, const float* grad_out, float* d_offset,
              float* d_mask, float* d_weight, float* d_bias, double* rows,
              unsigned* counter, int64_t batch, int h, int w, int pad, int hs,
              int y0, void* stream) {
  if (y0 < 0 || hs < 0 || y0 > h - hs)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || hs == 0 || w == 0) return 0;
  const int64_t n_tiles = k2_tiles(batch, hs, w);
  if (n_tiles >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = jspsr::sm_count();
  if (sms == 0) return static_cast<int>(cudaGetLastError());
  const bool tma = k2_use_tma(x, offset, mask, grad_out, w);
  int blocks = 0;
  const cudaError_t err = tma ? k2_prepare<true, kBf16>(&blocks)
                              : k2_prepare<false, kBf16>(&blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: every block resident at once, none without a tile, no
  // more than k2_rows sized the rows for
  const int64_t slots =
      static_cast<int64_t>(sms) * std::min(blocks, k2::kBlocksPerSm);
  const int grid = static_cast<int>(std::min(n_tiles, slots));
  const int tiles_x = (w + k2::kTileW - 1) / k2::kTileW;
  const int tiles_y = (hs + k2::kTileH - 1) / k2::kTileH;
  const K2Params p{x,      offset,  mask, weight, grad_out, d_offset,
                   d_mask, d_weight, d_bias, rows, counter, h,
                   w,      pad,     hs,   y0,     tiles_x,  tiles_y,
                   static_cast<int>(n_tiles)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap maps[4] = {};
  if (tma) {
    const jspsr::EncodeTiled encode = jspsr::encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    using jspsr::encode_planes;
    if (encode_planes(encode, &maps[0], offset, w, hs, batch * 2 * kTaps,
                      k2::kTileW, k2::kTileH, 2 * kTaps) != CUDA_SUCCESS ||
        encode_planes(encode, &maps[1], mask, w, hs, batch * kTaps,
                      k2::kTileW, k2::kTileH, kTaps) != CUDA_SUCCESS ||
        encode_planes(encode, &maps[2], grad_out, w, hs, batch, k2::kTileW,
                      k2::kTileH, 1) != CUDA_SUCCESS ||
        jspsr::encode_window(encode, &maps[3], x, w, h, batch, k2::kWinH,
                             k2::kWinW) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
    deform_bwd_kernel<true, kBf16><<<grid, k2::kThreadsTma, k2::kSmem, s>>>(
        maps[0], maps[1], maps[2], maps[3], p);
  } else {
    deform_bwd_kernel<false, kBf16><<<grid, k2::kConsumers, k2::kSmem, s>>>(
        maps[0], maps[1], maps[2], maps[3], p);
  }
  return static_cast<int>(cudaGetLastError());
}

int64_t k3_tiles_x(int w) { return (w + kTileW - 1) / kTileW; }
int64_t k3_tiles_y(int h) { return (h + kTileH - 1) / kTileH; }

// K3 on the slab of image rows [y0, y0 + hs) (the whole image: hs = h,
// y0 = 0): the bounds pass over the slab's pixels, the kernel and the last
// pass over the whole image on ``stream``, through ``scratch``
// (jspsr_deform_bwd_dx_scratch words); d_x (B,1,H,W) is written by the last
// pass.
template <bool kBf16>
int launch_k3(const float* x, const float* offset, const float* mask,
              const float* weight, const float* grad_out, float* d_offset,
              float* d_mask, float* d_weight_partial, long long* scratch,
              float* d_x, int64_t batch, int h, int w, int pad, int hs,
              int y0, void* stream) {
  if (y0 < 0 || hs < 0 || y0 > h - hs)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = batch * k3_tiles_y(hs) * k3_tiles_x(w);
  if (blocks == 0) return 0;
  if (blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t hws = static_cast<int64_t>(hs) * w;
  const int64_t chunks = k3_chunks(hws);
  double* bound = reinterpret_cast<double*>(scratch + batch * hw);
  double* part = bound + batch;
  unsigned* done = reinterpret_cast<unsigned*>(part + batch * chunks);
  dx_bounds_kernel<<<static_cast<unsigned int>(batch * chunks), kThreads, 0,
                     s>>>(grad_out, weight, mask, batch, hws, chunks, part,
                          bound, done);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  deform_bwd_dx_kernel<kBf16>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
      x, offset, mask, weight, grad_out, bound, d_offset, d_mask,
      d_weight_partial, reinterpret_cast<unsigned long long*>(scratch), h, w,
      static_cast<int>(k3_tiles_x(w)), static_cast<int>(k3_tiles_y(hs)), pad,
      hs, y0);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  // about 16 blocks per SM over the batch, at most one per 256 pixels
  const int64_t per_image = std::max<int64_t>(
      1, std::min<int64_t>((hw + kThreads - 1) / kThreads,
                           (132 * 16 + batch - 1) / batch));
  dx_fixed_to_float_kernel<<<static_cast<unsigned int>(batch * per_image),
                             kThreads, 0, s>>>(
      scratch, bound, d_x, hw, per_image);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The rows of a launch's scratch. K2 (need_dx 0): one row of d_weight's 9
// sums and d_bias's per block of its persistent grid on the current device
// (jspsr_deform_bwd's ``rows``); K3 (need_dx 1): one row of 9 d_weight
// partials per 8 x 32 tile of each image's slab of H rows. H is a slab's
// rows.
extern "C" int64_t jspsr_deform_bwd_blocks(int need_dx, int64_t batch, int h,
                                           int w) {
  return need_dx ? batch * k3_tiles_y(h) * k3_tiles_x(w)
                 : k2_rows(batch, h, w);
}

// K3's tile (rows, columns) and window margin, in that order.
extern "C" void jspsr_deform_bwd_dx_window(int* out) {
  out[0] = kTileH;
  out[1] = kTileW;
  out[2] = kMargin;
}

// Plain C entry points, bound from Python with ctypes. All tensors are
// contiguous fp32 on the current device: x (B,1,H,W), offset (B,18,H,W),
// mask (B,9,H,W), weight (9,), grad_out (B,1,H,W); outputs d_offset
// (B,18,H,W), d_mask (B,9,H,W) and, for jspsr_deform_bwd_dx, d_weight's
// partials (jspsr_deform_bwd_blocks rows of 9, summed by the caller) and
// d_x (B,1,H,W) through the accumulator described there. Each takes a row
// slab: offset, mask, grad_out, d_offset and d_mask of hs rows, image rows
// [y0, y0 + hs) of x (hs = h, y0 = 0: the whole image); d_x is the whole
// image's (B,1,H,W) either way. Each launches on ``stream`` without
// synchronising and returns cudaGetLastError() (cudaErrorNotSupported
// where libcuda has no tensor-map encoder and K2's shape needs one).
//
// K2 writes d_weight (9,) and d_bias (1,) itself, in one launch, through
// ``rows`` (jspsr_deform_bwd_blocks(0, ...) rows of 10 doubles, written
// before they are read) and ``counter``, one unsigned int that is 0 when
// the kernel starts and that its last block sets back to 0. One counter
// serves every K2 launch on one stream: the launches of a stream run one
// after the other, each leaves the counter at 0 for the next, and no other
// kernel touches it. Two streams need two counters, as two launches on
// them may run at once.
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

// K3's scratch, in int64 words, all zeroed by the caller: the whole
// images' d_x accumulator (B*H*W), the images' L1 bounds (B doubles), the
// bounds pass's partials (one double per chunk of each image's slab of hs
// rows) and its counter.
extern "C" int64_t jspsr_deform_bwd_dx_scratch(int64_t batch, int h, int w,
                                               int hs) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  return batch * (hw + 1 + k3_chunks(static_cast<int64_t>(hs) * w)) + 1;
}

// K3: as described at launch_k3. All tensors as for jspsr_deform_bwd (the
// same row slab), plus ``scratch`` and d_x (B,1,H,W), the whole images'.
extern "C" int jspsr_deform_bwd_dx(const float* x, const float* offset,
                                   const float* mask, const float* weight,
                                   const float* grad_out, float* d_offset,
                                   float* d_mask, float* d_weight_partial,
                                   long long* scratch, float* d_x,
                                   int64_t batch, int h, int w, int pad,
                                   int hs, int y0, void* stream) {
  return launch_k3<false>(x, offset, mask, weight, grad_out, d_offset,
                          d_mask, d_weight_partial, scratch, d_x, batch, h,
                          w, pad, hs, y0, stream);
}

// K3's bf16-sampling mode: as jspsr_deform_bwd_dx.
extern "C" int jspsr_deform_bwd_dx_bf16(const float* x, const float* offset,
                                        const float* mask,
                                        const float* weight,
                                        const float* grad_out,
                                        float* d_offset, float* d_mask,
                                        float* d_weight_partial,
                                        long long* scratch, float* d_x,
                                        int64_t batch, int h, int w, int pad,
                                        int hs, int y0, void* stream) {
  return launch_k3<true>(x, offset, mask, weight, grad_out, d_offset, d_mask,
                         d_weight_partial, scratch, d_x, batch, h, w, pad,
                         hs, y0, stream);
}
