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
// because offsets are unbounded (tests use 20 px).
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
// new per pixel; the re-reads of neighbours hit L1/L2), and writes 18
// offset gradients (72 B) and 9 mask gradients (36 B): about 224 B against
// about 300 FLOP; d_x adds the bounds pass's second read of g and the
// mask (40 B), its accumulator's zero fill (8 B), its read and its fp32
// write-back (12 B). K3's up to 36 corner contributions per pixel go to
// pairs of native 32-bit shared-memory atomics; about 2 per pixel reach
// L2.
// The design keeps the traffic at that minimum:
//   - one thread per output pixel, planar NCHW, so every offset, mask and
//     gradient access of a warp is one coalesced 128-byte line;
//   - positions and corners are recomputed from the inputs rather than
//     saved by the forward (saving them would cost more bytes than the
//     arithmetic costs time);
//   - d_weight is reduced in the block: a warp-shuffle sum, then the
//     block's warps summed in shared memory in a fixed order, one row of 9
//     partials per block written to `d_weight_partial`; the caller sums
//     the (n_blocks, 9) rows outside the kernel. No float atomics there, so
//     d_weight is the same on every run.
//
// Positions are tested against the image in float before any float->int
// conversion, exactly as in the forward.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cfloat>

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

// One output pixel's 9 taps: writes d_offset and d_mask, accumulates
// g m_t val_t into dw and hands every in-bounds corner's share of d_x to
// ``scatter``. ``off``, ``msk``, ``doff`` and ``dmsk`` point at the pixel
// in channel 0 of its image.
template <class Scatter>
__device__ __forceinline__ void pixel_backward(
    const float* __restrict__ img, const float* __restrict__ off,
    const float* __restrict__ msk, const float* __restrict__ weight,
    float* __restrict__ doff, float* __restrict__ dmsk, float g, int y,
    int xo, int h, int w, int64_t hw, int pad, float (&dw)[kTaps],
    const Scatter& scatter) {
  const float hmax = static_cast<float>(h - 1);
  const float wmax = static_cast<float>(w - 1);
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const float py = static_cast<float>(y - pad + t / 3) + off[(2 * t) * hw];
    const float px =
        static_cast<float>(xo - pad + t % 3) + off[(2 * t + 1) * hw];
    const float m = msk[t * hw];
    const float y0f = floorf(py);
    const float x0f = floorf(px);
    const float ty = py - y0f;
    const float tx = px - x0f;
    const float gw = g * __ldg(weight + t);
    const float gwm = gw * m;
    float v00 = 0.f, v01 = 0.f, v10 = 0.f, v11 = 0.f;
    if (y0f >= -1.f && y0f <= hmax && x0f >= -1.f && x0f <= wmax) {
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
    const float top = (1.f - tx) * v00 + tx * v01;
    const float bot = (1.f - tx) * v10 + tx * v11;
    const float val = (1.f - ty) * top + ty * bot;
    dmsk[t * hw] = gw * val;
    doff[(2 * t) * hw] = gwm * (bot - top);
    doff[(2 * t + 1) * hw] =
        gwm * ((1.f - ty) * (v01 - v00) + ty * (v11 - v10));
    dw[t] = g * m * val;
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

// K2: one thread per pixel of the flattened (B, H, W), no input gradient
__global__ void __launch_bounds__(kThreads)
deform_bwd_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                  const float* __restrict__ mask,
                  const float* __restrict__ weight,
                  const float* __restrict__ grad_out,
                  float* __restrict__ d_offset, float* __restrict__ d_mask,
                  float* __restrict__ d_weight_partial, int64_t n, int h,
                  int w, int pad) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float dw[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) dw[t] = 0.f;

  // no early return: every thread takes part in the block reduction below
  if (i < n) {
    const int64_t hw = static_cast<int64_t>(h) * w;
    const int64_t b = i / hw;
    const int64_t p = i - b * hw;
    const int y = static_cast<int>(p / w);
    const int xo = static_cast<int>(p - static_cast<int64_t>(y) * w);
    pixel_backward(x + b * hw, offset + b * (2 * kTaps) * hw + p,
                   mask + b * kTaps * hw + p, weight,
                   d_offset + b * (2 * kTaps) * hw + p,
                   d_mask + b * kTaps * hw + p, grad_out[i], y, xo, h, w, hw,
                   pad, dw, NoScatter{});
  }
  block_dweight(dw,
                d_weight_partial + static_cast<int64_t>(blockIdx.x) * kTaps);
}

// K3: one block per 8 x 32 tile of one image, d_x through the window into
// the fixed-point accumulator ``d_x_fixed``, scaled by the image's L1
// bound in ``bound``
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
                     int tiles_x, int tiles_y, int pad) {
  __shared__ unsigned win_lo[kWinH * kWinW];
  __shared__ unsigned win_hi[kWinH * kWinW];
  const int64_t blk = blockIdx.x;
  const int tx_i = static_cast<int>(blk % tiles_x);
  const int64_t rest = blk / tiles_x;
  const int ty_i = static_cast<int>(rest % tiles_y);
  const int64_t b = rest / tiles_y;
  const int ty0 = ty_i * kTileH, tx0 = tx_i * kTileW;
  const int y = ty0 + threadIdx.x / kTileW;
  const int xo = tx0 + threadIdx.x % kTileW;
  const int64_t hw = static_cast<int64_t>(h) * w;
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
  if (y < h && xo < w) {
    const int64_t p = static_cast<int64_t>(y) * w + xo;
    const WindowScatter scatter{win_lo, win_hi, dimg, fs.scale,
                                ty0 - kMargin, tx0 - kMargin, w};
    pixel_backward(x + b * hw, offset + b * (2 * kTaps) * hw + p,
                   mask + b * kTaps * hw + p, weight,
                   d_offset + b * (2 * kTaps) * hw + p,
                   d_mask + b * kTaps * hw + p, grad_out[b * hw + p], y, xo,
                   h, w, hw, pad, dw, scatter);
  }
  // its __syncthreads also ends every scatter into the window
  block_dweight(dw, d_weight_partial + blk * kTaps);

  for (int e = threadIdx.x; e < kWinH * kWinW; e += kThreads) {
    const unsigned long long v =
        (static_cast<unsigned long long>(win_hi[e]) << 32) | win_lo[e];
    const int yc = ty0 - kMargin + e / kWinW;
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

int64_t k2_blocks(int64_t batch, int h, int w) {
  return (batch * h * w + kThreads - 1) / kThreads;
}

int64_t k3_tiles_x(int w) { return (w + kTileW - 1) / kTileW; }
int64_t k3_tiles_y(int h) { return (h + kTileH - 1) / kTileH; }

}  // namespace

// Blocks of a launch, which is the number of d_weight partial rows the
// caller allocates: K2 (need_dx 0) one per 256 pixels of the flattened
// (B, H, W); K3 (need_dx 1) one per 8 x 32 tile of each image.
extern "C" int64_t jspsr_deform_bwd_blocks(int need_dx, int64_t batch, int h,
                                           int w) {
  return need_dx ? batch * k3_tiles_y(h) * k3_tiles_x(w)
                 : k2_blocks(batch, h, w);
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
// (B,18,H,W), d_mask (B,9,H,W), d_weight_partial (jspsr_deform_bwd_blocks
// rows, 9) and, for jspsr_deform_bwd_dx, d_x (B,1,H,W) through the
// accumulator described there. Each launches on ``stream`` without
// synchronising and returns cudaGetLastError().
extern "C" int jspsr_deform_bwd(const float* x, const float* offset,
                                const float* mask, const float* weight,
                                const float* grad_out, float* d_offset,
                                float* d_mask, float* d_weight_partial,
                                int64_t batch, int h, int w, int pad,
                                void* stream) {
  const int64_t n = batch * h * w;
  if (n == 0) return 0;
  deform_bwd_kernel<<<static_cast<unsigned int>(k2_blocks(batch, h, w)),
                      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, offset, mask, weight, grad_out, d_offset, d_mask, d_weight_partial,
      n, h, w, pad);
  return static_cast<int>(cudaGetLastError());
}

// K3's scratch, in int64 words, all zeroed by the caller: the d_x
// accumulator (B*H*W), the images' L1 bounds (B doubles), the bounds
// pass's partials (one double per chunk of each image) and its counter.
extern "C" int64_t jspsr_deform_bwd_dx_scratch(int64_t batch, int h, int w) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  return batch * (hw + 1 + k3_chunks(hw)) + 1;
}

// K3: the bounds pass, the kernel and the last pass on ``stream``, through
// ``scratch`` (jspsr_deform_bwd_dx_scratch words); d_x (B,1,H,W) is written
// by the last pass.
extern "C" int jspsr_deform_bwd_dx(const float* x, const float* offset,
                                   const float* mask, const float* weight,
                                   const float* grad_out, float* d_offset,
                                   float* d_mask, float* d_weight_partial,
                                   long long* scratch, float* d_x,
                                   int64_t batch, int h, int w, int pad,
                                   void* stream) {
  const int64_t blocks = jspsr_deform_bwd_blocks(1, batch, h, w);
  if (blocks == 0) return 0;
  if (blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t chunks = k3_chunks(hw);
  double* bound = reinterpret_cast<double*>(scratch + batch * hw);
  double* part = bound + batch;
  unsigned* done = reinterpret_cast<unsigned*>(part + batch * chunks);
  dx_bounds_kernel<<<static_cast<unsigned int>(batch * chunks), kThreads, 0,
                     s>>>(grad_out, weight, mask, batch, hw, chunks, part,
                          bound, done);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  deform_bwd_dx_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
      x, offset, mask, weight, grad_out, bound, d_offset, d_mask,
      d_weight_partial, reinterpret_cast<unsigned long long*>(scratch), h, w,
      static_cast<int>(k3_tiles_x(w)), static_cast<int>(k3_tiles_y(h)), pad);
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
