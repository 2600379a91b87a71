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
// keeps a fp32 window of (8 + 2M) x (32 + 2M) cells around it, M = 4. A
// corner inside the window is added there (a shared-memory atomicAdd);
// one outside it (an offset beyond about M - 1 px from the tile, or a
// tile at the image edge) goes to the global atomicAdd into the d_x that
// the caller zeroes; off-image corners still receive nothing. After a
// barrier every in-image window cell that is not 0 is flushed with one
// global atomicAdd: windows of neighbouring tiles overlap, so the flush
// stays atomic. At NLSPN's offsets of about 1.5 px that takes the global
// atomics from up to 36 per pixel (4 corners x 9 taps) to at most 640 /
// 256 = 2.5 flushes plus the few corners that leave the window
// (ops/deform_cuda.py::dx_atomics counts both from the offsets). Blocks
// run in no order on this card, so nothing like the TPU's carried
// accumulator exists; an inverse gather over a fixed window is not exact
// because offsets are unbounded (tests use 20 px). The order of the
// atomic sums changes from run to run, so d_x is not bitwise
// reproducible; it agrees with a fixed-order sum to within fp32 rounding
// of the sum of the terms' magnitudes. A deterministic form would sort
// the contributions by target pixel or accumulate in fixed point.
//
// Bound on this card: bytes, or the atomics. Each pixel reads 18 offsets
// (72 B), 9 mask values (36 B), g (4 B) and its image neighbourhood (4 B
// new per pixel; the re-reads of neighbours hit L1/L2), and writes 18
// offset gradients (72 B) and 9 mask gradients (36 B): about 224 B against
// about 300 FLOP; d_x adds its zero fill and its write-back (8 B). K3's up
// to 36 corner contributions per pixel now go to shared-memory atomics,
// which bind: this card has no native shared fp32 add (the SASS is a
// compare-and-swap loop); about 2 per pixel reach L2. The design keeps
// the traffic at that minimum:
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

// K2 scatters nothing
struct NoScatter {
  __device__ void operator()(int, int, float) const {}
};

// K3: into the block's window where the corner lies inside it, else
// straight to d_x
struct WindowScatter {
  float* win;   // [kWinH][kWinW], shared
  float* dimg;  // this image's d_x
  int wy0, wx0, w;
  __device__ void operator()(int yc, int xc, float v) const {
    const int ry = yc - wy0, rx = xc - wx0;
    if (static_cast<unsigned>(ry) < kWinH && static_cast<unsigned>(rx) < kWinW)
      atomicAdd(win + ry * kWinW + rx, v);
    else
      atomicAdd(dimg + static_cast<int64_t>(yc) * w + xc, v);
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

// K3: one block per 8 x 32 tile of one image, d_x through the window
__global__ void __launch_bounds__(kThreads)
deform_bwd_dx_kernel(const float* __restrict__ x,
                     const float* __restrict__ offset,
                     const float* __restrict__ mask,
                     const float* __restrict__ weight,
                     const float* __restrict__ grad_out,
                     float* __restrict__ d_offset, float* __restrict__ d_mask,
                     float* __restrict__ d_weight_partial,
                     float* __restrict__ d_x, int h, int w, int tiles_x,
                     int tiles_y, int pad) {
  __shared__ float win[kWinH * kWinW];
  const int64_t blk = blockIdx.x;
  const int tx_i = static_cast<int>(blk % tiles_x);
  const int64_t rest = blk / tiles_x;
  const int ty_i = static_cast<int>(rest % tiles_y);
  const int64_t b = rest / tiles_y;
  const int ty0 = ty_i * kTileH, tx0 = tx_i * kTileW;
  const int y = ty0 + threadIdx.x / kTileW;
  const int xo = tx0 + threadIdx.x % kTileW;
  const int64_t hw = static_cast<int64_t>(h) * w;
  float* dimg = d_x + b * hw;

  for (int e = threadIdx.x; e < kWinH * kWinW; e += kThreads) win[e] = 0.f;
  __syncthreads();

  float dw[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) dw[t] = 0.f;
  // no early return: every thread takes part in the barriers below
  if (y < h && xo < w) {
    const int64_t p = static_cast<int64_t>(y) * w + xo;
    const WindowScatter scatter{win, dimg, ty0 - kMargin, tx0 - kMargin, w};
    pixel_backward(x + b * hw, offset + b * (2 * kTaps) * hw + p,
                   mask + b * kTaps * hw + p, weight,
                   d_offset + b * (2 * kTaps) * hw + p,
                   d_mask + b * kTaps * hw + p, grad_out[b * hw + p], y, xo,
                   h, w, hw, pad, dw, scatter);
  }
  // its __syncthreads also ends every scatter into the window
  block_dweight(dw, d_weight_partial + blk * kTaps);

  for (int e = threadIdx.x; e < kWinH * kWinW; e += kThreads) {
    const float v = win[e];
    const int yc = ty0 - kMargin + e / kWinW;
    const int xc = tx0 - kMargin + e % kWinW;
    if (v != 0.f && yc >= 0 && yc < h && xc >= 0 && xc < w)
      atomicAdd(dimg + static_cast<int64_t>(yc) * w + xc, v);
  }
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
// rows, 9) and, for jspsr_deform_bwd_dx, d_x (B,1,H,W), which the caller
// must zero first. Each launches on ``stream`` without synchronising and
// returns cudaGetLastError().
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

extern "C" int jspsr_deform_bwd_dx(const float* x, const float* offset,
                                   const float* mask, const float* weight,
                                   const float* grad_out, float* d_offset,
                                   float* d_mask, float* d_weight_partial,
                                   float* d_x, int64_t batch, int h, int w,
                                   int pad, void* stream) {
  const int64_t blocks = jspsr_deform_bwd_blocks(1, batch, h, w);
  if (blocks == 0) return 0;
  if (blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  deform_bwd_dx_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, offset, mask, weight, grad_out, d_offset, d_mask, d_weight_partial,
      d_x, h, w, static_cast<int>(k3_tiles_x(w)),
      static_cast<int>(k3_tiles_y(h)), pad);
  return static_cast<int>(cudaGetLastError());
}
