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
// and, in the kNeedDx form only, the input gradient: every tap scatters
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
// (kNeedDx = false, K2: the SPN head detaches the DEM) and need_dx=True
// (kNeedDx = true, K3: NLSPN propagates a feature that needs its gradient).
// The TPU kernel builds the corner one-hots and their differences
// (oy1 - oy0, ox1 - ox0) as (H, P) matrices for the MXU, and forms d_x as
// one more matmul per tap into an (H, W) accumulator that a sequential
// ("arbitrary") row-block grid axis carries from block to block. Here the
// corners are gathered directly, as in deform_fwd.cu, and d_x is a scatter.
//
// The scatter is float atomicAdd into a d_x that the caller zeroes: up to
// 36 atomics per pixel (4 corners x 9 taps), to addresses that neighbouring
// threads share. Blocks run in no order on this card, so nothing like the
// TPU's carried accumulator exists; an inverse gather over a fixed window
// is not exact because offsets are unbounded (tests use 20 px). The order
// of the atomic sums changes from run to run, so d_x is not bitwise
// reproducible; it agrees with a fixed-order sum to within fp32 rounding
// of the sum of the terms' magnitudes. A deterministic form would sort the
// contributions by target pixel or accumulate in fixed point.
//
// Bound on this card: bytes, or the atomics. Each pixel reads 18 offsets
// (72 B), 9 mask values (36 B), g (4 B) and its image neighbourhood (4 B
// new per pixel; the re-reads of neighbours hit L1/L2), and writes 18
// offset gradients (72 B) and 9 mask gradients (36 B): about 224 B against
// about 300 FLOP; d_x adds its zero fill and its write-back (8 B) and 36
// atomic adds, which resolve in L2. The design keeps the traffic at that
// minimum:
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

template <bool kNeedDx>
__global__ void __launch_bounds__(kThreads)
deform_bwd_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                  const float* __restrict__ mask,
                  const float* __restrict__ weight,
                  const float* __restrict__ grad_out,
                  float* __restrict__ d_offset, float* __restrict__ d_mask,
                  float* __restrict__ d_weight_partial, float* __restrict__ d_x,
                  int64_t n, int h, int w, int pad) {
  __shared__ float warp_sums[kWarps][kTaps];
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

    const float* img = x + b * hw;
    float* dimg = kNeedDx ? d_x + b * hw : nullptr;
    const float* off = offset + b * (2 * kTaps) * hw + p;
    const float* msk = mask + b * kTaps * hw + p;
    float* doff = d_offset + b * (2 * kTaps) * hw + p;
    float* dmsk = d_mask + b * kTaps * hw + p;
    const float hmax = static_cast<float>(h - 1);
    const float wmax = static_cast<float>(w - 1);
    const float g = grad_out[i];

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
        if (kNeedDx) {
          const float gy0 = gwm * (1.f - ty), gy1 = gwm * ty;
          if (vy0 && vx0) atomicAdd(dimg + r0 + x0, gy0 * (1.f - tx));
          if (vy0 && vx1) atomicAdd(dimg + r0 + x0 + 1, gy0 * tx);
          if (vy1 && vx0) atomicAdd(dimg + r1 + x0, gy1 * (1.f - tx));
          if (vy1 && vx1) atomicAdd(dimg + r1 + x0 + 1, gy1 * tx);
        }
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
    d_weight_partial[static_cast<int64_t>(blockIdx.x) * kTaps + threadIdx.x] = s;
  }
}

template <bool kNeedDx>
int launch(const float* x, const float* offset, const float* mask,
           const float* weight, const float* grad_out, float* d_offset,
           float* d_mask, float* d_weight_partial, float* d_x, int64_t batch,
           int h, int w, int pad, void* stream) {
  const int64_t n = batch * h * w;
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  deform_bwd_kernel<kNeedDx><<<static_cast<unsigned int>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      x, offset, mask, weight, grad_out, d_offset, d_mask, d_weight_partial,
      d_x, n, h, w, pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Threads per block; the caller sizes d_weight_partial as
// (ceil(batch*h*w / threads), 9).
extern "C" int jspsr_deform_bwd_threads() { return kThreads; }

// Plain C entry points, bound from Python with ctypes. All tensors are
// contiguous fp32 on the current device: x (B,1,H,W), offset (B,18,H,W),
// mask (B,9,H,W), weight (9,), grad_out (B,1,H,W); outputs d_offset
// (B,18,H,W), d_mask (B,9,H,W), d_weight_partial (n_blocks, 9) and, for
// jspsr_deform_bwd_dx, d_x (B,1,H,W), which the caller must zero first.
// Each launches on ``stream`` without synchronising and returns
// cudaGetLastError().
extern "C" int jspsr_deform_bwd(const float* x, const float* offset,
                                const float* mask, const float* weight,
                                const float* grad_out, float* d_offset,
                                float* d_mask, float* d_weight_partial,
                                int64_t batch, int h, int w, int pad,
                                void* stream) {
  return launch<false>(x, offset, mask, weight, grad_out, d_offset, d_mask,
                       d_weight_partial, nullptr, batch, h, w, pad, stream);
}

extern "C" int jspsr_deform_bwd_dx(const float* x, const float* offset,
                                   const float* mask, const float* weight,
                                   const float* grad_out, float* d_offset,
                                   float* d_mask, float* d_weight_partial,
                                   float* d_x, int64_t batch, int h, int w,
                                   int pad, void* stream) {
  return launch<true>(x, offset, mask, weight, grad_out, d_offset, d_mask,
                      d_weight_partial, d_x, batch, h, w, pad, stream);
}
