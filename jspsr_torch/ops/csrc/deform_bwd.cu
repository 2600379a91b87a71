// Modulated deformable convolution backward for the SPN refinement head,
// without the input gradient: one input and one output channel, 3x3 kernel,
// stride 1, dilation 1. The forward is deform_fwd.cu:
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
// The offset derivative is the floor-based one: the corners are fixed by
// floor(p) and only the fractional part moves, so at an integer position
// (ty = 0, the zero-offset init of the SPN generator) d/dy is the forward
// difference v10 - v00, never the tent subgradient 0 that would freeze
// offset learning. Off-image corners are 0, as in the forward. There is no
// d_x: the SPN head detaches the DEM, so the input scatter is never needed
// here (the TPU kernel's need_dx=True form is not this kernel).
//
// Replaces: jspsr_tpu/ops/pallas_deform.py::_bwd_kernel with need_dx=False.
// The TPU kernel builds the corner one-hots and their differences
// (oy1 - oy0, ox1 - ox0) as (H, P) matrices for the MXU. Here the corners
// are gathered directly, as in deform_fwd.cu.
//
// Bound on this card: bytes. Each pixel reads 18 offsets (72 B), 9 mask
// values (36 B), g (4 B) and its image neighbourhood (4 B new per pixel;
// the re-reads of neighbours hit L1/L2), and writes 18 offset gradients
// (72 B) and 9 mask gradients (36 B): about 224 B against about 300 FLOP.
// The design keeps the traffic at that minimum:
//   - one thread per output pixel, planar NCHW, so every offset, mask and
//     gradient access of a warp is one coalesced 128-byte line;
//   - positions and corners are recomputed from the inputs rather than
//     saved by the forward (saving them would cost more bytes than the
//     arithmetic costs time);
//   - d_weight is reduced in the block: a warp-shuffle sum, then the
//     block's warps summed in shared memory in a fixed order, one row of 9
//     partials per block written to `d_weight_partial`; the caller sums
//     the (n_blocks, 9) rows outside the kernel. No float atomics, so the
//     result is the same on every run.
//
// Positions are tested against the image in float before any float->int
// conversion, exactly as in the forward.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 9;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
deform_bwd_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                  const float* __restrict__ mask,
                  const float* __restrict__ weight,
                  const float* __restrict__ grad_out,
                  float* __restrict__ d_offset, float* __restrict__ d_mask,
                  float* __restrict__ d_weight_partial, int64_t n, int h,
                  int w, int pad) {
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
      float v00 = 0.f, v01 = 0.f, v10 = 0.f, v11 = 0.f;
      if (y0f >= -1.f && y0f <= hmax && x0f >= -1.f && x0f <= wmax) {
        const int y0 = static_cast<int>(y0f);
        const int x0 = static_cast<int>(x0f);
        const bool vy0 = y0 >= 0, vy1 = y0 + 1 <= h - 1;
        const bool vx0 = x0 >= 0, vx1 = x0 + 1 <= w - 1;
        const float* row0 = img + static_cast<int64_t>(y0) * w;
        const float* row1 = row0 + w;
        if (vy0 && vx0) v00 = __ldg(row0 + x0);
        if (vy0 && vx1) v01 = __ldg(row0 + x0 + 1);
        if (vy1 && vx0) v10 = __ldg(row1 + x0);
        if (vy1 && vx1) v11 = __ldg(row1 + x0 + 1);
      }
      const float top = (1.f - tx) * v00 + tx * v01;
      const float bot = (1.f - tx) * v10 + tx * v11;
      const float val = (1.f - ty) * top + ty * bot;
      const float gw = g * __ldg(weight + t);
      const float gwm = gw * m;
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

}  // namespace

// Threads per block; the caller sizes d_weight_partial as
// (ceil(batch*h*w / threads), 9).
extern "C" int jspsr_deform_bwd_threads() { return kThreads; }

// Plain C entry point, bound from Python with ctypes. All tensors are
// contiguous fp32 on the current device: x (B,1,H,W), offset (B,18,H,W),
// mask (B,9,H,W), weight (9,), grad_out (B,1,H,W); outputs d_offset
// (B,18,H,W), d_mask (B,9,H,W), d_weight_partial (n_blocks, 9). Launches on
// ``stream`` without synchronising and returns cudaGetLastError().
extern "C" int jspsr_deform_bwd(const float* x, const float* offset,
                                const float* mask, const float* weight,
                                const float* grad_out, float* d_offset,
                                float* d_mask, float* d_weight_partial,
                                int64_t batch, int h, int w, int pad,
                                void* stream) {
  const int64_t n = batch * h * w;
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  deform_bwd_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, offset, mask, weight, grad_out, d_offset, d_mask, d_weight_partial,
      n, h, w, pad);
  return static_cast<int>(cudaGetLastError());
}
