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
// 9 mask values (36 B) once, reads its image neighbourhood (4 B new per
// pixel; the re-reads of neighbours hit L1/L2) and writes 4 B: about 116 B
// of device memory against about 150 FLOP, far below the H100's balance
// point. The design keeps the traffic at that minimum:
//   - one thread per output pixel, so every offset/mask/output access of a
//     warp is one coalesced 128-byte line (planar NCHW: neighbouring
//     threads read neighbouring addresses);
//   - the 9-tap sum stays in a register, nothing intermediate is stored;
//   - image corners are read through the read-only path (__ldg) so the
//     overlapping reads of neighbouring threads are served by L1;
//   - weight and bias are read from device memory by pointer (no host copy
//     per call).
// Shared-memory tiling, TMA and wgmma are not used: the kernel does no
// matrix product and its inputs are streamed once.
//
// Positions are tested against the image in float before any float->int
// conversion: offsets may be huge (tests use +-20 px scales) and converting
// an out-of-range float to int is undefined. The mask is zero-sum and
// signed; it is used as is.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 9;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
deform_fwd_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                  const float* __restrict__ mask,
                  const float* __restrict__ weight,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int64_t n, int h, int w, int pad) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t b = i / hw;
  const int64_t p = i - b * hw;
  const int y = static_cast<int>(p / w);
  const int xo = static_cast<int>(p - static_cast<int64_t>(y) * w);

  const float* img = x + b * hw;
  const float* off = offset + b * (2 * kTaps) * hw + p;
  const float* msk = mask + b * kTaps * hw + p;
  const float hmax = static_cast<float>(h - 1);
  const float wmax = static_cast<float>(w - 1);

  float acc = __ldg(bias);
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const float py = static_cast<float>(y - pad + t / 3) + off[(2 * t) * hw];
    const float px = static_cast<float>(xo - pad + t % 3) + off[(2 * t + 1) * hw];
    const float m = msk[t * hw];
    const float y0f = floorf(py);
    const float x0f = floorf(px);
    const float ty = py - y0f;
    const float tx = px - x0f;
    float v00 = 0.f, v01 = 0.f, v10 = 0.f, v11 = 0.f;
    // some corner is on the image only if y0 in [-1, h-1] and x0 in [-1, w-1];
    // inside that range the int conversion is exact and safe
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
    const float val = (1.f - ty) * ((1.f - tx) * v00 + tx * v01) +
                      ty * ((1.f - tx) * v10 + tx * v11);
    acc += __ldg(weight + t) * (m * val);
  }
  out[i] = acc;
}

}  // namespace

// Plain C entry point, bound from Python with ctypes. All tensors are
// contiguous fp32 on the current device: x (B,1,H,W), offset (B,18,H,W),
// mask (B,9,H,W), weight (9,), bias (1,), out (B,1,H,W). Launches on
// ``stream`` without synchronising and returns cudaGetLastError().
extern "C" int jspsr_deform_fwd(const float* x, const float* offset,
                                const float* mask, const float* weight,
                                const float* bias, float* out, int64_t batch,
                                int h, int w, int pad, void* stream) {
  const int64_t n = batch * h * w;
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  deform_fwd_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, offset, mask, weight, bias, out, n, h, w, pad);
  return static_cast<int>(cudaGetLastError());
}
