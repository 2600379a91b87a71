// kk x kk stride-1 "same" convolution (kk = 1 or 3), zero padding kk/2:
//
//   out[b,y,x,co] = sum_{dy,dx,ci} x[b, y+dy-pad, x+dx-pad, ci] * w[dy,dx,ci,co]
//
// x is NHWC and w HWIO, both bf16 or both fp32; the sum is taken in fp32 and
// cast to x's type on the way out (round to nearest even).
//
// Replaces: scripts/bench_pallas_conv.py::_kernel (pallas_conv_same). The
// TPU kernel keeps the whole padded image in VMEM and builds one
// (bh*W, kk*kk*Cin) patch matrix per row block for a single MXU dot. Its
// ``bh`` argument and its H % bh == 0 requirement are the TPU's tiling, not
// the function: here a block owns a fixed output tile and masks the ragged
// edge itself, so any H and W are taken and there is no ``bh``.
//
// Bound on this card: at the probe's 64->64 shape (16 x 128^2) the conv is
// 19.33 GFLOP against 67 MB of x and y in bf16: 0.0195 ms of tensor-core
// time (989 TFLOP/s) against 0.020 ms of bytes (3.35 TB/s), so bf16 sits
// at the balance point; in fp32 without tensor cores (TF32 stays off: fp32
// means fp32) it is 0.289 ms of FFMA time, compute-bound. 32->64 and
// 64->32 in bf16 are byte-bound (50 MB, 0.015 ms).
//
// Design (an implicit GEMM, M = output pixels, N = Cout, K = kk*kk*Cin; the
// patch matrix is never formed, not even in shared memory):
//   - a block owns an 8 x 16 output tile and all of Cout. It stages the
//     tile's (8+kk-1) x (16+kk-1) x Cin input halo in shared memory once,
//     zero outside the image (which is both the "same" padding and the
//     ragged edge), then walks the kk*kk taps, staging one tap's Cin x Cout
//     weights at a time. Streaming the weights per tap keeps shared memory
//     at 69 KB (bf16) and 61 KB (fp32) for 64->64, where the whole fp32
//     weight matrix alone would be 147 KB;
//   - bf16: one warp per output row. Its 16 pixels are one 16-row A tile,
//     read straight out of the halo (channels contiguous, so a tap is a
//     shifted view with leading dimension Cin+16; the 16 pads the rows off
//     the same banks and keeps every fragment 32-byte aligned); WMMA
//     m16n16k16 (mma.sync on the tensor cores) with fp32 accumulators in
//     registers; the accumulators go through shared memory to the output
//     so that the edge can be masked per pixel;
//   - fp32: a register-tiled FFMA loop. The halo is channel-planar so that
//     the 32 lanes of a warp read 32 neighbouring pixels; a thread owns 4
//     pixels x 8 output channels (32 accumulators), a warp 128 pixels x 8
//     channels, reading its weights as two broadcast float4 loads per
//     input channel.
// Not used yet: wgmma, TMA, a pipelined ring of stages, a persistent grid.
// This kernel is the simple, right first version; making it fast is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kTileH = 8;   // output rows per block
constexpr int kTileW = 16;  // output columns per block: one 16-row A tile
constexpr int kWarps = 8;   // bf16: one warp per output row
constexpr int kThreads = kWarps * 32;
constexpr int kMaxC = 128;  // Cin, Cout <= 128 keep shared memory < 227 KB

__global__ void __launch_bounds__(kThreads)
conv_same_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ out, int h, int wd, int cin,
                     int cout, int kk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hr = kTileH + kk - 1, hc = kTileW + kk - 1, pad = kk / 2;
  const int plane = hr * hc;
  float* ws = reinterpret_cast<float*>(smem);  // [cin][cout], one tap
  float* xs = ws + cin * cout;                 // [cin][hr][hc]
  const int64_t b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const float* xb = x + b * h * wd * cin;

  for (int e = threadIdx.x; e < plane * cin; e += kThreads) {
    const int ci = e % cin, pix = e / cin;
    const int r = pix / hc, c = pix - r * hc;
    const int gy = y0 - pad + r, gx = x0 - pad + c;
    float v = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < wd)
      v = __ldg(xb + (static_cast<int64_t>(gy) * wd + gx) * cin + ci);
    xs[ci * plane + pix] = v;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = lane % 16, row0 = lane / 16;  // pixels (row0 + 2p, col)
  const int groups = cout / 8;                  // 8 output channels each
  const int n_w = cin * cout;
  for (int pass = 0; pass * kWarps < groups; ++pass) {
    const int g = warp + pass * kWarps;
    const bool active = g < groups;
    float acc[4][8];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
    for (int t = 0; t < kk * kk; ++t) {
      const int dy = t / kk, dx = t - dy * kk;
      __syncthreads();  // the last tap's weights are read; the halo is in
      const float* wt = w + static_cast<int64_t>(t) * n_w;
      for (int e = threadIdx.x; e < n_w; e += kThreads) ws[e] = __ldg(wt + e);
      __syncthreads();
      if (!active) continue;
      const float* xp = xs + (row0 + dy) * hc + col + dx;
      const float* wp = ws + g * 8;
      for (int ci = 0; ci < cin; ++ci) {
        float a[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) a[p] = xp[2 * p * hc];
        const float4 w0 = *reinterpret_cast<const float4*>(wp);
        const float4 w1 = *reinterpret_cast<const float4*>(wp + 4);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(a[p], wv[q], acc[p][q]);
        xp += plane;
        wp += cout;
      }
    }
    if (!active) continue;
    const int gx = x0 + col;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int gy = y0 + row0 + 2 * p;
      if (gy >= h || gx >= wd) continue;
      float4* o = reinterpret_cast<float4*>(
          out + ((b * h + gy) * wd + gx) * cout + g * 8);
      o[0] = make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
      o[1] = make_float4(acc[p][4], acc[p][5], acc[p][6], acc[p][7]);
    }
  }
}

template <int NF>  // Cout = 16 * NF
__global__ void __launch_bounds__(kThreads)
conv_same_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      __nv_bfloat16* __restrict__ out, int h, int wd, int cin,
                      int kk) {
  constexpr int cout = 16 * NF;
  constexpr int ldb = cout + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int hr = kTileH + kk - 1, hc = kTileW + kk - 1, pad = kk / 2;
  const int lda = cin + 16;
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);  // [cin][ldb]
  __nv_bfloat16* xs = ws + cin * ldb;                  // [hr][hc][lda]
  float* es = reinterpret_cast<float*>(xs + hr * hc * lda);  // [warp][16][cout]
  const int64_t b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const __nv_bfloat16* xb = x + b * h * wd * cin;

  // the halo in 16-byte vectors of 8 channels
  const int vpp = cin / 8;
  for (int e = threadIdx.x; e < hr * hc * vpp; e += kThreads) {
    const int v = e % vpp, pix = e / vpp;
    const int r = pix / hc, c = pix - r * hc;
    const int gy = y0 - pad + r, gx = x0 - pad + c;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < h && gx >= 0 && gx < wd)
      val = __ldg(reinterpret_cast<const uint4*>(
                      xb + (static_cast<int64_t>(gy) * wd + gx) * cin) + v);
    *reinterpret_cast<uint4*>(xs + pix * lda + v * 8) = val;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bm;
  constexpr int wvec = cout / 8;
  for (int t = 0; t < kk * kk; ++t) {
    const int dy = t / kk, dx = t - dy * kk;
    __syncthreads();  // the last tap's weights are read; the halo is in
    const uint4* wt = reinterpret_cast<const uint4*>(
        w + static_cast<int64_t>(t) * cin * cout);
    for (int e = threadIdx.x; e < cin * wvec; e += kThreads) {
      const int ci = e / wvec, v = e - ci * wvec;
      *reinterpret_cast<uint4*>(ws + ci * ldb + v * 8) = __ldg(wt + e);
    }
    __syncthreads();
    // the warp's 16 output pixels under tap (dy, dx): halo row warp + dy,
    // columns dx .. dx + 15, a 16 x cin slab with leading dimension lda
    const __nv_bfloat16* ap = xs + ((warp + dy) * hc + dx) * lda;
    for (int kc = 0; kc < cin; kc += 16) {
      wmma::load_matrix_sync(a, ap + kc, lda);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        wmma::load_matrix_sync(bm, ws + kc * ldb + f * 16, ldb);
        wmma::mma_sync(acc[f], a, bm, acc[f]);
      }
    }
  }

  float* ep = es + warp * 16 * cout;
#pragma unroll
  for (int f = 0; f < NF; ++f)
    wmma::store_matrix_sync(ep + f * 16, acc[f], cout, wmma::mem_row_major);
  __syncwarp();
  const int gy = y0 + warp;
  if (gy >= h) return;
  __nv_bfloat16* orow = out + (b * h + gy) * wd * cout;
  for (int i = lane; i < 16 * cout; i += 32) {
    const int px = i / cout, co = i - px * cout;
    const int gx = x0 + px;
    if (gx < wd)
      orow[static_cast<int64_t>(gx) * cout + co] = __float2bfloat16(ep[i]);
  }
}

int launch_f32(const float* x, const float* w, float* out, int64_t batch,
               int h, int wd, int cin, int cout, int kk, cudaStream_t stream) {
  const int plane = (kTileH + kk - 1) * (kTileW + kk - 1);
  const size_t smem = sizeof(float) * (static_cast<size_t>(cin) * cout +
                                       static_cast<size_t>(cin) * plane);
  cudaError_t err = cudaFuncSetAttribute(
      conv_same_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((wd + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                  static_cast<unsigned int>(batch));
  conv_same_f32_kernel<<<grid, kThreads, smem, stream>>>(x, w, out, h, wd,
                                                         cin, cout, kk);
  return static_cast<int>(cudaGetLastError());
}

template <int NF>
int launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                __nv_bfloat16* out, int64_t batch, int h, int wd, int cin,
                int kk, cudaStream_t stream) {
  constexpr int cout = 16 * NF;
  const int plane = (kTileH + kk - 1) * (kTileW + kk - 1);
  const size_t smem =
      sizeof(__nv_bfloat16) * (static_cast<size_t>(cin) * (cout + 8) +
                               static_cast<size_t>(plane) * (cin + 16)) +
      sizeof(float) * kWarps * 16 * cout;
  cudaError_t err = cudaFuncSetAttribute(
      conv_same_bf16_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((wd + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                  static_cast<unsigned int>(batch));
  conv_same_bf16_kernel<NF><<<grid, kThreads, smem, stream>>>(x, w, out, h,
                                                              wd, cin, kk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound from Python with ctypes. x (B,H,W,Cin) and out
// (B,H,W,Cout) NHWC, w (kk,kk,Cin,Cout) HWIO, all contiguous on the current
// device and 16-byte aligned; dtype 0 is fp32, 1 is bf16. Takes kk in {1,
// 3}, 1 <= Cin, Cout <= 128, Cout % 8 == 0 (fp32) or Cin % 16 == 0 and Cout
// % 16 == 0 (bf16), B <= 65535; anything else returns cudaErrorInvalidValue
// without launching. Launches on ``stream`` without synchronising and
// returns cudaGetLastError().
extern "C" int jspsr_conv_same(const void* x, const void* w, void* out,
                               int dtype, int64_t batch, int h, int wd,
                               int cin, int cout, int kk, void* stream) {
  if (batch == 0 || h == 0 || wd == 0) return 0;
  if ((kk != 1 && kk != 3) || batch > 65535 || cin < 1 || cin > kMaxC ||
      cout < 8 || cout > kMaxC || cout % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(static_cast<const float*>(x),
                      static_cast<const float*>(w), static_cast<float*>(out),
                      batch, h, wd, cin, cout, kk, s);
  if (dtype != 1 || cin % 16 != 0 || cout % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  switch (cout / 16) {
    case 1: return launch_bf16<1>(xb, wb, ob, batch, h, wd, cin, kk, s);
    case 2: return launch_bf16<2>(xb, wb, ob, batch, h, wd, cin, kk, s);
    case 3: return launch_bf16<3>(xb, wb, ob, batch, h, wd, cin, kk, s);
    case 4: return launch_bf16<4>(xb, wb, ob, batch, h, wd, cin, kk, s);
    case 5: return launch_bf16<5>(xb, wb, ob, batch, h, wd, cin, kk, s);
    case 6: return launch_bf16<6>(xb, wb, ob, batch, h, wd, cin, kk, s);
    case 7: return launch_bf16<7>(xb, wb, ob, batch, h, wd, cin, kk, s);
    default: return launch_bf16<8>(xb, wb, ob, batch, h, wd, cin, kk, s);
  }
}
