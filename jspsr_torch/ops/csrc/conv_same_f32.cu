// K4 in fp32: the kk x kk stride-1 "same" convolution (kk = 1 or 3), zero
// padding kk/2, in full fp32 on the FFMA units:
//
//   out[b,y,x,co] = sum_{dy,dx,ci} x[b, y+dy-pad, x+dx-pad, ci] * w[dy,dx,ci,co]
//
// x is NHWC and w HWIO, both fp32. conv_same_bf16.cu takes bf16.
//
// Replaces: scripts/bench_pallas_conv.py::_kernel (pallas_conv_same) for
// fp32 inputs; any H and W (the TPU's ``bh`` row block is its tiling).
//
// Bound on this card: at the probe's 64->64 shape (16 x 128^2) 19.33
// GFLOP: 0.289 ms at the 67 TFLOP/s FFMA peak, against 0.040 ms of bytes.
// TF32 and 3xTF32 would be other results: fp32 means fp32, so no tensor
// cores.
//
// Design: an SGEMM-shaped implicit GEMM (M = output pixels, N = Cout, K =
// kk*kk*Cin), a block tile of 128 pixels (consecutive in (b, y, x)) x 64
// output channels, 128 threads, each warp 64 pixels x 32 channels.
//   - K is walked in chunks of (tap, 16 input channels), double-buffered
//     in shared memory as a [k][m] A tile and a [k][n] B tile. While one
//     chunk is computed, the next one comes by cp.async: B straight into
//     its tile, A (thread m's pixel, 16 channels in four 16-byte copies)
//     into a [4-channel group][m] staging tile, which each thread then
//     moves, transposed, into the A tile (it reads back only its own
//     copies, so no barrier comes between). The tap's shift is paid once,
//     in the copy's source address (zero-filled off the image and past
//     Cin), never in the inner loop.
//   - Each thread owns 8 pixels x 8 output channels, two runs of 4 in each:
//     per channel of K, two float4 loads of A and two (broadcast) of B feed
//     64 FFMA. A quarter-warp reads 8 consecutive float4 of A: no bank
//     conflicts. 128 registers at most, 4 blocks per SM, no spills.
//   - Cin that is not a multiple of 4 takes 4-byte copies (kVec = false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // pixels per block
constexpr int kBN = 64;   // output channels per block
constexpr int kBK = 16;   // input channels per chunk
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copies `bytes` (0 or the full size) and zero-fills the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool kVec>  // Cin % 4 == 0: 16-byte copies of A
__global__ void __launch_bounds__(kThreads, 4)
conv_same_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ out, int64_t npix, int h, int wd,
                     int cin, int cout, int kk) {
  __shared__ __align__(16) float as[2][kBK][kBM];
  __shared__ __align__(16) float bs[2][kBK][kBN];
  __shared__ __align__(16) float4 stg[kBK / 4][kBM];
  const int tid = threadIdx.x;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int pad = kk / 2;

  // the copy: thread tid brings pixel m0 + tid's channels
  const int64_t p = m0 + tid;
  const bool pv = p < npix;
  int b = 0, y = 0, xq = 0;
  if (pv) {
    const int64_t hw = static_cast<int64_t>(h) * wd;
    b = static_cast<int>(p / hw);
    const int rem = static_cast<int>(p - b * hw);
    y = rem / wd;
    xq = rem - y * wd;
  }
  const int chunks = (cin + kBK - 1) / kBK;
  const int nq = kk * kk * chunks;

  auto fetch = [&](int q) {
    const int tap = q / chunks, c0 = (q - tap * chunks) * kBK;
    const int yy = y + tap / kk - pad, xx = xq + tap % kk - pad;
    const bool inb = pv && yy >= 0 && yy < h && xx >= 0 && xx < wd;
    const float* src =
        inb ? x + ((static_cast<int64_t>(b) * h + yy) * wd + xx) * cin + c0
            : x;
#pragma unroll
    for (int kq = 0; kq < kBK / 4; ++kq) {
      if (kVec) {
        const bool ok = inb && c0 + 4 * kq < cin;
        cp_async16(&stg[kq][tid], ok ? src + 4 * kq : x, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const bool ok = inb && c0 + 4 * kq + r < cin;
          cp_async4(reinterpret_cast<float*>(&stg[kq][tid]) + r,
                    ok ? src + 4 * kq + r : x, ok ? 4 : 0);
        }
      }
    }
    // B: the chunk's 16 x 64 weights by cp.async, two 16-byte copies each
#pragma unroll
    for (int j = 0; j < kBK * kBN / 4 / kThreads; ++j) {
      const int e = tid + kThreads * j;
      const int k = e / (kBN / 4), n = 4 * (e % (kBN / 4));
      const bool ok = c0 + k < cin && n0 + n < cout;
      cp_async16(&bs[q & 1][k][n],
                 ok ? w + (static_cast<int64_t>(tap) * cin + c0 + k) * cout +
                          n0 + n
                    : w,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };
  // each thread moves only the pixel it copied: no barrier before
  auto stash = [&](int buf) {
#pragma unroll
    for (int kq = 0; kq < kBK / 4; ++kq) {
      const float4 v = stg[kq][tid];
      as[buf][4 * kq][tid] = v.x;
      as[buf][4 * kq + 1][tid] = v.y;
      as[buf][4 * kq + 2][tid] = v.z;
      as[buf][4 * kq + 3][tid] = v.w;
    }
  };

  // warp (wm, wn) of 2 x 2 owns pixels 64 wm .. +63 and channels 32 wn ..
  // +31; its lane (lm, ln) of 8 x 4 the pixels mb + {0..3, 32..35} and the
  // channels nb + {0..3, 16..19}
  const int warp = tid / 32, lane = tid % 32;
  const int mb = (warp % 2) * 64 + (lane % 8) * 4;
  const int nb = (warp / 2) * 32 + (lane / 8) * 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  cp_async_wait<0>();
  stash(0);
  __syncthreads();
  for (int q = 0; q < nq; ++q) {
    const int buf = q & 1;
    if (q + 1 < nq) fetch(q + 1);  // into buffer buf ^ 1, read at q - 1
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][k][mb]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[buf][k][mb + 32]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[buf][k][nb]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[buf][k][nb + 16]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (q + 1 < nq) {
      cp_async_wait<0>();
      stash(buf ^ 1);
    }
    __syncthreads();  // buffer buf ^ 1 is whole; buffer buf is free
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t pix = m0 + mb + (i < 4 ? i : 28 + i);
    if (pix >= npix) continue;
    float* o = out + pix * cout + n0;
    if (n0 + nb < cout)
      *reinterpret_cast<float4*>(o + nb) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (n0 + nb + 16 < cout)
      *reinterpret_cast<float4*>(o + nb + 16) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

}  // namespace

// Plain C entry point, bound from Python with ctypes. x (B,H,W,Cin) and out
// (B,H,W,Cout) NHWC, w (kk,kk,Cin,Cout) HWIO, fp32, contiguous on the
// current device, 16-byte aligned. Takes kk in {1, 3}, Cin in [1, 128],
// Cout in [8, 128] a multiple of 8, B*H*W < 2^31; anything else returns
// cudaErrorInvalidValue without launching. Launches on ``stream`` without
// synchronising and returns cudaGetLastError().
extern "C" int jspsr_conv_same_f32(const float* x, const float* w, float* out,
                                   int64_t batch, int h, int wd, int cin,
                                   int cout, int kk, void* stream) {
  const int64_t npix = batch * h * wd;
  if (npix == 0) return 0;
  if ((kk != 1 && kk != 3) || cin < 1 || cin > 128 || cout < 8 ||
      cout > 128 || cout % 8 != 0 || npix >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>((npix + kBM - 1) / kBM),
                  (cout + kBN - 1) / kBN);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin % 4 == 0)
    conv_same_f32_kernel<true><<<grid, kThreads, 0, s>>>(x, w, out, npix, h,
                                                         wd, cin, cout, kk);
  else
    conv_same_f32_kernel<false><<<grid, kThreads, 0, s>>>(x, w, out, npix, h,
                                                          wd, cin, cout, kk);
  return static_cast<int>(cudaGetLastError());
}
