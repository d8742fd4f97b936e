// K1 and K2: per-plane SSIM / PSNR / MSE for Hopper, in two modes of one
// kernel template.
//
// K1 (cyclic ground truth) replaces dvg_tpu/ops/pallas_ssim.py::_kernel_pre,
// launched there through ssim_psnr_cyclic; K2 (one-to-one pairs) replaces
// pallas_ssim.py::_kernel, launched there through ssim_psnr_images. Both
// share the _ssim_tail epilogue. Semantics: skimage <= 0.17 compare_ssim /
// compare_psnr for float images — uniform 7x7 VALID window, unbiased
// covariances (cov_norm = 49/48), data range 2.0, C1 = 0.02^2, C2 = 0.06^2,
// PSNR = 10 log10(4 / max(mse, 1e-12)), MSE by the direct sum of (g - p)^2.
//
// Layout. pred is (N, H, W, C) NHWC in f32 or bf16; gt is NHWC f32.
//   K1: gt is (B, H, W, C) and N = S*B sample-major, so pred image n scores
//       against gt image n % B. The gt side's windowed moments box(gc),
//       box(gc^2) and the gt mean come precomputed per gt plane (index
//       b*C + c), once per launch, by the caller (ops/ssim_cuda.py): every
//       gt plane is scored S times.
//   K2: gt is (N, H, W, C), pred image n scores against gt image n. Each
//       gt plane is scored once, so the block computes its mean and boxes
//       gc and gc^2 itself, beside pc, pc^2 and gc*pc (five moments).
// Output: one (ssim, psnr, mse) triple per (image, channel) plane, as three
// rows of N*C floats; the caller averages over channels.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32):
//   K1 at the headline eval (S = 100, B = 50, 64x64 RGB, bf16 pred): each
//   launch reads ~123 MB of bf16 pred, ~2.5 MB of gt and ~4 MB of gt
//   moments — ~38 us — and does ~2.7 GFLOP of f32 adds and multiplies on
//   the CUDA cores (7-tap box sums of three moments in both directions plus
//   the SSIM map), ~40 us. The two are close.
//   K2 at N = 5000 such images (f32 gt, bf16 pred): 246 MB of gt and 123 MB
//   of pred, ~110 us, against ~3.4 GFLOP, ~50 us: bound by bytes.
// Neither tensor cores nor a transpose are involved.
//
// This first design: one 256-thread block per (pred image, channel) plane.
// The block reads its pred plane straight from NHWC (stride C, no transpose
// copy) and its gt plane, stages both in shared memory as f32 while summing
// the means and the squared error, reduces in shared memory, centres both
// planes, then runs the horizontal 7-tap sums of the moments into shared
// memory and the vertical 7-tap sums plus the SSIM epilogue from there,
// reducing the map mean in shared memory. The window is a compile-time 7,
// so both tap loops unroll. All accumulation is f32. Shared memory per
// block is (2*H*W + R*H*W' + 8) floats with R = 3 moment rows for K1 and 5
// for K2 — 77 KB and 107 KB at 64x64, above the 48 KB static limit, so it
// is dynamic and opted in with cudaFuncSetAttribute, which refuses planes
// too large for one block. Reads of a plane are strided by C; the channel
// blocks of an image share its cache lines through L2. Nothing carries
// over between blocks, and the padding of the TPU kernel's image blocks
// has no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWin = 7;  // the skimage window, fixed so the tap loops unroll

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Sum of one value per thread over the block; every thread gets the sum.
// `scratch` holds one float per warp. The leading barrier keeps a previous
// call's readers ahead of this call's writers.
__device__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < kThreads / 32; ++i) t += scratch[i];
  return t;
}

// Moment rows staged in shared memory: pc, pc^2, gc*pc, and for K2 gc, gc^2.
template <bool kOwnGt>
__host__ __device__ constexpr int moment_rows() {
  return kOwnGt ? 5 : 3;
}

template <bool kOwnGt>
size_t smem_bytes(int h, int w) {
  return (2 * static_cast<size_t>(h) * w +
          moment_rows<kOwnGt>() * static_cast<size_t>(h) * (w - kWin + 1) +
          kThreads / 32) *
         sizeof(float);
}

// kOwnGt = false: K1 (cyclic gt, precomputed gt moments in gmean/gux/gxx).
// kOwnGt = true:  K2 (one gt plane per pred plane; gmean/gux/gxx unused).
template <typename T, bool kOwnGt>
__global__ void __launch_bounds__(kThreads)
ssim_kernel(const float* __restrict__ gt, const T* __restrict__ pred,
            const float* __restrict__ gmean, const float* __restrict__ gux,
            const float* __restrict__ gxx, float* __restrict__ out,
            int n_planes, int b, int h, int w, int c) {
  extern __shared__ float smem[];
  const int hw = h * w;
  const int hp = h - kWin + 1, wp = w - kWin + 1;
  const int hwp = h * wp;
  float* sp = smem;               // pred plane, then centred pred
  float* sg = sp + hw;            // gt plane, then centred gt
  float* rp = sg + hw;            // horizontal box of pc      (h x wp)
  float* rpp = rp + hwp;          // horizontal box of pc^2
  float* rgp = rpp + hwp;         // horizontal box of gc * pc
  float* rg = rgp + hwp;          // horizontal box of gc      (K2 only)
  float* rgg = rg + hwp;          // horizontal box of gc^2    (K2 only)
  float* scratch = rp + moment_rows<kOwnGt>() * hwp;  // one float per warp

  const long plane = blockIdx.x;  // n * c + ch
  const int ch = static_cast<int>(plane % c);
  const long n = plane / c;
  const long gimg = kOwnGt ? n : n % b;
  const long gplane = gimg * c + ch;
  const T* p_src = pred + n * static_cast<long>(hw) * c + ch;
  const float* g_src = gt + gimg * static_cast<long>(hw) * c + ch;

  // stage both planes; the sums and squared error on the way
  float psum = 0.f, gsum = 0.f, d2sum = 0.f;
  for (int i = threadIdx.x; i < hw; i += kThreads) {
    const float p = to_f32(p_src[static_cast<long>(i) * c]);
    const float g = g_src[static_cast<long>(i) * c];
    const float d = g - p;
    sp[i] = p;
    sg[i] = g;
    psum += p;
    gsum += g;
    d2sum += d * d;
  }
  const float mp = block_sum(psum, scratch) / hw;
  const float mse = block_sum(d2sum, scratch) / hw;
  float mg;
  if constexpr (kOwnGt) {
    mg = block_sum(gsum, scratch) / hw;
  } else {
    mg = gmean[gplane];
  }
  for (int i = threadIdx.x; i < hw; i += kThreads) {
    sp[i] -= mp;
    sg[i] -= mg;
  }
  __syncthreads();

  // horizontal 7-tap sums of pc, pc^2, gc*pc (and gc, gc^2)
  const float inv_win = 1.f / kWin;
  for (int i = threadIdx.x; i < hwp; i += kThreads) {
    const int y = i / wp, x = i - y * wp;
    const float* prow = sp + y * w + x;
    const float* grow = sg + y * w + x;
    float a = 0.f, aa = 0.f, ag = 0.f, g1 = 0.f, gg = 0.f;
#pragma unroll
    for (int k = 0; k < kWin; ++k) {
      const float p = prow[k];
      const float g = grow[k];
      a += p;
      aa += p * p;
      ag += g * p;
      if constexpr (kOwnGt) {
        g1 += g;
        gg += g * g;
      }
    }
    rp[i] = a * inv_win;
    rpp[i] = aa * inv_win;
    rgp[i] = ag * inv_win;
    if constexpr (kOwnGt) {
      rg[i] = g1 * inv_win;
      rgg[i] = gg * inv_win;
    }
  }
  __syncthreads();

  // vertical 7-tap sums and the SSIM map epilogue
  constexpr float cov_norm = kWin * kWin / (kWin * kWin - 1.f);
  const float c1 = 0.02f * 0.02f, c2 = 0.06f * 0.06f;
  float ssum = 0.f;
  for (int i = threadIdx.x; i < hp * wp; i += kThreads) {
    const int y = i / wp, x = i - y * wp;
    float buy = 0.f, byy = 0.f, bxy = 0.f, bux = 0.f, bxx = 0.f;
#pragma unroll
    for (int k = 0; k < kWin; ++k) {
      const int j = (y + k) * wp + x;
      buy += rp[j];
      byy += rpp[j];
      bxy += rgp[j];
      if constexpr (kOwnGt) {
        bux += rg[j];
        bxx += rgg[j];
      }
    }
    buy *= inv_win;
    byy *= inv_win;
    bxy *= inv_win;
    if constexpr (kOwnGt) {
      bux *= inv_win;
      bxx *= inv_win;
    } else {
      bux = gux[gplane * static_cast<long>(hp) * wp + i];
      bxx = gxx[gplane * static_cast<long>(hp) * wp + i];
    }
    const float ux = bux + mg, uy = buy + mp;
    const float vx = cov_norm * (bxx - bux * bux);
    const float vy = cov_norm * (byy - buy * buy);
    const float vxy = cov_norm * (bxy - bux * buy);
    ssum += ((2.f * ux * uy + c1) * (2.f * vxy + c2)) /
            ((ux * ux + uy * uy + c1) * (vx + vy + c2));
  }
  const float ssim = block_sum(ssum, scratch) / (hp * wp);
  if (threadIdx.x == 0) {
    out[plane] = ssim;
    out[n_planes + plane] = 10.f * log10f(4.f / fmaxf(mse, 1e-12f));
    out[2L * n_planes + plane] = mse;
  }
}

template <typename T, bool kOwnGt>
int launch(const float* gt, const void* pred, const float* gmean,
           const float* gux, const float* gxx, float* out, int n, int b,
           int h, int w, int c, cudaStream_t stream) {
  const int n_planes = n * c;
  const size_t smem = smem_bytes<kOwnGt>(h, w);
  cudaError_t err = cudaFuncSetAttribute(
      ssim_kernel<T, kOwnGt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssim_kernel<T, kOwnGt><<<n_planes, kThreads, smem, stream>>>(
      gt, static_cast<const T*>(pred), gmean, gux, gxx, out, n_planes, b, h,
      w, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device pointers;
// `stream` is a cudaStream_t. Each returns a cudaError_t (0 on success).

// K1: gt (b, h, w, c), pred (n, h, w, c) with n a multiple of b, and the
// gt precompute (gmean (b*c), gux and gxx (b*c, h-6, w-6)).
extern "C" int dvg_ssim_cyclic(const float* gt, const void* pred,
                               int pred_is_bf16, const float* gmean,
                               const float* gux, const float* gxx,
                               float* out, int n, int b, int h, int w, int c,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pred_is_bf16)
    return launch<__nv_bfloat16, false>(gt, pred, gmean, gux, gxx, out, n, b,
                                        h, w, c, s);
  return launch<float, false>(gt, pred, gmean, gux, gxx, out, n, b, h, w, c,
                              s);
}

// K2: gt and pred both (n, h, w, c), scored pair by pair.
extern "C" int dvg_ssim_images(const float* gt, const void* pred,
                               int pred_is_bf16, float* out, int n, int h,
                               int w, int c, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pred_is_bf16)
    return launch<__nv_bfloat16, true>(gt, pred, nullptr, nullptr, nullptr,
                                       out, n, n, h, w, c, s);
  return launch<float, true>(gt, pred, nullptr, nullptr, nullptr, out, n, n,
                             h, w, c, s);
}
