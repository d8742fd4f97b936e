// K1 and K2: per-image SSIM / PSNR / MSE for Hopper, one kernel template.
//
// K1 (cyclic ground truth) replaces dvg_tpu/ops/pallas_ssim.py::_kernel_pre
// with its _gt_box_moments precompute, launched there by ssim_psnr_cyclic;
// K2 (one-to-one pairs) replaces pallas_ssim.py::_kernel, launched there by
// ssim_psnr_images. Semantics: skimage <= 0.17 compare_ssim / compare_psnr
// for float images, per (image, channel) plane — uniform 7x7 VALID window,
// unbiased covariances (cov_norm = 49/48), data range 2.0, C1 = 0.02^2,
// C2 = 0.06^2, PSNR = 10 log10(4 / max(mse, 1e-12)), MSE by the direct sum
// of (g - p)^2 — then averaged over channels: PSNR is the mean of the
// per-channel PSNRs. Moments are centred by each plane's mean, as the TPU
// kernels centre them: box(pc), box(pc^2), box(gc*pc), box(gc), box(gc^2).
//
// Layout. pred is (S*B, H, W, C) NHWC in f32 or bf16, sample-major; gt is
// (B, H, W, C) f32, and pred image s*B + b scores against gt image b. K2 is
// the same launch with S = 1 and B = N. Output: the channel-averaged
// (ssim, psnr, mse) of each pred image as three rows of S*B floats.
//
// Design. One block owns gt image b and a group of G samples: pred images
// s*B + b for G consecutive s (the last group may be short; its missing
// members alias the last real one and write nothing). G is fixed at
// compile time: 2 for K1 (of G 1, 2 and 4 on an H100, the fastest at
// 128 px and, at 64 px, the fastest that keeps more than 16 warps
// resident), 1 for K2. The block covers all
// C channels of its images, so no block re-reads another's lines.
//   Pass 1 streams the G pred images and the gt image once in 16-byte loads
//   of the contiguous NHWC span (C words a load group, so the channel of an
//   element is a compile-time k % C; scalar loads where the span is not so
//   aligned), summing each plane and sum (g - p)^2 per channel; one block
//   reduction gives the means, MSEs and PSNRs.
//   Pass 2 walks the images again (from L2) in bands of 7 rows, one turn of
//   the vertical ring. Band b + 2 is requested with cp.async into a raw
//   band buffer while band b + 1 is staged from its raw buffer, centred and
//   as f32, planar per channel, and band b is summed: one barrier a band.
//   One thread per (channel, output column) sums its 7 horizontal taps of
//   gc and of each pc once, forming gc, gc^2, pc, pc^2, gc*pc from the same
//   loads, and keeps the vertical window in registers: a 7-slot ring per
//   moment, slot = row mod 7 = the row's place in its band, a compile-time
//   index in the unrolled band. Each vertical box is a running sum (add
//   the entering row, drop the leaving one). As each output row completes,
//   the thread evaluates the SSIM map there and adds it to its per-sample
//   sum, reduced once at the end. The gt side (mean, box(gc), box(gc^2),
//   its half of the map) is computed once per block for the G samples: no
//   gt precompute in the caller. Images wider than one block's columns
//   (C*(W-6) > 192) are walked in column chunks, re-staging per chunk.
//   No integer division runs per element: (channel, column) is divided out
//   once per thread and chunk, (row, slot) once per 16-byte word.
//
// Budget. Shared memory: 2 raw bands (7 rows of the G + 1 images in their
// own types) and 2 staged f32 bands, 7 x (G+1) x C x W floats each, plus
// under 1 KB of reduction scratch — 53 KB for K1 at 64x64x3 with bf16
// pred; it grows with W and G, not with H or the moments. The widest image
// every instance takes is 128 px (127 KB for K1 with f32 pred). Registers:
// the ring, 7 x (2 + 3G) floats, and 2 + 3G running boxes;
// __launch_bounds__ caps K2 (G 1) at the registers of 4 resident blocks of
// 192 threads and K1 (G 2) at 3, and ptxas -v reports the count and any
// spill.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32):
//   K1 at the headline eval step (S = 100, B = 50, 64x64x3, bf16 pred)
//   reads 122.9 MB of pred and 2.5 MB of gt and writes 60 KB — 37.4 us —
//   and does ~2.7 G f32 operations counted as running sums in both
//   directions (three pred moments and the SSIM map per pred plane; the gt
//   side's two moments once per gt plane), ~40.6 us: operations, by a
//   little. K2 at N = 5,000 pairs of 64x64x3 (f32 gt, bf16 pred) reads
//   368.6 MB, ~110 us, against ~3.6 G operations: bytes.
// In practice the instruction count limits it: the horizontal taps are
// direct (a shared load, an add and two FMAs per pred per tap), and each
// block reads its images twice from L2. Neither tensor cores nor a
// transpose are involved.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWin = 7;           // the skimage window, fixed so loops unroll
constexpr int kMaxThreads = 192;  // output columns a block covers at once
constexpr int kMaxWidth = 128;    // widest image every instance takes
constexpr int kBand = kWin;       // rows staged a barrier: one ring turn
constexpr int kPix = 8;           // vector paths need W (and H*W) % 8 == 0
constexpr int kK1Group = 2;       // samples a K1 block scores
constexpr int kK2Group = 1;       // K2 scores one pair a block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// kN consecutive elements from src (global or shared memory) as f32. kVec:
// src is 16-byte aligned and the kN elements span whole 16-byte words, read
// as uint4.
template <bool kVec, typename T, int kN>
__device__ __forceinline__ void load(const T* __restrict__ src,
                                     float (&v)[kN]) {
  if constexpr (kVec) {
    static_assert(kN * sizeof(T) % 16 == 0, "a vector load moves 16 bytes");
    const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int i = 0; i < kN * static_cast<int>(sizeof(T)) / 16; ++i) {
      const uint4 u = s[i];
      const uint32_t word[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (sizeof(T) == 4) {
          v[4 * i + j] = __uint_as_float(word[j]);
        } else {  // two bf16, the first in the low half: widening is exact
          v[8 * i + 2 * j] = __uint_as_float(word[j] << 16);
          v[8 * i + 2 * j + 1] = __uint_as_float(word[j] & 0xffff0000u);
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] = to_f32(src[i]);
  }
}

// 16 bytes from global to shared memory, asynchronously and without passing
// through registers (cp.async, sm_80+); completion in commit groups.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most kPending of this thread's latest groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__host__ __device__ constexpr int pad16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// Bytes of one raw band: the gt image's kBand rows (kBand*W*C f32), then
// each pred image's (kBand*W*C of T), every region padded to 16 bytes.
__host__ __device__ constexpr int raw_band_bytes(int c, int group, int w,
                                                 int pred_bytes) {
  return pad16(kBand * w * c * 4) + group * pad16(kBand * w * c * pred_bytes);
}

// Sums each of the kN per-thread values over the block into tot[0, kN).
// `red` holds kN floats per warp. Ends on a barrier: every thread may read
// tot, and a later call may reuse red.
template <int kN>
__device__ void block_sum(const float (&v)[kN], float* red, float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    float x = v[i];
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) red[warp * kN + i] = x;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kN; i += blockDim.x) {
    float t = 0.f;
    for (int k = 0; k < static_cast<int>(blockDim.x >> 5); ++k)
      t += red[k * kN + i];
    tot[i] = t;
  }
  __syncthreads();
}

// Pixels in one load group of T: C 16-byte words, 16 / sizeof(T) pixels of
// C channels, when vectorised; one pixel otherwise.
template <bool kVec, typename T>
__host__ __device__ constexpr int group_pixels() {
  return kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
}

// Pass 1 on the kP pixels of pred's load groups at element offset e: per
// channel, the gt sum (acc[c]), each pred's sum (acc[(1+g)C + c]) and its
// squared error to gt (acc[(1+G+g)C + c]).
template <bool kVec, typename T, int kC, int kG>
__device__ __forceinline__ void accumulate(const float* g_img,
                                           const T* const (&p_img)[kG],
                                           long e,
                                           float (&acc)[(2 * kG + 1) * kC]) {
  constexpr int kP = group_pixels<kVec, T>();
  float gv[kP * kC];
  load<kVec>(g_img + e, gv);
#pragma unroll
  for (int k = 0; k < kP * kC; ++k) acc[k % kC] += gv[k];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    float pv[kP * kC];
    load<kVec>(p_img[g] + e, pv);
#pragma unroll
    for (int k = 0; k < kP * kC; ++k) {
      const float d = gv[k] - pv[k];
      acc[(1 + g) * kC + k % kC] += pv[k];
      float& d2 = acc[(1 + kG + g) * kC + k % kC];
      d2 = fmaf(d, d, d2);
    }
  }
}

// One load group of a row (pixels x0 .. x0 + kP - 1 of src_row), centred
// by the image's channel means and stored planar: dst[c*w + x].
template <bool kVec, int kC, typename T>
__device__ __forceinline__ void stage_group(const T* src_row, int x0,
                                            const float* mean, int w,
                                            float* dst) {
  constexpr int kP = group_pixels<kVec, T>();
  float v[kP * kC], m[kC];
  load<kVec>(src_row + static_cast<long>(x0) * kC, v);
#pragma unroll
  for (int c = 0; c < kC; ++c) m[c] = mean[c];
#pragma unroll
  for (int k = 0; k < kP * kC; ++k)
    dst[(k % kC) * w + x0 + k / kC] = v[k] - m[k % kC];
}

// Requests rows [r0, r0 + n_rows) of the gt image and the G pred images,
// raw, into `dst`, a band buffer (layout of raw_band_bytes). The rows of a
// band are one contiguous span of each image: cp.async in 16-byte words
// where the spans are so aligned (kVec), else plain loads and stores.
template <bool kVec, typename T, int kC, int kG>
__device__ __forceinline__ void fetch_band(const float* g_img,
                                           const T* const (&p_img)[kG],
                                           int r0, int n_rows, int w,
                                           unsigned char* dst) {
  const long e0 = static_cast<long>(r0) * w * kC;
  const int n = n_rows * w * kC;  // elements of one image in the band
  const int g_pad = pad16(kBand * w * kC * 4);
  const int p_pad = pad16(kBand * w * kC * static_cast<int>(sizeof(T)));
  if constexpr (kVec) {
    const int g_words = n * 4 / 16;
    const int p_words = n * static_cast<int>(sizeof(T)) / 16;
    for (int u = threadIdx.x; u < g_words + kG * p_words; u += blockDim.x) {
      if (u < g_words) {
        cp_async16(dst + 16 * u, g_img + e0 + 4 * u);
      } else {
        const int g = (u - g_words) / p_words;  // once per 16-byte word
        const int i = u - g_words - g * p_words;
        const T* p = p_img[0];
#pragma unroll
        for (int k = 1; k < kG; ++k) p = g == k ? p_img[k] : p;
        cp_async16(dst + g_pad + g * p_pad + 16 * i,
                   reinterpret_cast<const unsigned char*>(p + e0) + 16 * i);
      }
    }
  } else {
    float* gd = reinterpret_cast<float*>(dst);
    for (int i = threadIdx.x; i < n; i += blockDim.x) gd[i] = g_img[e0 + i];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      T* pd = reinterpret_cast<T*>(dst + g_pad + g * p_pad);
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        pd[i] = p_img[g][e0 + i];
    }
  }
}

// Stages the first n_rows rows of a raw band (`src`) into buf, centred and
// as f32, planar per row: buf[((k*(G+1) + slot)*C + c)*w + x] for band row
// k, slot 0 the gt image and 1..G the preds.
template <bool kVec, typename T, int kC, int kG>
__device__ __forceinline__ void stage_band(const unsigned char* src,
                                           int n_rows, const float* mean,
                                           int w, float* buf) {
  constexpr int kGp = group_pixels<kVec, float>();
  constexpr int kPp = group_pixels<kVec, T>();
  const int g_units = w / kGp, p_units = w / kPp;
  const int per_row = g_units + kG * p_units;
  const int g_pad = pad16(kBand * w * kC * 4);
  const int p_pad = pad16(kBand * w * kC * static_cast<int>(sizeof(T)));
  for (int u = threadIdx.x; u < n_rows * per_row; u += blockDim.x) {
    const int k = u / per_row;  // once per load group
    const int v = u - k * per_row;
    const long row = static_cast<long>(k) * w * kC;
    float* dst = buf + k * (kG + 1) * kC * w;
    if (v < g_units) {
      stage_group<kVec, kC>(reinterpret_cast<const float*>(src) + row,
                            v * kGp, mean, w, dst);
    } else {
      const int g = (v - g_units) / p_units;
      const int x0 = (v - g_units - g * p_units) * kPp;
      stage_group<kVec, kC>(
          reinterpret_cast<const T*>(src + g_pad + g * p_pad) + row, x0,
          mean + (1 + g) * kC, w, dst + (1 + g) * kC * w);
    }
  }
}

// Resident blocks per SM each group is compiled for: the register cap
// (65,536 / (192 x blocks)) that keeps the unrolled band from hoisting
// more than that many registers' worth of loads.
template <int kG>
__host__ __device__ constexpr int min_blocks() {
  return kG == 1 ? 4 : 3;
}

template <typename T, int kC, int kG>
__global__ void __launch_bounds__(kMaxThreads, min_blocks<kG>())
ssim_kernel(const float* __restrict__ gt, const void* __restrict__ pred_v,
            float* __restrict__ out, int s_n, int b_n, int h, int w) {
  constexpr int kSlots = kG + 1;                 // gt, then the G preds
  constexpr int kStats = (kSlots + kG) * kC;     // pass 1's sums
  constexpr int kMom = 2 + 3 * kG;               // boxed moments a column
  extern __shared__ __align__(16) unsigned char smem[];
  const int raw_bytes = raw_band_bytes(kC, kG, w, sizeof(T));
  unsigned char* raw = smem;                     // 2 raw bands
  float* bands = reinterpret_cast<float*>(smem + 2 * raw_bytes);
  const int band_floats = kBand * kSlots * kC * w;
  float* stat = bands + 2 * band_floats;         // kStats
  float* mean = stat + kStats;                   // kSlots x C
  float* tot = mean + kSlots * kC;               // kG
  float* red = tot + kG;                         // kStats per warp

  const T* pred = static_cast<const T*>(pred_v);
  const int b = blockIdx.x % b_n;
  const int s0 = blockIdx.x / b_n * kG;
  const int n_valid = min(kG, s_n - s0);
  const int hw = h * w;
  const long hwc = static_cast<long>(hw) * kC;
  const float* g_img = gt + b * hwc;
  const T* p_img[kG];
  bool aligned = (reinterpret_cast<uintptr_t>(g_img) & 15) == 0;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    p_img[g] = pred + (static_cast<long>(s0 + min(g, n_valid - 1)) * b_n + b)
                          * hwc;
    aligned = aligned && (reinterpret_cast<uintptr_t>(p_img[g]) & 15) == 0;
  }

  // pass 1: sums and squared errors per channel, then the means
  float acc[kStats];
#pragma unroll
  for (int i = 0; i < kStats; ++i) acc[i] = 0.f;
  if (aligned && hw % kPix == 0) {
    constexpr int kP = group_pixels<true, T>();
#pragma unroll 4
    for (int i = threadIdx.x; i < hw / kP; i += blockDim.x)
      accumulate<true, T, kC, kG>(g_img, p_img,
                                  static_cast<long>(i) * kP * kC, acc);
  } else {
    for (int i = threadIdx.x; i < hw; i += blockDim.x)
      accumulate<false, T, kC, kG>(g_img, p_img, static_cast<long>(i) * kC,
                                   acc);
  }
  block_sum(acc, red, stat);
  if (threadIdx.x < kSlots * kC) mean[threadIdx.x] = stat[threadIdx.x] / hw;
  __syncthreads();

  // pass 2: running-sum boxes down the rows, the SSIM map per output row
  constexpr float kCov = kWin * kWin / (kWin * kWin - 1.f);
  constexpr float kInv = 1.f / (kWin * kWin);
  const float c1 = 0.02f * 0.02f, c2 = 0.06f * 0.06f;
  const int wp = w - kWin + 1;
  const int cols = kC * wp;
  const int slot_stride = kC * w;
  const bool vec_rows = aligned && w % kPix == 0;
  const int n_bands = (h + kBand - 1) / kBand;
  const auto band_rows = [&](int band) { return min(kBand, h - band * kBand); };
  const auto fetch = [&](int band) {
    unsigned char* dst = raw + band % 2 * raw_bytes;
    if (vec_rows)
      fetch_band<true, T, kC, kG>(g_img, p_img, band * kBand,
                                  band_rows(band), w, dst);
    else
      fetch_band<false, T, kC, kG>(g_img, p_img, band * kBand,
                                   band_rows(band), w, dst);
  };
  const auto stage = [&](int band) {
    const unsigned char* src = raw + band % 2 * raw_bytes;
    float* dst = bands + band % 2 * band_floats;
    if (vec_rows)
      stage_band<true, T, kC, kG>(src, band_rows(band), mean, w, dst);
    else
      stage_band<false, T, kC, kG>(src, band_rows(band), mean, w, dst);
  };
  float ssum[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) ssum[g] = 0.f;

  for (int j0 = 0; j0 < cols; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const bool active = j < cols;
    const int c = active ? j / wp : 0;
    const int x = active ? j - c * wp : 0;
    const float* mean_c = mean + c;  // slot s's mean of channel c: [s*C]
    // moments: 0 gc, 1 gc^2, then per pred 2+3g pc, 3+3g pc^2, 4+3g gc*pc
    float ring[kMom][kWin], box[kMom];
#pragma unroll
    for (int m = 0; m < kMom; ++m) {
      box[m] = 0.f;
#pragma unroll
      for (int k = 0; k < kWin; ++k) ring[m][k] = 0.f;
    }
    // band b is requested two bands before it is summed and staged one
    // band before: while the block sums band b, band b + 1 waits staged
    // and band b + 2 is in flight; one barrier a band
    fetch(0);
    cp_async_commit();
    if (n_bands > 1) fetch(1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    stage(0);
    cp_async_wait<0>();
    __syncthreads();
    for (int band = 0; band < n_bands; ++band) {
      if (band + 1 < n_bands) stage(band + 1);
      if (band + 2 < n_bands) fetch(band + 2);  // into band's raw buffer
      cp_async_commit();
      const float* buf = bands + band % 2 * band_floats;
#pragma unroll
      for (int k = 0; k < kBand; ++k) {  // k = r mod 7, the ring slot
        const int r = band * kBand + k;
        if (r < h) {  // uniform over the block
          if (active) {
            float hm[kMom];
#pragma unroll
            for (int m = 0; m < kMom; ++m) hm[m] = 0.f;
            const float* src = buf + k * kSlots * slot_stride + c * w + x;
#pragma unroll
            for (int t = 0; t < kWin; ++t) {
              const float gv = src[t];
              hm[0] += gv;
              hm[1] = fmaf(gv, gv, hm[1]);
#pragma unroll
              for (int g = 0; g < kG; ++g) {
                const float pv = src[(1 + g) * slot_stride + t];
                hm[2 + 3 * g] += pv;
                hm[3 + 3 * g] = fmaf(pv, pv, hm[3 + 3 * g]);
                hm[4 + 3 * g] = fmaf(gv, pv, hm[4 + 3 * g]);
              }
            }
#pragma unroll
            for (int m = 0; m < kMom; ++m) {
              box[m] += hm[m] - ring[m][k];
              ring[m][k] = hm[m];
            }
            if (r >= kWin - 1) {
              // output row r - 6 is complete: its SSIM map at this column
              const float bux = box[0] * kInv, bxx = box[1] * kInv;
              const float ux = bux + mean_c[0];
              const float ax = ux * ux + c1;
              const float vxc = kCov * (bxx - bux * bux) + c2;
#pragma unroll
              for (int g = 0; g < kG; ++g) {
                const float buy = box[2 + 3 * g] * kInv;
                const float byy = box[3 + 3 * g] * kInv;
                const float bxy = box[4 + 3 * g] * kInv;
                const float uy = buy + mean_c[(1 + g) * kC];
                const float vy = kCov * (byy - buy * buy);
                const float vxy = kCov * (bxy - bux * buy);
                ssum[g] += __fdividef((2.f * ux * uy + c1) * (2.f * vxy + c2),
                                      (ax + uy * uy) * (vxc + vy));
              }
            }
          }
        }
      }
      // band + 2 has landed and band + 1 is staged, for every thread after
      // the barrier, which also ends the chunk
      cp_async_wait<0>();
      __syncthreads();
    }
  }

  block_sum(ssum, red, tot);
  if (static_cast<int>(threadIdx.x) < n_valid) {
    const int g = threadIdx.x;
    const long n_out = static_cast<long>(s_n) * b_n;
    const long n = static_cast<long>(s0 + g) * b_n + b;
    float psnr = 0.f, mse = 0.f;
#pragma unroll
    for (int ch = 0; ch < kC; ++ch) {
      const float m = stat[(kSlots + g) * kC + ch] / hw;
      psnr += 10.f * log10f(4.f / fmaxf(m, 1e-12f));
      mse += m;
    }
    out[n] = tot[g] / (static_cast<float>(kC) * (h - kWin + 1) * wp);
    out[n_out + n] = psnr / kC;
    out[2 * n_out + n] = mse / kC;
  }
}

using Kernel = void (*)(const float*, const void*, float*, int, int, int,
                        int);

template <typename T, int kG>
Kernel pick_channels(int c) {
  switch (c) {
    case 1: return ssim_kernel<T, 1, kG>;
    case 3: return ssim_kernel<T, 3, kG>;
    default: return nullptr;
  }
}

// K1's instance for (pred type, c), or K2's where `images` is set.
Kernel pick(int pred_is_bf16, int c, bool images) {
  if (images)
    return pred_is_bf16 ? pick_channels<__nv_bfloat16, kK2Group>(c)
                        : pick_channels<float, kK2Group>(c);
  return pred_is_bf16 ? pick_channels<__nv_bfloat16, kK1Group>(c)
                      : pick_channels<float, kK1Group>(c);
}

int threads_for(int c, int w) {
  const int cols = c * (w - kWin + 1);
  const int t = (cols + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

size_t smem_bytes(int pred_is_bf16, int c, int group, int w) {
  const size_t slots = group + 1, stats = (slots + group) * c;
  return 2 * static_cast<size_t>(
                 raw_band_bytes(c, group, w, pred_is_bf16 ? 2 : 4)) +
         (2 * kBand * slots * c * w + stats + slots * c + group +
          kMaxThreads / 32 * stats) *
             sizeof(float);
}

// The instance of K1 (K2 where `images` is set) for (pred type, c) with its
// dynamic shared memory opted in where it exceeds the 48 KB default;
// nullptr and an error for a shape the template does not take.
Kernel prepare(int pred_is_bf16, int c, bool images, int h, int w,
               size_t* smem, cudaError_t* err) {
  const Kernel k = pick(pred_is_bf16, c, images);
  if (k == nullptr || h < kWin || w < kWin || w > kMaxWidth) {
    *err = cudaErrorInvalidValue;
    return nullptr;
  }
  *smem = smem_bytes(pred_is_bf16, c, images ? kK2Group : kK1Group, w);
  *err = *smem <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
  if (*err == cudaSuccess && *smem > 48 * 1024)
    *err = cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  return *err == cudaSuccess ? k : nullptr;
}

int launch(const float* gt, const void* pred, int pred_is_bf16, float* out,
           int s_n, int b_n, int h, int w, int c, bool images,
           cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err;
  const Kernel k = prepare(pred_is_bf16, c, images, h, w, &smem, &err);
  if (k == nullptr) return static_cast<int>(err);
  if (s_n < 1 || b_n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int group = images ? kK2Group : kK1Group;
  const dim3 grid(b_n * ((s_n + group - 1) / group));
  const dim3 block(threads_for(c, w));
  void* args[] = {&gt, &pred, &out, &s_n, &b_n, &h, &w};
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(k),
                                           grid, block, args, smem, stream));
}

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device pointers;
// `stream` is a cudaStream_t. Each returns a cudaError_t (0 on success).

// K1: gt (b, h, w, c) f32, pred (s*b, h, w, c) sample-major, c in {1, 3};
// out (3, s*b) f32.
extern "C" int dvg_ssim_cyclic(const float* gt, const void* pred,
                               int pred_is_bf16, float* out, int s, int b,
                               int h, int w, int c, void* stream) {
  return launch(gt, pred, pred_is_bf16, out, s, b, h, w, c, false,
                static_cast<cudaStream_t>(stream));
}

// K2: gt and pred both (n, h, w, c), scored pair by pair; out (3, n).
extern "C" int dvg_ssim_images(const float* gt, const void* pred,
                               int pred_is_bf16, float* out, int n, int h,
                               int w, int c, void* stream) {
  return launch(gt, pred, pred_is_bf16, out, 1, n, h, w, c, true,
                static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM and threads per block of K1's instance (K2's
// where `images` is non-zero) for h x w images with c channels.
extern "C" int dvg_ssim_occupancy(int pred_is_bf16, int c, int images, int h,
                                  int w, int* blocks_per_sm, int* threads) {
  size_t smem = 0;
  cudaError_t err;
  const Kernel k = prepare(pred_is_bf16, c, images != 0, h, w, &smem, &err);
  if (k == nullptr) return static_cast<int>(err);
  *threads = threads_for(c, w);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, reinterpret_cast<const void*>(k), *threads, smem));
}
