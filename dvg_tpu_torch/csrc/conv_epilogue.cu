// K3: the epilogue of a BN-folded eval conv, out = act(y + pre + bias).
//
// It replaces no Pallas kernel. On the TPU, XLA fused each conv's bias and
// activation (and, in the hoisted decode, the skip half's add) into the
// conv's output; eager PyTorch does not, so each of those ops was its own
// pass over the conv's output in device memory: cuDNN's bias `add_`, the
// skip half's add, the activation, each a read and a write of the whole
// map. This kernel does the chain in one pass: it reads y (and pre) once,
// sums in f32 with the per-channel bias, applies the activation, rounds
// once to the output type and writes out once.
//
// It is bound by bytes: a few flops an element against 4 (f32) or 2 (bf16)
// bytes read per input and written per output, two orders of magnitude
// under the card's ratio of operations to bytes. So the design is about
// moving the bytes at the rate of HBM:
//   * 16-byte vector loads and stores, 8 bf16 or 4 f32 values a thread,
//     wherever the memory is channels_last and C is a multiple of that
//     count: then one vector lies in one pixel and its channels are
//     consecutive, so its bias is one 16-byte load too;
//   * streaming loads and stores (`__ldcs` / `__stcs`, evict-first) for y,
//     pre and out, which are touched once, so they do not push the bias and
//     the neighbouring kernels' data out of L2; the bias goes through the
//     read-only path (`__ldg`), where every thread re-reads the same C
//     values;
//   * a grid-stride loop over a grid that fills every SM at the kernel's
//     occupancy, with the channel of each thread's next element advanced
//     by adds instead of a 64-bit division per element;
//   * a scalar path for every other case: C not a multiple of the vector
//     (the 3-channel final conv, a 90-channel head), storage not 16-byte
//     aligned, and contiguous NCHW memory (where the channel of flat
//     element i is (i / (H·W)) % C instead of i % C).
// The C entry launches on the caller's stream, allocates nothing and
// returns the launch's error code; the wrapper (ops/epilogue.py) checks
// shapes, layouts and types, allocates the output and raises on an error.
//
// The pooled form (`dvg_elementwise_epilogue_pool`) ends a VGG encoder
// group whose full map nothing else reads: the same sum, activation and
// single rounding, then the 2x2 stride-2 max-pool, writing only the pooled
// map. It replaces the full map's write, and the stock max-pool's read of
// it, by nothing: y is read once and a quarter of its bytes are written.
// The max is taken over the rounded values, in the window's row-major order
// with a NaN kept, as torch's max-pool takes it, so the result is bitwise
// max_pool2d(epilogue(y)). It takes channels_last memory only (the eval
// path's layout): one block walks whole output rows, each thread a 16-byte
// vector (or an element) of one output pixel, whose four taps are four
// independent loads, so the row and column indices cost one integer
// division a row and one a unit instead of 64-bit divisions per element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kSlope = 0.2f;          // LeakyReLU's negative slope
constexpr int kMaxDevices = 64;

enum Act { kNone = 0, kLeakyRelu = 1, kTanh = 2, kSigmoid = 3 };

template <int ACT>
__device__ __forceinline__ float activate(float z) {
  if (ACT == kLeakyRelu) return z > 0.f ? z : z * kSlope;
  if (ACT == kTanh) return tanhf(z);
  if (ACT == kSigmoid) return 1.f / (1.f + expf(-z));
  return z;
}

__device__ __forceinline__ unsigned bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// Per element type: the values a 16-byte vector holds, and the scalar
// streaming / read-only loads and the streaming store, all through f32.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  __device__ static void unpack(uint4 v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static float stream(const float* p) { return __ldcs(p); }
  __device__ static float cached(const float* p) { return __ldg(p); }
  __device__ static void store(float* p, float f) { __stcs(p, f); }
  __device__ static float round(float f) { return f; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void unpack(uint4 v, float* f) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = __uint_as_float(w[j] << 16);           // lower address
      f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = bf16_bits(f[2 * j]) | (bf16_bits(f[2 * j + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static float stream(const __nv_bfloat16* p) {
    return __uint_as_float(
        unsigned(__ldcs(reinterpret_cast<const unsigned short*>(p))) << 16);
  }
  __device__ static float cached(const __nv_bfloat16* p) {
    return __uint_as_float(
        unsigned(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
  }
  __device__ static void store(__nv_bfloat16* p, float f) {
    __stcs(reinterpret_cast<unsigned short*>(p),
           static_cast<unsigned short>(bf16_bits(f)));
  }
  // f rounded to bf16 and widened again (exact)
  __device__ static float round(float f) {
    return __uint_as_float(bf16_bits(f) << 16);
  }
};

// One thread's walk over units (vectors or elements) u, u + stride, ...;
// the channel index of unit u is (u / inner) % c, kept as (ch, r) with
// u = (k·c + ch)·inner + r and advanced by adds: inner is 1 for
// channels_last memory and H·W for NCHW.
struct Walk {
  long long u, stride;
  int ch, r, step_ch, step_r, c, inner;

  __device__ Walk(long long first, long long stride_, int c_, int inner_)
      : u(first), stride(stride_), c(c_), inner(inner_) {
    ch = int((first / inner) % c);
    r = int(first % inner);
    step_ch = int((stride / inner) % c);
    step_r = int(stride % inner);
  }
  __device__ void next() {
    u += stride;
    r += step_r;
    const int carry = r >= inner;
    r -= carry * inner;
    ch += step_ch + carry;              // < 2c: one wrap is enough
    if (ch >= c) ch -= c;
  }
};

// VEC: 16-byte units (channels_last, C % kVec == 0, every pointer 16-byte
// aligned), the channel index counting groups of kVec channels; else one
// element a unit. PRE: a skip half of y's shape and strides is added.
template <typename T, int ACT, bool PRE, bool VEC>
__global__ void __launch_bounds__(kThreads)
dvg_elementwise_epilogue(const T* __restrict__ y, const T* __restrict__ pre,
                         const T* __restrict__ bias, T* __restrict__ out,
                         long long units, int c, int inner) {
  using E = Elem<T>;
  const long long stride = (long long)gridDim.x * blockDim.x;
  Walk w((long long)blockIdx.x * blockDim.x + threadIdx.x, stride, c, inner);
  if (VEC) {
    constexpr int V = E::kVec;
    const uint4* y4 = reinterpret_cast<const uint4*>(y);
    const uint4* p4 = reinterpret_cast<const uint4*>(pre);
    const uint4* b4 = reinterpret_cast<const uint4*>(bias);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (; w.u < units; w.next()) {
      float z[V], p[V], b[V];
      E::unpack(__ldcs(y4 + w.u), z);
      if (PRE) E::unpack(__ldcs(p4 + w.u), p);
      E::unpack(__ldg(b4 + w.ch), b);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float s = z[j];
        if (PRE) s += p[j];
        z[j] = activate<ACT>(s + b[j]);
      }
      __stcs(o4 + w.u, E::pack(z));
    }
  } else {
    for (; w.u < units; w.next()) {
      float s = E::stream(y + w.u);
      if (PRE) s += E::stream(pre + w.u);
      E::store(out + w.u, activate<ACT>(s + E::cached(bias + w.ch)));
    }
  }
}

// torch's max-pool step: the later tap wins only if it is greater or NaN,
// so a NaN is kept and of equal values (-0 and +0) the first stays.
__device__ __forceinline__ float pool_max(float m, float v) {
  return (v > m || v != v) ? v : m;
}

// The pooled form over channels_last y (n, h, w, c) into out (n, h/2, w/2,
// c). cu: units a pixel (c / kVec vectors, or c elements); rows: n·(h/2)
// output rows, walked block by block. Each unit: its four taps in the
// window's row-major order, each summed with the bias, activated and
// rounded to T, and their running max.
template <typename T, int ACT, bool VEC>
__global__ void __launch_bounds__(kThreads)
dvg_elementwise_epilogue_pool(const T* __restrict__ y,
                              const T* __restrict__ bias, T* __restrict__ out,
                              long long rows, int cu, int h, int w) {
  using E = Elem<T>;
  constexpr int V = VEC ? E::kVec : 1;
  const int ho = h / 2, wo = w / 2;
  const int row_units = wo * cu;
  const long long col = (long long)w * cu;       // units a row of y
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long img = row / ho;
    const long long top = (img * h + 2 * (row - img * ho)) * col;
    const long long dst = row * row_units;
    for (int j = threadIdx.x; j < row_units; j += blockDim.x) {
      const int px = j / cu, cv = j - px * cu;
      const long long t = top + 2LL * px * cu + cv;
      const long long taps[4] = {t, t + cu, t + col, t + col + cu};
      float m[V];
      if constexpr (VEC) {
        const uint4* y4 = reinterpret_cast<const uint4*>(y);
        uint4 raw[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) raw[k] = __ldcs(y4 + taps[k]);
        float b[V];
        E::unpack(__ldg(reinterpret_cast<const uint4*>(bias) + cv), b);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float z[V];
          E::unpack(raw[k], z);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float r = E::round(activate<ACT>(z[i] + b[i]));
            m[i] = k ? pool_max(m[i], r) : r;
          }
        }
        __stcs(reinterpret_cast<uint4*>(out) + dst + j, E::pack(m));
      } else {
        float raw[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) raw[k] = E::stream(y + taps[k]);
        const float b = E::cached(bias + cv);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float r = E::round(activate<ACT>(raw[k] + b));
          m[0] = k ? pool_max(m[0], r) : r;
        }
        E::store(out + dst + j, m[0]);
      }
    }
  }
}

// Streaming multiprocessors of the current device, read once per device.
int sm_count() {
  static int counts[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 132;
  if (!counts[dev])
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev] > 0 ? counts[dev] : 132;
}

template <typename T, int ACT, bool PRE, bool VEC>
cudaError_t launch(const void* y, const void* pre, const void* bias,
                   void* out, long long n, int c, int inner,
                   cudaStream_t stream) {
  static int per_sm = 0;                // resident blocks per SM
  if (!per_sm) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dvg_elementwise_epilogue<T, ACT, PRE, VEC>, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
  }
  const long long units = VEC ? n / Elem<T>::kVec : n;
  const int cu = VEC ? c / Elem<T>::kVec : c;
  long long blocks = (units + kThreads - 1) / kThreads;
  const long long full = (long long)sm_count() * per_sm;
  if (blocks > full) blocks = full;
  dvg_elementwise_epilogue<T, ACT, PRE, VEC>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(pre),
      static_cast<const T*>(bias), static_cast<T*>(out), units, cu, inner);
  return cudaGetLastError();
}

template <typename T, int ACT>
cudaError_t by_shape(const void* y, const void* pre, const void* bias,
                     void* out, long long n, int c, int inner, int vec,
                     cudaStream_t s) {
  if (pre)
    return vec ? launch<T, ACT, true, true>(y, pre, bias, out, n, c, inner, s)
               : launch<T, ACT, true, false>(y, pre, bias, out, n, c, inner, s);
  return vec ? launch<T, ACT, false, true>(y, pre, bias, out, n, c, inner, s)
             : launch<T, ACT, false, false>(y, pre, bias, out, n, c, inner, s);
}

template <typename T>
cudaError_t by_act(const void* y, const void* pre, const void* bias,
                   void* out, long long n, int c, int inner, int act, int vec,
                   cudaStream_t s) {
  switch (act) {
    case kNone:
      return by_shape<T, kNone>(y, pre, bias, out, n, c, inner, vec, s);
    case kLeakyRelu:
      return by_shape<T, kLeakyRelu>(y, pre, bias, out, n, c, inner, vec, s);
    case kTanh:
      return by_shape<T, kTanh>(y, pre, bias, out, n, c, inner, vec, s);
    case kSigmoid:
      return by_shape<T, kSigmoid>(y, pre, bias, out, n, c, inner, vec, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int ACT, bool VEC>
cudaError_t launch_pool(const void* y, const void* bias, void* out, int n,
                        int c, int h, int w, cudaStream_t stream) {
  static int per_sm = 0;                // resident blocks per SM
  if (!per_sm) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dvg_elementwise_epilogue_pool<T, ACT, VEC>, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
  }
  const long long rows = (long long)n * (h / 2);
  long long blocks = rows;
  const long long full = (long long)sm_count() * per_sm;
  if (blocks > full) blocks = full;
  dvg_elementwise_epilogue_pool<T, ACT, VEC>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(bias),
      static_cast<T*>(out), rows, VEC ? c / Elem<T>::kVec : c, h, w);
  return cudaGetLastError();
}

template <typename T, int ACT>
cudaError_t pool_by_shape(const void* y, const void* bias, void* out, int n,
                          int c, int h, int w, int vec, cudaStream_t s) {
  return vec ? launch_pool<T, ACT, true>(y, bias, out, n, c, h, w, s)
             : launch_pool<T, ACT, false>(y, bias, out, n, c, h, w, s);
}

template <typename T>
cudaError_t pool_by_act(const void* y, const void* bias, void* out, int n,
                        int c, int h, int w, int act, int vec,
                        cudaStream_t s) {
  switch (act) {
    case kNone:
      return pool_by_shape<T, kNone>(y, bias, out, n, c, h, w, vec, s);
    case kLeakyRelu:
      return pool_by_shape<T, kLeakyRelu>(y, bias, out, n, c, h, w, vec, s);
    case kTanh:
      return pool_by_shape<T, kTanh>(y, bias, out, n, c, h, w, vec, s);
    case kSigmoid:
      return pool_by_shape<T, kSigmoid>(y, bias, out, n, c, h, w, vec, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// out = act(y + pre + bias) over n elements of C channels; pre may be null.
// inner: 1 for channels_last memory, H·W for contiguous NCHW. vec: take the
// 16-byte path (the caller has checked channels_last, C % (16 / element
// size) == 0 and 16-byte aligned pointers). act: 0 none, 1 leaky_relu(0.2),
// 2 tanh, 3 sigmoid. Returns the launch's cudaError_t.
extern "C" int dvg_conv_epilogue(const void* y, const void* pre,
                                 const void* bias, void* out, long long n,
                                 int c, int inner, int is_bf16, int act,
                                 int vec, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (c <= 0 || inner <= 0 || (vec && inner != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? by_act<__nv_bfloat16>(y, pre, bias, out, n, c, inner, act, vec, s)
             : by_act<float>(y, pre, bias, out, n, c, inner, act, vec, s);
}

// out = maxpool2x2(act(y + bias)) for channels_last y (n, h, w, c) into
// channels_last out (n, h/2, w/2, c), each tap rounded to the element type
// before the max. vec: take the 16-byte path (the caller has checked c %
// (16 / element size) == 0 and 16-byte aligned pointers). act as above.
// Returns the launch's cudaError_t.
extern "C" int dvg_conv_epilogue_pool(const void* y, const void* bias,
                                      void* out, int n, int c, int h, int w,
                                      int is_bf16, int act, int vec,
                                      void* stream) {
  if (n <= 0 || h < 2 || w < 2) return cudaSuccess;
  if (c <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? pool_by_act<__nv_bfloat16>(y, bias, out, n, c, h, w, act,
                                              vec, s)
                 : pool_by_act<float>(y, bias, out, n, c, h, w, act, vec, s);
}
