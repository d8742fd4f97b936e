// K4: train-mode BatchNorm with per-call batch statistics, fused with the
// activation that follows it, forward and backward.
//
// It replaces no Pallas kernel. On the TPU, XLA fused `dvg_tpu`'s
// batchnorm_apply (statistics, affine, the cast back to the compute type)
// and the activation after it into the conv's neighbours. Eager PyTorch ran
// it as a chain of stock ops, each a pass over the whole map, with every
// step between the cast up and the cast down in f32: about 15 launches a
// forward and 30 a backward, ~44 and ~106 bytes an element. This kernel
// set moves ~6 and ~10 bytes an element of a bf16 map in two launches each
// way.
//
// The map y is (calls·b, C, H, W) in channels_last memory: call k is a
// contiguous slab of rows = b·H·W pixels of C channels. Each call is
// normalized over its own rows:
//   out = act(round_T((y − μ)·scale + β)),  scale = γ·rsqrt(σ² + ε),
// μ and the biased σ² in Acc (f32 for bf16 and f32 maps, f64 for f64), the
// subtract, multiply and add each rounded on its own (no contraction), as
// the plain chain's separate ops round them (ops/batchnorm.py's plain
// version), so the apply is bitwise that chain's given the same μ and scale.
//
// It is bound by bytes, far below the card's ratio of operations to bytes,
// so the design moves each byte once where it can:
//   (a) dvg_elementwise_bn_stats reads y once. Each thread keeps a Welford
//       mean and M2 of its channels over the rows it visits (one reciprocal
//       a row for all its channels), the block merges its threads' by
//       Chan's rule in a fixed order and writes (n, mean, M2) per channel to
//       scratch; the last block of each call (an atomic ticket after a
//       fence, reset by that block) merges the chunks in order and writes μ,
//       rstd, scale and the unbiased σ². No host read, deterministic.
//   (b) dvg_elementwise_bn_apply reads y and writes out once.
//   (c) dvg_elementwise_bn_bwd_sums reads y and the incoming gradient g
//       (and out for tanh) once, recomputes z and the activation's
//       derivative, rounds gz = g·act'(z) to T where the stock activation
//       backward on the card rounds it, and sums Σgz and Σgz·(y − μ) per
//       (call, C); the last block of each call merges the chunks, and the
//       last of those sums dβ and dγ over the calls.
//   (d) dvg_elementwise_bn_bwd writes dy = scale·(gz − Σgz/N −
//       (y − μ)·rstd²·Σgz·(y − μ)/N) in T.
// What backward needs is y (which the conv produced anyway), out for tanh,
// and the (calls, C) vectors: no f32 copy of the map is kept.
//
// Every kernel gives each thread a fixed column (a 16-byte vector of
// channels, 8 bf16, 4 f32 or 2 f64, where C is a multiple of that and the
// maps are 16-byte aligned; else one channel) and a stride of whole rows, so
// a thread loads its channels' parameters once and the block's loads are
// contiguous: blockDim = rpi·cu threads, rpi rows an iteration of cu units.
// The grid is (chunks, calls), chunks of rows per call chosen by the wrapper
// to fill the SMs several times. The C entries launch on the caller's
// stream, allocate nothing and return the launch's error code; the wrapper
// (ops/batchnorm.py) checks shapes, layouts and types, allocates outputs,
// scratch and the persistent tickets, and raises on an error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kUnroll = 4;               // rows in flight a thread
// rows in flight a thread in the backward kernels, which hold two or three
// maps' raw vectors a row
constexpr int kBwdUnroll = 2;

enum Act { kLeakyRelu = 1, kTanh = 2 };  // ops.epilogue.ACTS' codes

__device__ __forceinline__ unsigned bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// Per element type: its accumulation type, the values a 16-byte vector
// holds, the exact widening of one value and the store of one rounded to
// T, and the rounding of an Acc value to T and back.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  using Acc = float;
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
  __device__ static float widen(float v) { return v; }
  __device__ static void store(float* p, float f) { *p = f; }
  __device__ static float round(float f) { return f; }
};

template <>
struct Elem<__nv_bfloat16> {
  using Acc = float;
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
  __device__ static float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  __device__ static void store(__nv_bfloat16* p, float f) {
    *reinterpret_cast<unsigned short*>(p) =
        static_cast<unsigned short>(bf16_bits(f));
  }
  __device__ static float round(float f) {
    return __uint_as_float(bf16_bits(f) << 16);
  }
};

template <>
struct Elem<double> {
  using Acc = double;
  static constexpr int kVec = 2;
  __device__ static void unpack(uint4 v, double* f) {
    f[0] = __hiloint2double(int(v.y), int(v.x));
    f[1] = __hiloint2double(int(v.w), int(v.z));
  }
  __device__ static uint4 pack(const double* f) {
    return make_uint4(unsigned(__double2loint(f[0])),
                      unsigned(__double2hiint(f[0])),
                      unsigned(__double2loint(f[1])),
                      unsigned(__double2hiint(f[1])));
  }
  __device__ static double widen(double v) { return v; }
  __device__ static void store(double* p, double f) { *p = f; }
  __device__ static double round(double f) { return f; }
};

// One unit of a row: a 16-byte vector (VEC) or one element, loaded raw
// (so rows in flight hold 4 registers a vector) and widened to Acc when
// used.
template <typename T, bool VEC>
struct Unit {
  using E = Elem<T>;
  using Acc = typename E::Acc;
  using Raw = std::conditional_t<VEC, uint4, T>;
  static constexpr int V = VEC ? E::kVec : 1;
  __device__ static Raw load(const T* p, long long u) {
    if constexpr (VEC)
      return __ldg(reinterpret_cast<const uint4*>(p) + u);
    else
      return __ldg(p + u);
  }
  __device__ static void unpack(Raw r, Acc* f) {
    if constexpr (VEC)
      E::unpack(r, f);
    else
      f[0] = E::widen(r);
  }
  __device__ static void store(T* p, long long u, const Acc* f) {
    if constexpr (VEC)
      reinterpret_cast<uint4*>(p)[u] = E::pack(f);
    else
      E::store(p + u, f[0]);
  }
};

// Separately rounded arithmetic: no contraction into an FMA.
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float tanh_of(float z) { return tanhf(z); }
__device__ __forceinline__ double tanh_of(double z) { return tanh(z); }

// The activation on a value already rounded to T; the store rounds again.
template <int ACT, typename Acc>
__device__ __forceinline__ Acc activate(Acc z) {
  if (ACT == kLeakyRelu) return z > Acc(0) ? z : z * Acc(0.2);
  return tanh_of(z);
}

// z = round_T((x − μ)·scale + β), each op rounded on its own.
template <typename T, typename Acc>
__device__ __forceinline__ Acc normalized(Acc d, Acc scale, Acc beta) {
  return Elem<T>::round(add_rn(mul_rn(d, scale), beta));
}

// gz = g·act'(z), rounded to T where the stock activation backward rounds
// it: LeakyReLU's from the sign of the rounded z, g·0.2 rounded once;
// tanh's g·(1 − o·o) from the output o in T's own arithmetic, each of the
// three ops rounded to T (c10's BFloat16 operators).
template <typename T, int ACT, typename Acc>
__device__ __forceinline__ Acc act_grad(Acc g, Acc d, Acc scale, Acc beta,
                                        Acc o) {
  using E = Elem<T>;
  if (ACT == kLeakyRelu)
    return normalized<T>(d, scale, beta) > Acc(0) ? g
                                                   : E::round(g * Acc(0.2));
  return E::round(g * E::round(Acc(1) - E::round(o * o)));
}

// Chan's merge of (nb, mb, m2b) into (n, mean, m2).
template <typename Acc>
__device__ __forceinline__ void merge(Acc& n, Acc& mean, Acc& m2, Acc nb,
                                      Acc mb, Acc m2b) {
  if (nb == Acc(0)) return;
  const Acc nn = n + nb, d = mb - mean, f = nb / nn;
  mean += d * f;
  m2 += m2b + d * d * n * f;
  n = nn;
}

// This block's rows of its call: [r0, r1) of `rows`, chunk blockIdx.x of
// gridDim.x.
struct Rows {
  long long r0, r1;
  __device__ explicit Rows(long long rows)
      : r0(rows * blockIdx.x / gridDim.x),
        r1(rows * (blockIdx.x + 1) / gridDim.x) {}
};

// After the block's partial results are written: true in the one block of
// the `tickets[slot]` group of `expected` that arrives last, which also
// resets the ticket for the next launch.
__device__ bool arrived_last(unsigned int* tickets, int slot,
                             unsigned expected) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(tickets + slot, 1u) == expected - 1;
    if (last) tickets[slot] = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// (a) Per-call statistics. stats (4, calls, c): μ, rstd, scale, unbiased
// σ²; part (3, calls, chunks, c): each chunk's n, mean, M2.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
dvg_elementwise_bn_stats(const T* __restrict__ y,
                         const T* __restrict__ gamma,
                         typename Elem<T>::Acc* __restrict__ stats,
                         typename Elem<T>::Acc* __restrict__ part,
                         unsigned int* __restrict__ tickets, long long rows,
                         int c, int rpi, double eps, double unbias) {
  using U = Unit<T, VEC>;
  using Acc = typename U::Acc;
  constexpr int V = U::V;
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* sh_mean = reinterpret_cast<Acc*>(smem);
  Acc* sh_m2 = sh_mean + blockDim.x * V;
  Acc* sh_n = sh_m2 + blockDim.x * V;
  const int cu = c / V, col = threadIdx.x % cu, roff = threadIdx.x / cu;
  const int call = blockIdx.y, calls = gridDim.y, chunks = gridDim.x;
  const T* yc = y + (long long)call * rows * c;
  const Rows span(rows);

  Acc n = 0, mean[V], m2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) mean[j] = m2[j] = 0;
  for (long long r = span.r0 + roff; r < span.r1; r += kUnroll * rpi) {
    typename U::Raw raw[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (r + k * rpi < span.r1) raw[k] = U::load(yc, (r + k * rpi) * cu + col);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (r + k * rpi >= span.r1) break;
      Acc x[V];
      U::unpack(raw[k], x);
      n += Acc(1);
      const Acc inv = Acc(1) / n;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const Acc d = x[j] - mean[j];
        mean[j] += d * inv;
        m2[j] += d * (x[j] - mean[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sh_mean[threadIdx.x * V + j] = mean[j];
    sh_m2[threadIdx.x * V + j] = m2[j];
  }
  sh_n[threadIdx.x] = n;
  __syncthreads();

  const long long plane = (long long)calls * chunks * c;
  Acc* pc = part + ((long long)call * chunks + blockIdx.x) * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const int u = ch / V, j = ch % V;
    Acc bn = 0, bm = 0, bm2 = 0;
    for (int r = 0; r < rpi; ++r) {
      const int t = r * cu + u;
      merge(bn, bm, bm2, sh_n[t], sh_mean[t * V + j], sh_m2[t * V + j]);
    }
    pc[ch] = bn;
    pc[plane + ch] = bm;
    pc[2 * plane + ch] = bm2;
  }
  if (!arrived_last(tickets, call, chunks)) return;

  const long long vec = (long long)calls * c, at = (long long)call * c;
  const Acc* p0 = part + (long long)call * chunks * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    Acc tn = 0, tm = 0, tm2 = 0;
    for (int k = 0; k < chunks; ++k) {
      const Acc* q = p0 + (long long)k * c + ch;
      merge(tn, tm, tm2, __ldcg(q), __ldcg(q + plane), __ldcg(q + 2 * plane));
    }
    const Acc var = tm2 / tn;
    const Acc rstd = Acc(1) / sqrt(add_rn(var, Acc(eps)));
    stats[at + ch] = tm;
    stats[vec + at + ch] = rstd;
    stats[2 * vec + at + ch] = mul_rn(rstd, Elem<T>::widen(gamma[ch]));
    stats[3 * vec + at + ch] = mul_rn(var, Acc(unbias));
  }
}

// This thread's V values of a (calls, c) Acc vector at row `at`, and of a
// (c) vector of T.
template <int V, typename Acc>
__device__ __forceinline__ void column(const Acc* v, long long at, int col,
                                       Acc* out) {
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = v[at + col * V + j];
}

template <typename T, int V>
__device__ __forceinline__ void column_t(const T* v, int col,
                                         typename Elem<T>::Acc* out) {
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = Elem<T>::widen(v[col * V + j]);
}

// (b) out = act(round_T((y − μ)·scale + β)); mean and scale (calls, c).
template <typename T, int ACT, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
dvg_elementwise_bn_apply(const T* __restrict__ y,
                         const typename Elem<T>::Acc* __restrict__ mean,
                         const typename Elem<T>::Acc* __restrict__ scale,
                         const T* __restrict__ beta, T* __restrict__ out,
                         long long rows, int c, int rpi) {
  using U = Unit<T, VEC>;
  using Acc = typename U::Acc;
  constexpr int V = U::V;
  const int cu = c / V, col = threadIdx.x % cu, roff = threadIdx.x / cu;
  const long long at = (long long)blockIdx.y * c;
  const long long base = (long long)blockIdx.y * rows * c;
  const T* yc = y + base;
  T* oc = out + base;
  Acc mu[V], sc[V], be[V];
  column<V>(mean, at, col, mu);
  column<V>(scale, at, col, sc);
  column_t<T, V>(beta, col, be);
  // tanhf's slow path is a call: fewer rows in flight keep its registers
  constexpr int kRows = ACT == kTanh ? kBwdUnroll : kUnroll;
  const Rows span(rows);
  for (long long r = span.r0 + roff; r < span.r1; r += kRows * rpi) {
    typename U::Raw raw[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (r + k * rpi < span.r1) raw[k] = U::load(yc, (r + k * rpi) * cu + col);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (r + k * rpi >= span.r1) break;
      Acc x[V];
      U::unpack(raw[k], x);
#pragma unroll
      for (int j = 0; j < V; ++j)
        x[j] = activate<ACT>(normalized<T>(sub_rn(x[j], mu[j]), sc[j], be[j]));
      U::store(oc, (r + k * rpi) * cu + col, x);
    }
  }
}

// (c) Σgz and Σgz·(y − μ) per (call, c) into sums (2, calls, c), through
// part (2, calls, chunks, c); then dβ = Σ_calls Σgz and dγ = Σ_calls
// rstd·Σgz·(y − μ), each rounded once to T. stats as (a) wrote it.
template <typename T, int ACT, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
dvg_elementwise_bn_bwd_sums(const T* __restrict__ y, const T* __restrict__ g,
                            const T* __restrict__ out,
                            const typename Elem<T>::Acc* __restrict__ stats,
                            const T* __restrict__ beta,
                            typename Elem<T>::Acc* __restrict__ sums,
                            typename Elem<T>::Acc* __restrict__ part,
                            T* __restrict__ dgamma, T* __restrict__ dbeta,
                            unsigned int* __restrict__ tickets,
                            long long rows, int c, int rpi) {
  using U = Unit<T, VEC>;
  using Acc = typename U::Acc;
  constexpr int V = U::V;
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* sh1 = reinterpret_cast<Acc*>(smem);
  Acc* sh2 = sh1 + blockDim.x * V;
  const int cu = c / V, col = threadIdx.x % cu, roff = threadIdx.x / cu;
  const int call = blockIdx.y, calls = gridDim.y, chunks = gridDim.x;
  const long long vec = (long long)calls * c, at = (long long)call * c;
  const long long base = (long long)call * rows * c;
  const T *yc = y + base, *gc = g + base, *oc = out + base;
  Acc mu[V], sc[V], be[V], s1[V], s2[V];
  column<V>(stats, at, col, mu);
  column<V>(stats + 2 * vec, at, col, sc);
  column_t<T, V>(beta, col, be);
#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0;
  const Rows span(rows);
  for (long long r = span.r0 + roff; r < span.r1; r += kBwdUnroll * rpi) {
    typename U::Raw ry[kBwdUnroll], rg[kBwdUnroll], ro[kBwdUnroll];
#pragma unroll
    for (int k = 0; k < kBwdUnroll; ++k) {
      if (r + k * rpi >= span.r1) break;
      const long long u = (r + k * rpi) * cu + col;
      ry[k] = U::load(yc, u);
      rg[k] = U::load(gc, u);
      if (ACT == kTanh) ro[k] = U::load(oc, u);
    }
#pragma unroll
    for (int k = 0; k < kBwdUnroll; ++k) {
      if (r + k * rpi >= span.r1) break;
      Acc x[V], gr[V], o[V];
      U::unpack(ry[k], x);
      U::unpack(rg[k], gr);
      if (ACT == kTanh) U::unpack(ro[k], o);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const Acc d = sub_rn(x[j], mu[j]);
        const Acc gz = act_grad<T, ACT>(gr[j], d, sc[j], be[j],
                                        ACT == kTanh ? o[j] : Acc(0));
        s1[j] += gz;
        s2[j] += gz * d;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sh1[threadIdx.x * V + j] = s1[j];
    sh2[threadIdx.x * V + j] = s2[j];
  }
  __syncthreads();

  const long long plane = (long long)calls * chunks * c;
  Acc* pc = part + ((long long)call * chunks + blockIdx.x) * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const int u = ch / V, j = ch % V;
    Acc b1 = 0, b2 = 0;
    for (int r = 0; r < rpi; ++r) {
      b1 += sh1[(r * cu + u) * V + j];
      b2 += sh2[(r * cu + u) * V + j];
    }
    pc[ch] = b1;
    pc[plane + ch] = b2;
  }
  if (!arrived_last(tickets, call, chunks)) return;

  const Acc* p0 = part + (long long)call * chunks * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    Acc t1 = 0, t2 = 0;
    for (int k = 0; k < chunks; ++k) {
      t1 += __ldcg(p0 + (long long)k * c + ch);
      t2 += __ldcg(p0 + plane + (long long)k * c + ch);
    }
    sums[at + ch] = t1;
    sums[vec + at + ch] = t2;
  }
  if (!arrived_last(tickets, calls, calls)) return;

  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    Acc db = 0, dg = 0;
    for (int k = 0; k < calls; ++k) {
      const long long q = (long long)k * c + ch;
      db += __ldcg(sums + q);
      dg += mul_rn(__ldcg(sums + vec + q), __ldcg(stats + vec + q));
    }
    Elem<T>::store(dbeta + ch, db);
    Elem<T>::store(dgamma + ch, dg);
  }
}

// (d) dy = round_T(scale·((gz − Σgz/N) − (y − μ)·(rstd²·Σgz·(y − μ)/N)))
// with N = rows, from stats and sums as (a) and (c) wrote them.
template <typename T, int ACT, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
dvg_elementwise_bn_bwd(const T* __restrict__ y, const T* __restrict__ g,
                       const T* __restrict__ out,
                       const typename Elem<T>::Acc* __restrict__ stats,
                       const T* __restrict__ beta,
                       const typename Elem<T>::Acc* __restrict__ sums,
                       T* __restrict__ dy, long long rows, int c, int rpi) {
  using U = Unit<T, VEC>;
  using Acc = typename U::Acc;
  constexpr int V = U::V;
  const int cu = c / V, col = threadIdx.x % cu, roff = threadIdx.x / cu;
  const long long vec = (long long)gridDim.y * c;
  const long long at = (long long)blockIdx.y * c;
  const long long base = (long long)blockIdx.y * rows * c;
  const T *yc = y + base, *gc = g + base, *oc = out + base;
  T* dc = dy + base;
  Acc mu[V], sc[V], be[V], m1[V], m2[V];
  column<V>(stats, at, col, mu);
  column<V>(stats + 2 * vec, at, col, sc);
  column_t<T, V>(beta, col, be);
  column<V>(sums, at, col, m1);
  column<V>(sums + vec, at, col, m2);
  const Acc n = Acc(rows);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const Acc rs = stats[vec + at + col * V + j];
    m1[j] = m1[j] / n;
    m2[j] = mul_rn(mul_rn(rs, rs), m2[j]) / n;
  }
  const Rows span(rows);
  for (long long r = span.r0 + roff; r < span.r1; r += kBwdUnroll * rpi) {
    typename U::Raw ry[kBwdUnroll], rg[kBwdUnroll], ro[kBwdUnroll];
#pragma unroll
    for (int k = 0; k < kBwdUnroll; ++k) {
      if (r + k * rpi >= span.r1) break;
      const long long u = (r + k * rpi) * cu + col;
      ry[k] = U::load(yc, u);
      rg[k] = U::load(gc, u);
      if (ACT == kTanh) ro[k] = U::load(oc, u);
    }
#pragma unroll
    for (int k = 0; k < kBwdUnroll; ++k) {
      if (r + k * rpi >= span.r1) break;
      Acc x[V], gr[V], o[V];
      U::unpack(ry[k], x);
      U::unpack(rg[k], gr);
      if (ACT == kTanh) U::unpack(ro[k], o);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const Acc d = sub_rn(x[j], mu[j]);
        const Acc gz = act_grad<T, ACT>(gr[j], d, sc[j], be[j],
                                        ACT == kTanh ? o[j] : Acc(0));
        x[j] = mul_rn(sc[j], sub_rn(sub_rn(gz, m1[j]), mul_rn(d, m2[j])));
      }
      U::store(dc, (r + k * rpi) * cu + col, x);
    }
  }
}

// The launch shape every kernel shares: (chunks, calls) blocks of rpi·cu
// threads, cu = c / V units a row.
struct Shape {
  dim3 grid, block;
  Shape(int calls, int chunks, int c, int v, int rpi)
      : grid(chunks, calls), block(rpi * (c / v)) {}
};

template <typename T, bool VEC>
cudaError_t stats_v(const void* y, const void* gamma, void* stats,
                    void* part, unsigned* tickets, int calls, long long rows,
                    int c, int rpi, int chunks, double eps, double unbias,
                    cudaStream_t s) {
  using U = Unit<T, VEC>;
  using Acc = typename U::Acc;
  const Shape sh(calls, chunks, c, U::V, rpi);
  const size_t smem = sh.block.x * (2 * U::V + 1) * sizeof(Acc);
  dvg_elementwise_bn_stats<T, VEC><<<sh.grid, sh.block, smem, s>>>(
      static_cast<const T*>(y), static_cast<const T*>(gamma),
      static_cast<Acc*>(stats), static_cast<Acc*>(part), tickets, rows, c,
      rpi, eps, unbias);
  return cudaGetLastError();
}

template <typename T>
cudaError_t stats_t(const void* y, const void* gamma, void* stats,
                    void* part, unsigned* tickets, int calls, long long rows,
                    int c, int vec, int rpi, int chunks, double eps,
                    double unbias, cudaStream_t s) {
  return vec ? stats_v<T, true>(y, gamma, stats, part, tickets, calls, rows,
                                c, rpi, chunks, eps, unbias, s)
             : stats_v<T, false>(y, gamma, stats, part, tickets, calls, rows,
                                 c, rpi, chunks, eps, unbias, s);
}

template <typename T, int ACT, bool VEC>
cudaError_t apply_v(const void* y, const void* mean, const void* scale,
                    const void* beta, void* out, int calls, long long rows,
                    int c, int rpi, int chunks, cudaStream_t s) {
  using U = Unit<T, VEC>;
  using Acc = typename U::Acc;
  const Shape sh(calls, chunks, c, U::V, rpi);
  dvg_elementwise_bn_apply<T, ACT, VEC><<<sh.grid, sh.block, 0, s>>>(
      static_cast<const T*>(y), static_cast<const Acc*>(mean),
      static_cast<const Acc*>(scale), static_cast<const T*>(beta),
      static_cast<T*>(out), rows, c, rpi);
  return cudaGetLastError();
}

template <typename T, int ACT>
cudaError_t apply_t(const void* y, const void* mean, const void* scale,
                    const void* beta, void* out, int calls, long long rows,
                    int c, int vec, int rpi, int chunks, cudaStream_t s) {
  return vec ? apply_v<T, ACT, true>(y, mean, scale, beta, out, calls, rows,
                                     c, rpi, chunks, s)
             : apply_v<T, ACT, false>(y, mean, scale, beta, out, calls, rows,
                                      c, rpi, chunks, s);
}

template <typename T, int ACT, bool VEC>
cudaError_t bwd_sums_v(const void* y, const void* g, const void* out,
                       const void* stats, const void* beta, void* sums,
                       void* part, void* dgamma, void* dbeta,
                       unsigned* tickets, int calls, long long rows, int c,
                       int rpi, int chunks, cudaStream_t s) {
  using U = Unit<T, VEC>;
  using Acc = typename U::Acc;
  const Shape sh(calls, chunks, c, U::V, rpi);
  const size_t smem = sh.block.x * 2 * U::V * sizeof(Acc);
  dvg_elementwise_bn_bwd_sums<T, ACT, VEC><<<sh.grid, sh.block, smem, s>>>(
      static_cast<const T*>(y), static_cast<const T*>(g),
      static_cast<const T*>(out), static_cast<const Acc*>(stats),
      static_cast<const T*>(beta), static_cast<Acc*>(sums),
      static_cast<Acc*>(part), static_cast<T*>(dgamma),
      static_cast<T*>(dbeta), tickets, rows, c, rpi);
  return cudaGetLastError();
}

template <typename T, int ACT>
cudaError_t bwd_sums_t(const void* y, const void* g, const void* out,
                       const void* stats, const void* beta, void* sums,
                       void* part, void* dgamma, void* dbeta,
                       unsigned* tickets, int calls, long long rows, int c,
                       int vec, int rpi, int chunks, cudaStream_t s) {
  return vec ? bwd_sums_v<T, ACT, true>(y, g, out, stats, beta, sums, part,
                                        dgamma, dbeta, tickets, calls, rows,
                                        c, rpi, chunks, s)
             : bwd_sums_v<T, ACT, false>(y, g, out, stats, beta, sums, part,
                                         dgamma, dbeta, tickets, calls, rows,
                                         c, rpi, chunks, s);
}

template <typename T, int ACT, bool VEC>
cudaError_t bwd_v(const void* y, const void* g, const void* out,
                  const void* stats, const void* beta, const void* sums,
                  void* dy, int calls, long long rows, int c, int rpi,
                  int chunks, cudaStream_t s) {
  using U = Unit<T, VEC>;
  using Acc = typename U::Acc;
  const Shape sh(calls, chunks, c, U::V, rpi);
  dvg_elementwise_bn_bwd<T, ACT, VEC><<<sh.grid, sh.block, 0, s>>>(
      static_cast<const T*>(y), static_cast<const T*>(g),
      static_cast<const T*>(out), static_cast<const Acc*>(stats),
      static_cast<const T*>(beta), static_cast<const Acc*>(sums),
      static_cast<T*>(dy), rows, c, rpi);
  return cudaGetLastError();
}

template <typename T, int ACT>
cudaError_t bwd_t(const void* y, const void* g, const void* out,
                  const void* stats, const void* beta, const void* sums,
                  void* dy, int calls, long long rows, int c, int vec,
                  int rpi, int chunks, cudaStream_t s) {
  return vec ? bwd_v<T, ACT, true>(y, g, out, stats, beta, sums, dy, calls,
                                   rows, c, rpi, chunks, s)
             : bwd_v<T, ACT, false>(y, g, out, stats, beta, sums, dy, calls,
                                    rows, c, rpi, chunks, s);
}

// dtype codes: 0 f32, 1 bf16, 2 f64 (ops/batchnorm.py's DTYPES)
#define DVG_BY_DTYPE(fn, ...)                      \
  switch (dtype) {                                 \
    case 0: return fn<float>(__VA_ARGS__);         \
    case 1: return fn<__nv_bfloat16>(__VA_ARGS__); \
    case 2: return fn<double>(__VA_ARGS__);        \
    default: return cudaErrorInvalidValue;         \
  }

#define DVG_BY_DTYPE_ACT(fn, ...)                                          \
  switch (dtype * 4 + act) {                                               \
    case 0 * 4 + kLeakyRelu: return fn<float, kLeakyRelu>(__VA_ARGS__);   \
    case 0 * 4 + kTanh: return fn<float, kTanh>(__VA_ARGS__);             \
    case 1 * 4 + kLeakyRelu:                                               \
      return fn<__nv_bfloat16, kLeakyRelu>(__VA_ARGS__);                   \
    case 1 * 4 + kTanh: return fn<__nv_bfloat16, kTanh>(__VA_ARGS__);     \
    case 2 * 4 + kLeakyRelu: return fn<double, kLeakyRelu>(__VA_ARGS__);  \
    case 2 * 4 + kTanh: return fn<double, kTanh>(__VA_ARGS__);            \
    default: return cudaErrorInvalidValue;                                 \
  }

bool bad_shape(int calls, long long rows, int c, int rpi, int chunks) {
  return calls < 1 || rows < 1 || c < 1 || rpi < 1 || chunks < 1;
}

}  // namespace

// Every entry: y and the maps are channels_last (calls·rows pixels of c
// channels), vec 1 takes the 16-byte path (the caller has checked c and the
// alignment), rpi rows an iteration, chunks blocks a call; the (calls, c)
// vectors and the scratch are Acc (f32, or f64 for an f64 map); tickets
// hold calls + 1 zeros. Each returns the launch's cudaError_t.

// (a): stats (4, calls, c) = μ, rstd, scale = rstd·γ, σ²·unbias.
extern "C" int dvg_bn_stats(const void* y, const void* gamma, void* stats,
                            void* part, unsigned* tickets, int calls,
                            long long rows, int c, int dtype, int vec,
                            int rpi, int chunks, double eps, double unbias,
                            void* stream) {
  if (bad_shape(calls, rows, c, rpi, chunks)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DVG_BY_DTYPE(stats_t, y, gamma, stats, part, tickets, calls, rows, c, vec,
               rpi, chunks, eps, unbias, s)
}

// (b): out = act(round((y − mean)·scale + beta)); act 1 leaky_relu(0.2),
// 2 tanh.
extern "C" int dvg_bn_apply(const void* y, const void* mean,
                            const void* scale, const void* beta, void* out,
                            int calls, long long rows, int c, int dtype,
                            int act, int vec, int rpi, int chunks,
                            void* stream) {
  if (bad_shape(calls, rows, c, rpi, chunks)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DVG_BY_DTYPE_ACT(apply_t, y, mean, scale, beta, out, calls, rows, c, vec,
                   rpi, chunks, s)
}

// (c): sums (2, calls, c), dgamma and dbeta (c) in the map's type.
extern "C" int dvg_bn_bwd_sums(const void* y, const void* g, const void* out,
                               const void* stats, const void* beta,
                               void* sums, void* part, void* dgamma,
                               void* dbeta, unsigned* tickets, int calls,
                               long long rows, int c, int dtype, int act,
                               int vec, int rpi, int chunks, void* stream) {
  if (bad_shape(calls, rows, c, rpi, chunks)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DVG_BY_DTYPE_ACT(bwd_sums_t, y, g, out, stats, beta, sums, part, dgamma,
                   dbeta, tickets, calls, rows, c, vec, rpi, chunks, s)
}

// (d): dy, of y's shape and layout.
extern "C" int dvg_bn_bwd(const void* y, const void* g, const void* out,
                          const void* stats, const void* beta,
                          const void* sums, void* dy, int calls,
                          long long rows, int c, int dtype, int act, int vec,
                          int rpi, int chunks, void* stream) {
  if (bad_shape(calls, rows, c, rpi, chunks)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DVG_BY_DTYPE_ACT(bwd_t, y, g, out, stats, beta, sums, dy, calls, rows, c,
                   vec, rpi, chunks, s)
}
