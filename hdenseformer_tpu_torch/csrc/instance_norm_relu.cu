// InstanceNorm (+ affine) + ReLU over channels-last volumes, hand-written for
// Hopper (sm_90a). Forward, and below it the backward.
//
// Replaces: hdenseformer_tpu/ops/instance_norm.py::fused_instance_norm_relu
// (Pallas body: its inner `kernel`), which walks the spatial blocks of one
// sample twice in grid order, summing x and x^2 into VMEM scratch in the
// first phase and normalizing in the second. The function it computes is the
// one ops/fused_norm.py computes in JAX's default path: per (n, c) mean and
// biased variance over the spatial axis, (x - mean) * rsqrt(var + eps), then
// scale and bias, then ReLU, fp32 statistics, output in the input's dtype.
//
// What bounds it on this card: HBM bytes. The largest call on the serving
// path is x of (8, 144^3, 32) bf16: 1.5 GB read and 1.5 GB written, about
// 0.9 ms at 3.35 TB/s (data-sheet estimate; PERF.md holds the measured time).
// This design reads x twice, so its floor is 1.5x that.
//
// Design. Hopper's blocks run in no order, so the reduction over the S rows
// of one (n, c) is split across blocks and merged in fixed order:
//   1. partial stats: block (chunk k, sample n, channel tile z), walked from
//      the last chunk to the first, so that the end of x, which its producer
//      wrote last, is read while it may still be in L2. Every access
//      is one V-byte vector (16 bytes = 8 bf16 or 4 fp32 channels where C and
//      the address allow; 8, 4 or 2 otherwise). TV threads cover a row's
//      vectors in the tile (TV a power of two <= 32), so a warp reads 32 / TV
//      whole neighbouring rows: 8 rows of 64 bytes at C = 32 bf16. Thread
//      (g, lane) reduces the m rows g, g + RPB, ... of the chunk (RPB = 256 /
//      TV), four loads in flight, as shifted sums s1 = sum(x - x0) and s2 =
//      sum((x - x0)^2): no division per element, and the centred accuracy
//      that ops/fused_norm.py insists on. The shift x0 is the sample's first
//      value of the channel (row 0), one for all blocks of (n, c), so every
//      mean below is carried relative to it: near x0 the fp32 mean keeps the
//      precision of the deviations, which an input of 1000 + N(0, 1) needs.
//      (count, mean, M2) per thread follow once, then a fixed-shape tree of
//      Chan merges over the RPB row groups in shared memory;
//   2. finalize: one block per (c, n) merges the chunks' (mean, M2) with a
//      fixed-shape tree and writes the mean (relative to x0) and
//      rsqrt(var + eps);
//   3. normalize: the geometry of kernel 1, walked in the reverse order,
//      first chunk first, so that the part of x that kernel 1 read last
//      (still in the 50 MB L2) is read first. Each thread holds x0, the mean, rstd * scale and bias of
//      its V / E channels in registers and computes
//      ((x - x0) - mean) * (rstd * scale) + bias; y is stored with streaming
//      (evict-first) stores so that it does not push x out of L2.
// There are no atomics and every merge has a fixed order, so reruns agree bit
// for bit.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // independent vector loads in flight per thread

// Element storage: fp32 as float, bf16 as its 16 raw bits.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  using S = float;
  static __device__ __forceinline__ float load(S s) { return s; }
  static __device__ __forceinline__ S store(float v) { return v; }
};
template <>
struct Elem<__nv_bfloat16> {
  using S = unsigned short;
  static __device__ __forceinline__ float load(S s) {
    return __uint_as_float((unsigned)s << 16);
  }
  static __device__ __forceinline__ S store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// Elements in one vector of type R (uint4, uint2, unsigned, unsigned short).
template <typename T, typename R>
constexpr int kCV = sizeof(R) / sizeof(typename Elem<T>::S);

// One vector of kCV elements, read and written as a single access.
template <typename T, typename R>
union Vec {
  R raw;
  typename Elem<T>::S e[kCV<T, R>];
};

// Chan et al.: fold (nb, mean_b, m2_b) into (n, mean, m2).
__device__ __forceinline__ void merge(float& n, float& mean, float& m2, float nb,
                                      float mean_b, float m2_b) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float delta = mean_b - mean;
  const float fb = nb / nn;
  mean = fmaf(delta, fb, mean);
  m2 = m2 + m2_b + delta * delta * n * fb;
  n = nn;
}

// Launch geometry shared by kernels 1 and 3.
struct Geom {
  long long S;  // rows per sample
  int C;        // channels
  int vpr;      // vectors per row: C / CV
  int tv;       // threads per row in a channel tile (power of two)
  int m;        // rows per thread in a chunk
  int K;        // chunks per sample
};

template <typename T, typename R>
__global__ void __launch_bounds__(kThreads)
partial_stats_kernel(const T* __restrict__ x, float* __restrict__ part_mean,
                     float* __restrict__ part_m2, Geom gm) {
  using V = Vec<T, R>;
  constexpr int CV = kCV<T, R>;
  // last chunk first: the end of x, which its producer wrote last, may
  // still be in L2
  const int k = gridDim.x - 1 - blockIdx.x, n = gridDim.y - 1 - blockIdx.y;
  const int rpb = kThreads / gm.tv;
  const int lane = threadIdx.x % gm.tv, g = threadIdx.x / gm.tv;
  const int vi = (gridDim.z - 1 - blockIdx.z) * gm.tv + lane;  // vector within a row
  const long long r0 = (long long)k * rpb * gm.m;
  const int rows = (int)min((long long)rpb * gm.m, gm.S - r0);
  // rows of this chunk that this thread visits: g, g + rpb, ... < rows
  const int mine = vi < gm.vpr && g < rows ? min(gm.m, (rows - g + rpb - 1) / rpb) : 0;

  float x0[CV], s1[CV], s2[CV];
#pragma unroll
  for (int j = 0; j < CV; ++j) x0[j] = s1[j] = s2[j] = 0.f;
  if (mine > 0) {
    // the shift: row 0 of the sample, the same for every block of (n, c)
    V first;
    first.raw = reinterpret_cast<const R*>(x + (long long)n * gm.S * gm.C)[vi];
#pragma unroll
    for (int j = 0; j < CV; ++j) x0[j] = Elem<T>::load(first.e[j]);
    const R* p = reinterpret_cast<const R*>(x + ((long long)n * gm.S + r0 + g) * gm.C) + vi;
    const long long step = (long long)rpb * gm.vpr;  // vectors between my rows
    for (int i = 0; i < mine; i += kUnroll) {
      V v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (i + u < mine) v[u].raw = p[(i + u) * step];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i + u < mine) {
#pragma unroll
          for (int j = 0; j < CV; ++j) {
            const float d = Elem<T>::load(v[u].e[j]) - x0[j];
            s1[j] += d;
            s2[j] = fmaf(d, d, s2[j]);
          }
        }
      }
    }
  }
  // (count, mean, M2) of this thread's rows, then a tree over the row groups
  float cnt = (float)mine, mean[CV], m2[CV];
  const float inv = mine > 0 ? 1.f / cnt : 0.f;
#pragma unroll
  for (int j = 0; j < CV; ++j) {
    const float d = s1[j] * inv;
    mean[j] = d;  // relative to the shift x0
    m2[j] = fmaxf(fmaf(-s1[j], d, s2[j]), 0.f);
  }
  __shared__ float s_cnt[kThreads];
  __shared__ float s_mean[kThreads * CV], s_m2[kThreads * CV];
  for (int h = rpb / 2; h > 0; h >>= 1) {
    if (g < 2 * h) {  // the groups still live at this level publish their state
      s_cnt[threadIdx.x] = cnt;
#pragma unroll
      for (int j = 0; j < CV; ++j) {
        s_mean[threadIdx.x * CV + j] = mean[j];
        s_m2[threadIdx.x * CV + j] = m2[j];
      }
    }
    __syncthreads();
    if (g < h) {
      const int o = threadIdx.x + h * gm.tv;
      const float nb = s_cnt[o];
#pragma unroll
      for (int j = 0; j < CV; ++j) {
        float nn = cnt;
        merge(nn, mean[j], m2[j], nb, s_mean[o * CV + j], s_m2[o * CV + j]);
      }
      cnt += nb;
    }
    __syncthreads();
  }
  if (g == 0 && vi < gm.vpr) {
#pragma unroll
    for (int j = 0; j < CV; ++j) {
      const long long off = ((long long)n * gm.C + vi * CV + j) * gm.K + k;
      part_mean[off] = mean[j];
      part_m2[off] = m2[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
finalize_kernel(const float* __restrict__ part_mean, const float* __restrict__ part_m2,
                float* __restrict__ stats, long long S, int C, long long chunk, int K,
                float eps) {
  const int c = blockIdx.x, n = blockIdx.y;
  const long long base = ((long long)n * C + c) * K;
  float cn = 0.f, mean = 0.f, m2 = 0.f;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float nb = (float)min(chunk, S - (long long)k * chunk);
    merge(cn, mean, m2, nb, part_mean[base + k], part_m2[base + k]);
  }
  __shared__ float s_n[kThreads], s_mean[kThreads], s_m2[kThreads];
  s_n[threadIdx.x] = cn;
  s_mean[threadIdx.x] = mean;
  s_m2[threadIdx.x] = m2;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) {
      const int o = threadIdx.x + half;
      merge(cn, mean, m2, s_n[o], s_mean[o], s_m2[o]);
      s_n[threadIdx.x] = cn;
      s_mean[threadIdx.x] = mean;
      s_m2[threadIdx.x] = m2;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    stats[((long long)n * C + c) * 2] = mean;
    stats[((long long)n * C + c) * 2 + 1] = rsqrtf(m2 / cn + eps);
  }
}

template <typename T, typename R>
__global__ void __launch_bounds__(kThreads)
normalize_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 T* __restrict__ y, Geom gm, int relu) {
  using V = Vec<T, R>;
  constexpr int CV = kCV<T, R>;
  // reverse order of kernel 1: the chunks it read last come first
  const int k = blockIdx.x, n = blockIdx.y;
  const int rpb = kThreads / gm.tv;
  const int lane = threadIdx.x % gm.tv, g = threadIdx.x / gm.tv;
  const int vi = blockIdx.z * gm.tv + lane;
  const long long r0 = (long long)k * rpb * gm.m;
  const int rows = (int)min((long long)rpb * gm.m, gm.S - r0);
  if (vi >= gm.vpr || g >= rows) return;
  const int mine = min(gm.m, (rows - g + rpb - 1) / rpb);
  V first;
  first.raw = reinterpret_cast<const R*>(x + (long long)n * gm.S * gm.C)[vi];
  float x0[CV], mean[CV], a[CV], b[CV];
#pragma unroll
  for (int j = 0; j < CV; ++j) {
    x0[j] = Elem<T>::load(first.e[j]);
    const int c = vi * CV + j;
    mean[j] = stats[((long long)n * gm.C + c) * 2];
    const float rstd = stats[((long long)n * gm.C + c) * 2 + 1];
    a[j] = scale ? scale[c] * rstd : rstd;
    b[j] = bias ? bias[c] : 0.f;
  }
  const long long off = ((long long)n * gm.S + r0 + g) * gm.C;
  const R* p = reinterpret_cast<const R*>(x + off) + vi;
  R* q = reinterpret_cast<R*>(y + off) + vi;
  const long long step = (long long)rpb * gm.vpr;
  for (int i = 0; i < mine; i += kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u < mine) v[u].raw = p[(i + u) * step];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u < mine) {
        V o;
#pragma unroll
        for (int j = 0; j < CV; ++j) {
          float t = fmaf((Elem<T>::load(v[u].e[j]) - x0[j]) - mean[j], a[j], b[j]);
          if (relu) t = fmaxf(t, 0.f);
          o.e[j] = Elem<T>::store(t);
        }
        __stcs(q + (i + u) * step, o.raw);
      }
    }
  }
}

template <typename T, typename R>
int launch(const void* x, const float* scale, const float* bias, void* y, float* part,
           float* stats, int N, long long S, int C, int CT, long long chunk, int K,
           float eps, int relu, cudaStream_t stream) {
  constexpr int CV = kCV<T, R>;
  Geom gm;
  gm.S = S;
  gm.C = C;
  gm.vpr = C / CV;
  gm.tv = CT / CV;
  gm.K = K;
  const int rpb = gm.tv > 0 ? kThreads / gm.tv : 0;
  if (C % CV || CT % CV || gm.tv < 1 || gm.tv > 32 || (gm.tv & (gm.tv - 1)) ||
      chunk % rpb || (long long)K * chunk < S || N > 65535 ||
      (gm.vpr + gm.tv - 1) / gm.tv > 65535)
    return (int)cudaErrorInvalidValue;
  gm.m = (int)(chunk / rpb);
  float* part_mean = part;
  float* part_m2 = part + (long long)N * C * K;
  const dim3 grid(K, N, (gm.vpr + gm.tv - 1) / gm.tv);
  partial_stats_kernel<T, R><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), part_mean, part_m2, gm);
  finalize_kernel<<<dim3(C, N), kThreads, 0, stream>>>(part_mean, part_m2, stats, S, C,
                                                       chunk, K, eps);
  normalize_kernel<T, R><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), stats, scale, bias, static_cast<T*>(y), gm, relu);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vec(int vec_bytes, const void* x, const float* scale, const float* bias,
               void* y, float* part, float* stats, int N, long long S, int C, int CT,
               long long chunk, int K, float eps, int relu, cudaStream_t s) {
  switch (vec_bytes) {
    case 16: return launch<T, uint4>(x, scale, bias, y, part, stats, N, S, C, CT, chunk, K, eps, relu, s);
    case 8: return launch<T, uint2>(x, scale, bias, y, part, stats, N, S, C, CT, chunk, K, eps, relu, s);
    case 4: return launch<T, unsigned>(x, scale, bias, y, part, stats, N, S, C, CT, chunk, K, eps, relu, s);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch<T, unsigned short>(x, scale, bias, y, part, stats, N, S, C, CT, chunk, K, eps, relu, s);
      else
        return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Backward.
//
// Replaces: hdenseformer_tpu/ops/fused_norm.py::_bwd_rule (plain XLA in JAX,
// not Pallas), for the unshifted, per-sample case. With the forward's
// statistics (mean, inv = rsqrt(var + eps)) per (n, c) and m = S rows:
//   dy_eff = relu ? dy * mask : dy, mask rebuilt from x against the per-(n, c)
//            threshold mean - b / (g * inv) (x < it where g < 0, all or none
//            by the sign of b where g == 0; x > mean without affine), so no
//            full-size mask or pre-activation is kept;
//   t1 = sum dy_eff, t2 = sum dy_eff * (x - mean);
//   dx = coef * dy_eff + A + (x - mean) * B, coef = g * inv,
//        B = -coef * inv * (inv * t2) / m, A = -coef * t1 / m
// (fused_norm's fma form dx = coef * dy_eff + A + x * B, written relative
// to the mean: the forward's shift x0 carries it, as there). The caller
// sums dscale = sum_n inv * t2 and dbias = sum_n t1 from the (N, C) t1, t2.
//
// What bounds it: HBM bytes. At (1, 144^3, 32) bf16 the least is x and dy
// read once and dx written once, 6 bytes an element (0.17 ms at 3.35 TB/s);
// this design reads x and dy twice, 10 bytes an element. Three launches in
// the geometry of the forward (Geom, the same grid):
//   a. reduce: each thread sums (t1, t2) over its rows of a chunk, four
//      vector loads of x and of dy in flight, then a fixed-shape tree over
//      the row groups in shared memory writes one partial per (n, c, chunk),
//      walked from the last chunk to the first as the forward's statistics;
//   b. finalize: one block per (c, n) sums the chunks' partials in a fixed
//      order and writes (t1, t2);
//   c. dx: the geometry of (a) walked first chunk first, so that the part of
//      x and dy that (a) read last (still in L2) is read first; dx is stored
//      evict-first.
// No atomics: reruns agree bit for bit.

// Per-channel constants of the backward, from the forward's statistics.
// The mask passes x where lo < x < hi, which spells every branch of
// fused_norm.py::_relu_mask: (thr, inf), (-inf, thr), everything, nothing.
struct BwdChan {
  float x0, mean, inv, coef, lo, hi;
};

__device__ __forceinline__ BwdChan bwd_chan(float x0, const float* stats, const float* scale,
                                            const float* bias, long long nc, int c,
                                            int relu) {
  BwdChan k;
  k.x0 = x0;
  k.mean = stats[nc * 2];  // relative to x0
  k.inv = stats[nc * 2 + 1];
  const float g = scale ? scale[c] : 1.f;
  k.coef = __fmul_rn(g, k.inv);
  const float inf = __int_as_float(0x7f800000);
  k.lo = -inf;
  k.hi = inf;
  if (relu) {
    // in the absolute frame and in fused_norm's order of operations, so that
    // the plain version given the same statistics draws the same mask
    const float mean_abs = __fadd_rn(x0, k.mean);
    if (!scale) {
      k.lo = mean_abs;
    } else {
      const float b = bias[c];
      const float thr = __fsub_rn(mean_abs, __fdiv_rn(b, __fmul_rn(g == 0.f ? 1.f : g, k.inv)));
      if (g > 0.f) k.lo = thr;
      else if (g < 0.f) k.hi = thr;
      else if (!(b > 0.f)) k.lo = inf;  // g == 0: the output is relu(b)
    }
  }
  return k;
}

template <typename T, typename R>
__global__ void __launch_bounds__(kThreads)
bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ stats, const float* __restrict__ scale,
                  const float* __restrict__ bias, float* __restrict__ part_t1,
                  float* __restrict__ part_t2, Geom gm, int relu) {
  using V = Vec<T, R>;
  constexpr int CV = kCV<T, R>;
  const int k = gridDim.x - 1 - blockIdx.x, n = gridDim.y - 1 - blockIdx.y;
  const int rpb = kThreads / gm.tv;
  const int lane = threadIdx.x % gm.tv, g = threadIdx.x / gm.tv;
  const int vi = (gridDim.z - 1 - blockIdx.z) * gm.tv + lane;
  const long long r0 = (long long)k * rpb * gm.m;
  const int rows = (int)min((long long)rpb * gm.m, gm.S - r0);
  const int mine = vi < gm.vpr && g < rows ? min(gm.m, (rows - g + rpb - 1) / rpb) : 0;

  float t1[CV], t2[CV];
#pragma unroll
  for (int j = 0; j < CV; ++j) t1[j] = t2[j] = 0.f;
  if (mine > 0) {
    BwdChan ch[CV];
    V first;
    first.raw = reinterpret_cast<const R*>(x + (long long)n * gm.S * gm.C)[vi];
#pragma unroll
    for (int j = 0; j < CV; ++j)
      ch[j] = bwd_chan(Elem<T>::load(first.e[j]), stats, scale, bias,
                       (long long)n * gm.C + vi * CV + j, vi * CV + j, relu);
    const long long off = ((long long)n * gm.S + r0 + g) * gm.C;
    const R* px = reinterpret_cast<const R*>(x + off) + vi;
    const R* pd = reinterpret_cast<const R*>(dy + off) + vi;
    const long long step = (long long)rpb * gm.vpr;
    for (int i = 0; i < mine; i += kUnroll) {
      V vx[kUnroll], vd[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i + u < mine) {
          vx[u].raw = px[(i + u) * step];
          vd[u].raw = pd[(i + u) * step];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i + u < mine) {
#pragma unroll
          for (int j = 0; j < CV; ++j) {
            const float xf = Elem<T>::load(vx[u].e[j]);
            const float e = xf > ch[j].lo && xf < ch[j].hi ? Elem<T>::load(vd[u].e[j]) : 0.f;
            t1[j] += e;
            t2[j] = fmaf(e, (xf - ch[j].x0) - ch[j].mean, t2[j]);
          }
        }
      }
    }
  }
  // a fixed-shape tree over the row groups
  __shared__ float s_t1[kThreads * CV], s_t2[kThreads * CV];
  for (int h = rpb / 2; h > 0; h >>= 1) {
    if (g >= h && g < 2 * h) {  // the upper half of the live groups publishes
#pragma unroll
      for (int j = 0; j < CV; ++j) {
        s_t1[threadIdx.x * CV + j] = t1[j];
        s_t2[threadIdx.x * CV + j] = t2[j];
      }
    }
    __syncthreads();
    if (g < h) {
      const int o = threadIdx.x + h * gm.tv;
#pragma unroll
      for (int j = 0; j < CV; ++j) {
        t1[j] += s_t1[o * CV + j];
        t2[j] += s_t2[o * CV + j];
      }
    }
    __syncthreads();
  }
  if (g == 0 && vi < gm.vpr) {
#pragma unroll
    for (int j = 0; j < CV; ++j) {
      const long long off = ((long long)n * gm.C + vi * CV + j) * gm.K + k;
      part_t1[off] = t1[j];
      part_t2[off] = t2[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bwd_finalize_kernel(const float* __restrict__ part_t1, const float* __restrict__ part_t2,
                    float* __restrict__ tsum, int C, int K) {
  const int c = blockIdx.x, n = blockIdx.y;
  const long long base = ((long long)n * C + c) * K;
  float a = 0.f, b = 0.f;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    a += part_t1[base + k];
    b += part_t2[base + k];
  }
  __shared__ float s_a[kThreads], s_b[kThreads];
  s_a[threadIdx.x] = a;
  s_b[threadIdx.x] = b;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) {
      s_a[threadIdx.x] = a = a + s_a[threadIdx.x + half];
      s_b[threadIdx.x] = b = b + s_b[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    tsum[((long long)n * C + c) * 2] = a;
    tsum[((long long)n * C + c) * 2 + 1] = b;
  }
}

template <typename T, typename R>
__global__ void __launch_bounds__(kThreads)
bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
              const float* __restrict__ stats, const float* __restrict__ scale,
              const float* __restrict__ bias, const float* __restrict__ tsum,
              T* __restrict__ dx, Geom gm, int relu) {
  using V = Vec<T, R>;
  constexpr int CV = kCV<T, R>;
  const int k = blockIdx.x, n = blockIdx.y;
  const int rpb = kThreads / gm.tv;
  const int lane = threadIdx.x % gm.tv, g = threadIdx.x / gm.tv;
  const int vi = blockIdx.z * gm.tv + lane;
  const long long r0 = (long long)k * rpb * gm.m;
  const int rows = (int)min((long long)rpb * gm.m, gm.S - r0);
  if (vi >= gm.vpr || g >= rows) return;
  const int mine = min(gm.m, (rows - g + rpb - 1) / rpb);
  V first;
  first.raw = reinterpret_cast<const R*>(x + (long long)n * gm.S * gm.C)[vi];
  const float m = (float)gm.S;
  BwdChan ch[CV];
  float a[CV], b[CV];
#pragma unroll
  for (int j = 0; j < CV; ++j) {
    const long long nc = (long long)n * gm.C + vi * CV + j;
    ch[j] = bwd_chan(Elem<T>::load(first.e[j]), stats, scale, bias, nc, vi * CV + j, relu);
    const float s1 = tsum[nc * 2], s2 = ch[j].inv * tsum[nc * 2 + 1];
    b[j] = -(ch[j].coef * ch[j].inv) * (s2 / m);
    a[j] = -(ch[j].coef * (s1 / m));
  }
  const long long off = ((long long)n * gm.S + r0 + g) * gm.C;
  const R* px = reinterpret_cast<const R*>(x + off) + vi;
  const R* pd = reinterpret_cast<const R*>(dy + off) + vi;
  R* q = reinterpret_cast<R*>(dx + off) + vi;
  const long long step = (long long)rpb * gm.vpr;
  for (int i = 0; i < mine; i += kUnroll) {
    V vx[kUnroll], vd[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u < mine) {
        vx[u].raw = px[(i + u) * step];
        vd[u].raw = pd[(i + u) * step];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u < mine) {
        V o;
#pragma unroll
        for (int j = 0; j < CV; ++j) {
          const float xf = Elem<T>::load(vx[u].e[j]);
          const float e = xf > ch[j].lo && xf < ch[j].hi ? Elem<T>::load(vd[u].e[j]) : 0.f;
          o.e[j] = Elem<T>::store(
              fmaf(ch[j].coef, e, fmaf((xf - ch[j].x0) - ch[j].mean, b[j], a[j])));
        }
        __stcs(q + (i + u) * step, o.raw);
      }
    }
  }
}

template <typename T, typename R>
int launch_bwd(const void* x, const void* dy, const float* stats, const float* scale,
               const float* bias, void* dx, float* part, float* tsum, int N, long long S,
               int C, int CT, long long chunk, int K, int relu, cudaStream_t stream) {
  constexpr int CV = kCV<T, R>;
  Geom gm;
  gm.S = S;
  gm.C = C;
  gm.vpr = C / CV;
  gm.tv = CT / CV;
  gm.K = K;
  const int rpb = gm.tv > 0 ? kThreads / gm.tv : 0;
  if (C % CV || CT % CV || gm.tv < 1 || gm.tv > 32 || (gm.tv & (gm.tv - 1)) ||
      chunk % rpb || (long long)K * chunk < S || N > 65535 ||
      (gm.vpr + gm.tv - 1) / gm.tv > 65535)
    return (int)cudaErrorInvalidValue;
  gm.m = (int)(chunk / rpb);
  float* part_t1 = part;
  float* part_t2 = part + (long long)N * C * K;
  const dim3 grid(K, N, (gm.vpr + gm.tv - 1) / gm.tv);
  bwd_reduce_kernel<T, R><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), stats, scale, bias, part_t1,
      part_t2, gm, relu);
  bwd_finalize_kernel<<<dim3(C, N), kThreads, 0, stream>>>(part_t1, part_t2, tsum, C, K);
  bwd_dx_kernel<T, R><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), stats, scale, bias, tsum,
      static_cast<T*>(dx), gm, relu);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_vec(int vec_bytes, const void* x, const void* dy, const float* stats,
                   const float* scale, const float* bias, void* dx, float* part, float* tsum,
                   int N, long long S, int C, int CT, long long chunk, int K, int relu,
                   cudaStream_t s) {
  switch (vec_bytes) {
    case 16: return launch_bwd<T, uint4>(x, dy, stats, scale, bias, dx, part, tsum, N, S, C, CT, chunk, K, relu, s);
    case 8: return launch_bwd<T, uint2>(x, dy, stats, scale, bias, dx, part, tsum, N, S, C, CT, chunk, K, relu, s);
    case 4: return launch_bwd<T, unsigned>(x, dy, stats, scale, bias, dx, part, tsum, N, S, C, CT, chunk, K, relu, s);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch_bwd<T, unsigned short>(x, dy, stats, scale, bias, dx, part, tsum, N, S, C, CT, chunk, K, relu, s);
      else
        return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x and y are contiguous (N, S, C); scale
// and bias are float32 (C,) or both null (no affine). The caller chooses the
// launch plan (ops/instance_norm.py::launch_plan): vec_bytes (16, 8, 4 or 2;
// it divides C * elem_bytes and both addresses), the channel tile CT (CT *
// elem_bytes / vec_bytes threads per row, a power of two <= 32), the rows
// per chunk (a multiple of 256 / that count) and K = ceil(S / chunk), and
// provides the float32 scratch `part` (2 * N * C * K) and `stats` (N * C *
// 2). Returns cudaGetLastError() after the three launches, or
// cudaErrorInvalidValue for a dtype or plan the kernels do not take.
extern "C" int hdf_instance_norm_relu(const void* x, const float* scale,
                                      const float* bias, void* y, float* part,
                                      float* stats, int dtype, int vec_bytes, int N,
                                      long long S, int C, int CT, int chunk, int K,
                                      float eps, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_vec<float>(vec_bytes, x, scale, bias, y, part, stats, N, S, C, CT,
                             chunk, K, eps, relu, s);
  if (dtype == 1)
    return launch_vec<__nv_bfloat16>(vec_bytes, x, scale, bias, y, part, stats, N, S, C,
                                     CT, chunk, K, eps, relu, s);
  return (int)cudaErrorInvalidValue;
}

// The backward of hdf_instance_norm_relu. x, dy and dx are contiguous (N, S,
// C) of one dtype; stats is what the forward wrote for this x (per (n, c):
// the mean relative to row 0, then rsqrt(var + eps)); scale and bias as in
// the forward. The plan is the forward's (launch_plan), with vec_bytes
// dividing all three addresses. part is float32 scratch of 2 * N * C * K;
// tsum (N * C * 2) receives (t1, t2) per (n, c), from which the caller sums
// dscale and dbias. Returns as hdf_instance_norm_relu does.
extern "C" int hdf_instance_norm_relu_bwd(const void* x, const void* dy, const float* stats,
                                          const float* scale, const float* bias, void* dx,
                                          float* part, float* tsum, int dtype, int vec_bytes,
                                          int N, long long S, int C, int CT, int chunk, int K,
                                          int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd_vec<float>(vec_bytes, x, dy, stats, scale, bias, dx, part, tsum, N, S,
                                 C, CT, chunk, K, relu, s);
  if (dtype == 1)
    return launch_bwd_vec<__nv_bfloat16>(vec_bytes, x, dy, stats, scale, bias, dx, part, tsum,
                                         N, S, C, CT, chunk, K, relu, s);
  return (int)cudaErrorInvalidValue;
}
