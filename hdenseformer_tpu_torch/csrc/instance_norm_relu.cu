// InstanceNorm (+ affine) + ReLU over channels-last volumes, hand-written for
// Hopper (sm_90a). Forward only.
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
