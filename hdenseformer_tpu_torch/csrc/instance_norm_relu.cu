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
// The arithmetic, about 11 fp32 operations per element, is a tenth of that.
//
// Design. A TPU grid runs in order and can carry sums from one step to the
// next; Hopper's blocks run in no order, so the reduction over the 2,985,984
// voxels of one (n, c) is split across blocks and merged in a second kernel:
//   1. partial stats: block (chunk k, sample n, channel tile) reads rows
//      [k*chunk, (k+1)*chunk) of x. Thread (g, c) takes every G-th row of the
//      chunk for channel c, so a warp reads consecutive channels of one row
//      (C is innermost: coalesced). Each thread keeps a Welford (count, mean,
//      M2); the G threads of a channel are merged in fixed order (Chan et
//      al.) and the block writes one (mean, M2) per channel;
//   2. finalize: one block per (c, n) merges the chunks' (mean, M2) with a
//      fixed-shape tree, and writes mean and rsqrt(var + eps);
//   3. normalize: the grid of kernel 1 again; each thread holds its
//      channel's mean, rstd, scale and bias in registers and streams rows.
// The variance is centered (Welford/Chan), not the one-pass E[x^2] - mean^2
// of the Pallas kernel, which ops/fused_norm.py rejected for its error. There
// are no atomics and every merge has a fixed order, so reruns agree bit for
// bit. x is read twice (kernels 1 and 3) and y written once: 1.5x the bytes
// of the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

// Rows of one chunk that thread group g visits: g, g + G, ... < rows.
__device__ __forceinline__ int rows_of_group(int rows, int g, int G) {
  return rows > g ? (rows - g + G - 1) / G : 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
partial_stats_kernel(const T* __restrict__ x, float* __restrict__ part_mean,
                     float* __restrict__ part_m2, long long S, int C, int CT,
                     int chunk, int K) {
  const int k = blockIdx.x, n = blockIdx.y;
  const int G = kThreads / CT;
  const int lc = threadIdx.x % CT, g = threadIdx.x / CT;
  const int c = blockIdx.z * CT + lc;
  const bool active = g < G && c < C;
  const long long r0 = (long long)k * chunk;
  const int rows = (int)min((long long)chunk, S - r0);

  float mean = 0.f, m2 = 0.f;
  if (active) {
    const T* xp = x + ((long long)n * S + r0) * C + c;
    int cnt = 0;
#pragma unroll 8
    for (int r = g; r < rows; r += G) {
      const float val = to_f32(xp[(long long)r * C]);
      ++cnt;
      const float delta = val - mean;
      mean += delta / (float)cnt;
      m2 = fmaf(delta, val - mean, m2);
    }
  }
  __shared__ float s_mean[kThreads], s_m2[kThreads];
  s_mean[threadIdx.x] = mean;
  s_m2[threadIdx.x] = m2;
  __syncthreads();
  if (g == 0 && c < C) {
    float cn = (float)rows_of_group(rows, 0, G);
    for (int gg = 1; gg < G; ++gg)
      merge(cn, mean, m2, (float)rows_of_group(rows, gg, G), s_mean[gg * CT + lc],
            s_m2[gg * CT + lc]);
    const long long off = ((long long)n * C + c) * K + k;
    part_mean[off] = mean;
    part_m2[off] = m2;
  }
}

__global__ void __launch_bounds__(kThreads)
finalize_kernel(const float* __restrict__ part_mean, const float* __restrict__ part_m2,
                float* __restrict__ stats, long long S, int C, int chunk, int K,
                float eps) {
  const int c = blockIdx.x, n = blockIdx.y;
  const long long base = ((long long)n * C + c) * K;
  float cn = 0.f, mean = 0.f, m2 = 0.f;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float nb = (float)min((long long)chunk, S - (long long)k * chunk);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
normalize_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 T* __restrict__ y, long long S, int C, int CT, int chunk, int relu) {
  const int k = blockIdx.x, n = blockIdx.y;
  const int G = kThreads / CT;
  const int lc = threadIdx.x % CT, g = threadIdx.x / CT;
  const int c = blockIdx.z * CT + lc;
  if (g >= G || c >= C) return;
  const long long r0 = (long long)k * chunk;
  const int rows = (int)min((long long)chunk, S - r0);
  const float mean = stats[((long long)n * C + c) * 2];
  const float rstd = stats[((long long)n * C + c) * 2 + 1];
  const float a = scale ? scale[c] : 1.f;
  const float b = bias ? bias[c] : 0.f;
  const long long off = ((long long)n * S + r0) * C + c;
  const T* xp = x + off;
  T* yp = y + off;
#pragma unroll 8
  for (int r = g; r < rows; r += G) {
    float v = (to_f32(xp[(long long)r * C]) - mean) * rstd;
    v = fmaf(v, a, b);
    if (relu) v = fmaxf(v, 0.f);
    yp[(long long)r * C] = from_f32<T>(v);
  }
}

template <typename T>
int launch(const void* x, const float* scale, const float* bias, void* y,
           float* part, float* stats, int N, long long S, int C, int CT, int chunk,
           int K, float eps, int relu, cudaStream_t stream) {
  float* part_mean = part;
  float* part_m2 = part + (long long)N * C * K;
  const dim3 grid(K, N, (C + CT - 1) / CT);
  partial_stats_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), part_mean, part_m2, S, C, CT, chunk, K);
  finalize_kernel<<<dim3(C, N), kThreads, 0, stream>>>(part_mean, part_m2, stats, S,
                                                       C, chunk, K, eps);
  normalize_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), stats, scale, bias, static_cast<T*>(y), S, C, CT,
      chunk, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x and y are contiguous (N, S, C); scale
// and bias are float32 (C,) or both null (no affine). The caller chooses the
// channel tile CT (<= 256, so G = 256 / CT row groups), the rows per chunk
// and K = ceil(S / chunk), and provides the float32 scratch `part`
// (2 * N * C * K) and `stats` (N * C * 2). Returns cudaGetLastError() after
// the three launches, or cudaErrorInvalidValue for an unsupported dtype.
extern "C" int hdf_instance_norm_relu(const void* x, const float* scale,
                                      const float* bias, void* y, float* part,
                                      float* stats, int dtype, int N, long long S,
                                      int C, int CT, int chunk, int K, float eps,
                                      int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, scale, bias, y, part, stats, N, S, C, CT, chunk, K, eps,
                         relu, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, bias, y, part, stats, N, S, C, CT, chunk,
                                 K, eps, relu, s);
  return (int)cudaErrorInvalidValue;
}
