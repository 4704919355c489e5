// Dense softmax attention for tiny heads, hand-written for Hopper (sm_90a).
//
// Replaces: hdenseformer_tpu/ops/dense_attention.py::fused_dense_attention
// (Pallas body `_attn_kernel`), which keeps one (batch, head) slice of Q, K,
// V, the score matrix and the output in VMEM, with N padded to 768 and D to
// 128 for the TPU's (8, 128) tiling.
//
// Computes: o = softmax(q . k^T * D^-1/2) . v for every (b, h), scores and
// softmax in fp32, output in the input's dtype. Shapes (B, H, N, D); on the
// serving path B = 8 windows, H = 8, N = 729 tokens, D = 4, bf16.
//
// What bounds it on this card: D = 4 is far below any tensor-core tile, so
// the work is per-score scalar math: D FMAs for q.k, one exp, D FMAs for
// p.v. A forward runs 48 launches x 64 (b, h) x 729^2 scores = 1.6e9 scores,
// about 0.4 ms of exp throughput (16 ex2 per clock per SM) and about 0.5 ms
// of fp32 FMA throughput at 67 TFLOP/s (data-sheet estimates; PERF.md holds
// the card's measured time). Bytes are negligible: 1.5 MB per launch.
//
// Design: one block per (b, h) and tile of 128 query rows; the block stages
// the whole K and V of its (b, h) in shared memory as fp32 (2 x N x D x 4 B,
// 23 KB at N = 729), and each thread owns one query row. Every thread of a
// warp reads the same K/V row at the same time, so shared-memory reads are
// broadcasts with no bank conflicts. No padding of N or D: the loops run
// over the N real keys, and query rows past N are simply not computed, which
// is the ragged-tail mask. The softmax is exact in two sweeps over K (the row
// max, then exp2 of the shifted scores with the p.v sums), which costs one
// exp per score instead of the two an online rescale needs. q is pre-scaled
// by D^-1/2 * log2(e) so that exp becomes exp2. Inputs may be strided views
// (the q/k/v split of one qkv projection) as long as D is innermost.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dense_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H, int N,
                       long long sb, long long sh, long long sn,
                       float q_scale) {
  extern __shared__ float smem[];
  float* ks = smem;                   // (N, D)
  float* vs = smem + (size_t)N * D;   // (N, D)
  const int bh = blockIdx.x;
  const long long base = (long long)(bh / H) * sb + (long long)(bh % H) * sh;
  for (int i = threadIdx.x; i < N * D; i += kThreads) {
    const long long off = base + (long long)(i / D) * sn + (i % D);
    ks[i] = to_f32(k[off]);
    vs[i] = to_f32(v[off]);
  }
  __syncthreads();

  const int row = blockIdx.y * kThreads + threadIdx.x;
  if (row >= N) return;
  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = to_f32(q[base + (long long)row * sn + d]) * q_scale;

  float m = -INFINITY;
  for (int j = 0; j < N; ++j) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(qr[d], ks[j * D + d], s);
    m = fmaxf(m, s);
  }
  float l = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int j = 0; j < N; ++j) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(qr[d], ks[j * D + d], s);
    const float p = exp2f(s - m);
    l += p;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j * D + d], acc[d]);
  }
  const float inv = 1.f / l;
  T* out = o + ((long long)bh * N + row) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) out[d] = from_f32<T>(acc[d] * inv);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int N, long long sb, long long sh, long long sn, float q_scale,
           cudaStream_t stream) {
  const size_t smem = 2 * (size_t)N * D * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(dense_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * H, (N + kThreads - 1) / kThreads);
  dense_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, N, sb, sh, sn, q_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k and v share shape (B, H, N, D) and
// the strides (sb, sh, sn) in elements, with D innermost and contiguous; o is
// a contiguous (B, H, N, D) tensor. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a dtype or D it was not built for.
extern "C" int hdf_dense_attention(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int H, int N, int D,
                                   long long sb, long long sh, long long sn,
                                   float scale, void* stream) {
  const float q_scale = scale * 1.4426950408889634f;  // log2(e)
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 4) return launch<float, 4>(q, k, v, o, B, H, N, sb, sh, sn, q_scale, s);
  if (dtype == 0 && D == 8) return launch<float, 8>(q, k, v, o, B, H, N, sb, sh, sn, q_scale, s);
  if (dtype == 1 && D == 4) return launch<__nv_bfloat16, 4>(q, k, v, o, B, H, N, sb, sh, sn, q_scale, s);
  if (dtype == 1 && D == 8) return launch<__nv_bfloat16, 8>(q, k, v, o, B, H, N, sb, sh, sn, q_scale, s);
  return (int)cudaErrorInvalidValue;
}
