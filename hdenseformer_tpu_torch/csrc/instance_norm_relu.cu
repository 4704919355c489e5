// InstanceNorm (+ affine) + ReLU over channels-last volumes, hand-written for
// Hopper (sm_90a). Forward, and below it the backward (one cooperative launch).
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
//
// Shifted mode (kShifted, the same kernels instantiated again). Replaces:
// hdenseformer_tpu/ops/fused_norm.py::instance_norm_relu with shifted=dims
// (plain XLA in JAX, not Pallas): the norm after a packed conv that writes the
// half-shifted layout (ops/s2d.py::conv3_packed_p2s). x is that tensor, (N,
// *s, f * C) with f = 2^npk, taken as the view (N, S = prod(s) * f, C): row r
// is cell r >> npk, parity block r & (f - 1). Some rows are pad slots that hold
// conv garbage: per packed dim j (the leading one the high bit of the block),
// the cell's coordinate is 0 where the block's bit is 1, or s_j - 1 where it
// is 0. Pad rows are left out of the sums by selection (never multiplied by
// 0: their values may be anything), each chunk's count of valid rows goes to
// finalize in place of the chunk's length, and normalize writes 0 there: the
// next conv reads them as the fine conv's zero padding. Row 0 (cell 0, block
// 0), the shift x0, is valid whenever every s_j >= 2.
// What bounds it is what bounds the unshifted mode: HBM bytes, x read twice.
// The pad status is decoded, not read from a mask, and the decode is kept off
// the critical path: a thread's rows step by RPB, a multiple of f, from a
// multiple of RPB, so its parity block never changes and its cells advance by
// a constant step. PadWalk decodes the thread's first cell once (one modulo
// per packed dim) and then steps each packed coordinate's residue by a
// constant with one conditional subtraction: no division per row. The
// statistics and normalize passes decode a thread's m <= 32 rows of the chunk
// into a bit mask before their loads, so their inner loops are the unshifted
// ones but for a predicate, and pad rows are never read: their loads are
// predicated off, normalize stores 0 there without loading x.
#include <cstdint>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
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

// The pad slots of a packed-shifted (N, S, C) view and a thread's walk over
// them: npk packed dims (0 in the unshifted mode), and for each, leading
// first, the cells between neighbours along it (stride), the period of its
// coordinate in the cell index (extent * stride) and the cell step of the
// walk modulo that period (ops/instance_norm.py::Shift.walk).
struct Shift {
  int npk;
  unsigned stride[3];
  unsigned period[3];
  unsigned step[3];
};

// The pad status of one thread's rows r, r + step f, r + 2 step f, ... (or
// backwards): all of the same parity block p = r & (f - 1), so row r is a
// pad slot iff for some packed dim j the residue x_j = cell mod period_j lies
// in [lo_j, lo_j + stride_j), with lo_j = 0 (coordinate 0) where p's bit for
// j is 1, else period_j - stride_j (coordinate s_j - 1). One modulo per dim
// decodes the first row; each step adds the step's residue and subtracts the
// period at most once (x_j < 2^31: cells < 2^31).
struct PadWalk {
  unsigned x[3], lo[3];
  PadWalk() = default;
  __device__ __forceinline__ PadWalk(const Shift& sh, long long r) {
    const unsigned cell = (unsigned)(r >> sh.npk);
    const unsigned p = (unsigned)r & ((1u << sh.npk) - 1u);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      x[j] = lo[j] = 0u;
      if (j < sh.npk) {
        x[j] = cell % sh.period[j];
        lo[j] = (p >> (sh.npk - 1 - j)) & 1u ? 0u : sh.period[j] - sh.stride[j];
      }
    }
  }
  __device__ __forceinline__ bool pad(const Shift& sh) const {
    bool any = false;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (j < sh.npk) any |= x[j] - lo[j] < sh.stride[j];  // unsigned: below lo wraps high
    return any;
  }
  __device__ __forceinline__ void next(const Shift& sh) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j < sh.npk) {
        x[j] += sh.step[j];
        if (x[j] >= sh.period[j]) x[j] -= sh.period[j];
      }
    }
  }
  __device__ __forceinline__ void prev(const Shift& sh) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (j < sh.npk)
        x[j] = x[j] >= sh.step[j] ? x[j] - sh.step[j] : x[j] + (sh.period[j] - sh.step[j]);
  }
};

// Bit i set where the thread's row r + i * rpb is a pad slot, for `rows` <=
// 32 rows (the walk's step: rpb / f cells).
__device__ __forceinline__ unsigned pad_mask(const Shift& sh, long long r, int rows) {
  PadWalk w(sh, r);
  unsigned mask = 0u;
  for (int i = 0; i < rows; ++i) {
    mask |= (unsigned)w.pad(sh) << i;
    w.next(sh);
  }
  return mask;
}

// Whether the walk's step residues are those of a step of `cells` cells.
bool walks_by(const Shift& sh, long long cells) {
  for (int j = 0; j < sh.npk; ++j)
    if ((long long)sh.step[j] != cells % sh.period[j]) return false;
  return true;
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

template <typename T, typename R, bool kShifted>
__global__ void __launch_bounds__(kThreads)
partial_stats_kernel(const T* __restrict__ x, float* __restrict__ part_mean,
                     float* __restrict__ part_m2, float* __restrict__ part_cnt, Geom gm,
                     Shift sh) {
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
  int valid = mine;  // rows summed
  unsigned pads = 0u;  // bit i: my row i of the chunk is a pad slot (never read)
  if constexpr (kShifted) {
    if (mine > 0) pads = pad_mask(sh, r0 + g, mine);
    valid = mine - __popc(pads);
  }
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
        if (i + u < mine && !((pads >> (i + u)) & 1u)) v[u].raw = p[(i + u) * step];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i + u < mine && !((pads >> (i + u)) & 1u)) {
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
  float cnt = (float)valid, mean[CV], m2[CV];
  const float inv = valid > 0 ? 1.f / cnt : 0.f;
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
    // the chunk's valid rows, the same for every sample and channel
    if (kShifted && n == 0 && vi == 0) part_cnt[k] = cnt;
  }
}

__global__ void __launch_bounds__(kThreads)
finalize_kernel(const float* __restrict__ part_mean, const float* __restrict__ part_m2,
                const float* __restrict__ part_cnt, float* __restrict__ stats, long long S,
                int C, long long chunk, int K, float eps) {
  const int c = blockIdx.x, n = blockIdx.y;
  const long long base = ((long long)n * C + c) * K;
  float cn = 0.f, mean = 0.f, m2 = 0.f;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    // rows of chunk k: all of them, or its valid ones in the shifted mode
    const float nb = part_cnt ? part_cnt[k] : (float)min(chunk, S - (long long)k * chunk);
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

template <typename T, typename R, bool kShifted>
__global__ void __launch_bounds__(kThreads)
normalize_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 T* __restrict__ y, Geom gm, int relu, Shift sh) {
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
  unsigned pads = 0u;  // bit i: my row i of the chunk is a pad slot (y = 0, x not read)
  if constexpr (kShifted) pads = pad_mask(sh, r0 + g, mine);
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
      if (i + u < mine) v[u].raw = (pads >> (i + u)) & 1u ? R{} : p[(i + u) * step];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u < mine) {
        V o;
        const bool pad = (pads >> (i + u)) & 1u;
#pragma unroll
        for (int j = 0; j < CV; ++j) {
          float t = fmaf((Elem<T>::load(v[u].e[j]) - x0[j]) - mean[j], a[j], b[j]);
          if (relu) t = fmaxf(t, 0.f);
          o.e[j] = Elem<T>::store(pad ? 0.f : t);
        }
        __stcs(q + (i + u) * step, o.raw);
      }
    }
  }
}

template <typename T, typename R, bool kShifted>
int launch(const void* x, const float* scale, const float* bias, void* y, float* part,
           float* stats, int N, long long S, int C, int CT, long long chunk, int K,
           float eps, int relu, Shift sh, cudaStream_t stream) {
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
  // the shifted mode: a thread's rows step by rpb / f cells, at most 32 of them (its pad mask)
  if (kShifted && (gm.m > 32 || !walks_by(sh, rpb >> sh.npk))) return (int)cudaErrorInvalidValue;
  float* part_mean = part;
  float* part_m2 = part + (long long)N * C * K;
  float* part_cnt = kShifted ? part + 2LL * N * C * K : nullptr;
  const dim3 grid(K, N, (gm.vpr + gm.tv - 1) / gm.tv);
  partial_stats_kernel<T, R, kShifted><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), part_mean, part_m2, part_cnt, gm, sh);
  finalize_kernel<<<dim3(C, N), kThreads, 0, stream>>>(part_mean, part_m2, part_cnt, stats,
                                                       S, C, chunk, K, eps);
  normalize_kernel<T, R, kShifted><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), stats, scale, bias, static_cast<T*>(y), gm, relu, sh);
  return (int)cudaGetLastError();
}

template <typename T, bool kShifted>
int launch_vec(int vec_bytes, const void* x, const float* scale, const float* bias,
               void* y, float* part, float* stats, int N, long long S, int C, int CT,
               long long chunk, int K, float eps, int relu, Shift sh, cudaStream_t s) {
  switch (vec_bytes) {
    case 16: return launch<T, uint4, kShifted>(x, scale, bias, y, part, stats, N, S, C, CT, chunk, K, eps, relu, sh, s);
    case 8: return launch<T, uint2, kShifted>(x, scale, bias, y, part, stats, N, S, C, CT, chunk, K, eps, relu, sh, s);
    case 4: return launch<T, unsigned, kShifted>(x, scale, bias, y, part, stats, N, S, C, CT, chunk, K, eps, relu, sh, s);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch<T, unsigned short, kShifted>(x, scale, bias, y, part, stats, N, S, C, CT, chunk, K, eps, relu, sh, s);
      else
        return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

// A Shift from the C interface's arguments; false if they do not describe
// npk in 1..3 packed dims of extent >= 2 (period >= 2 * stride: row 0, the
// shift, must be valid) whose cells number S / 2^npk, fewer than 2^31, with
// each step residue below its period.
bool make_shift(Shift& sh, long long S, int npk, const int* stride, const int* period,
                const int* step) {
  sh.npk = npk;
  if (npk < 1 || npk > 3 || S % (1LL << npk) || (S >> npk) >= (1LL << 31)) return false;
  for (int j = 0; j < 3; ++j) {
    sh.stride[j] = sh.period[j] = 1u;
    sh.step[j] = 0u;
    if (j >= npk) continue;
    if (stride[j] < 1 || period[j] < 2LL * stride[j] || period[j] % stride[j] ||
        period[j] > (S >> npk) || step[j] < 0 || step[j] >= period[j])
      return false;
    sh.stride[j] = (unsigned)stride[j];
    sh.period[j] = (unsigned)period[j];
    sh.step[j] = (unsigned)step[j];
  }
  return true;
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
// gets dscale = sum_n inv * t2 and dbias = sum_n t1 (summed by the kernel).
//
// What bounds it: HBM bytes. At (1, 144^3, 32) bf16 the least is x and dy
// read once and dx written once, 6 bytes an element (0.17 ms at 3.35 TB/s).
// dx needs (t1, t2) of the whole (n, c), so a design that reduces first and
// then computes dx reads x and dy twice (10 bytes an element) from HBM,
// less what L2 (50 MB) still holds of them when dx starts.
//
// Design: one cooperative launch of a persistent grid, every block resident
// at once (the grid is sized from the kernel's occupancy, and
// cudaLaunchCooperativeKernel refuses a grid that cannot co-reside, so the
// grid barriers cannot hang):
//   * the work is (n, channel tile, part) items: a channel tile is 64 or 128
//     bytes of a row (tv threads of one vector each, tv a power of two, at
//     most 32 threads and 64 channels), part j of P takes the units j, j + P,
//     j + 2P, ... of rpb = 256 / tv rows (so that the grid walks one narrow
//     window of memory at a time, as a sequential pass does), and block b
//     owns items [b * items / grid, (b + 1) * items / grid): one item each
//     unless N * tiles exceeds the grid;
//   * every load of x and dy is a cp.async into a ring of kRing unit slots
//     in shared memory (32 KB in flight a block), which each thread uses for
//     its own vectors only (no block barrier around it). cp.async holds no
//     register for data in flight, and its 16-byte copies bypass L1;
//   a. reduce: each thread sums (t1, t2) of its vector over row g of every
//      unit, the mask rebuilt as above; the rows of each warp are merged by
//      shuffles, the warps in a fixed order, and the block writes one
//      partial (t1, t2) per (n, c, part);
//   b. grid barrier; then one warp per channel sums the P partials of each
//      sample (lane-strided, then a fixed butterfly), writes tsum, and with
//      affine sums dscale = sum_n inv * t2 and dbias = sum_n t1 over the
//      samples in order; grid barrier. Every sum is taken once, in one
//      order: no atomics, reruns agree bit for bit, and no block reads more
//      than its tile's tsum;
//   c. dx: the units again, in the reverse of (a)'s order, so that those (a)
//      read last, still in L2, come first; dx stored evict-first.
// Keeping a block's first units in shared memory from (a) to (c) was
// measured and dropped (PERF.md): it was no faster at any train-step shape,
// since L2 already serves most of the second read up to ~100 MB and shared
// memory holds 5 % of x and dy at (1, 144^3, 32). One launch saves the three
// passes' and the dscale and dbias sums' launches.
//
// Shifted mode (kShifted; replaces fused_norm.py::_bwd_rule with shifted=dims):
// the forward's shifted mode above. Pad rows are skipped by (a), so dy there
// is ignored and dscale and dbias leave them out; (c) writes dx = 0 there; m
// is the count of valid rows, which the caller passes. What bounds it is the
// unshifted backward's bound: HBM bytes. A thread's rows of an item step by P
// * rpb, a multiple of f, so the forward's PadWalk serves here too: decoded
// once an item, stepped as the ring issues each unit (forwards in (a),
// backwards in (c)), each unit's status kept as a bit of its ring slot until
// it is used. A pad row's copies into the ring are never issued, and (c)
// stores its 0 without reading the slot.

constexpr int kBwdMinBlocks = 2;  // blocks a multiprocessor holds: <= 128 registers a thread
constexpr int kMaxTile = 64;      // channels of a tile, at most (128 bytes of bf16)
constexpr int kRingBytes = 32768;  // x and dy of the units in flight through the ring

// Ring slots for vector type R: 32 KB of x and dy units of 256 vectors.
template <typename R>
constexpr int kRing = kRingBytes / (kThreads * (int)sizeof(R) * 2);

// Copy one vector from global to shared memory: cp.async where the width
// allows it (16 bytes bypass L1), a plain load and store for 2 bytes. The
// "memory" clobbers keep the compiler from moving shared-memory reads of a
// slot across the copies and waits that refill it.
template <typename R>
__device__ __forceinline__ void copy_async(R* dst, const R* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(R) == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else if constexpr (sizeof(R) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  else if constexpr (sizeof(R) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  else
    *dst = *src;
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// Launch geometry of the backward (ops/instance_norm.py::bwd_launch_plan).
struct BwdGeom {
  long long S;      // rows per sample
  long long U;      // units of rpb rows per (n, tile): ceil(S / rpb)
  long long items;  // N * tiles * P
  int N;            // samples
  int C;            // channels
  int vpr;          // vectors per row: C / CV
  int tv;           // threads per row in a channel tile (power of two)
  int tiles;        // channel tiles: ceil(vpr / tv)
  int P;            // parts per (n, tile)
  float m;          // rows in the statistics: S, or the valid ones in the shifted mode
};

// Item `it` of the plan: sample, channel tile, part, and the count of its
// units j, j + P, ..., below U.
struct BwdItem {
  int n, z, j;
  long long count;
};

__device__ __forceinline__ BwdItem bwd_item(const BwdGeom& gm, long long it) {
  BwdItem w;
  const long long seg = it / gm.P;
  w.j = (int)(it % gm.P);
  w.n = (int)(seg / gm.tiles);
  w.z = (int)(seg % gm.tiles);
  w.count = (gm.U - w.j + gm.P - 1) / gm.P;
  return w;
}

// Walk `count` units, unit(i) for i = 0, 1, ..., through the D ring slots:
// `issue(i, slot)` starts unit i's copies, `use(i, slot)` consumes it once
// landed. One commit group a step, empty ones too, so that unit i's group is
// always the D-th newest when it is waited for.
template <int D, typename Issue, typename Use>
__device__ __forceinline__ void ring_walk(long long count, Issue issue, Use use) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (i < count) issue((long long)i, i);
    async_commit();
  }
  for (long long i = 0; i < count; ++i) {
    async_wait<D - 1>();
    const int slot = (int)(i % D);
    use(i, slot);  // consumes the slot's values before it is refilled
    if (i + D < count) issue(i + D, slot);
    async_commit();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T, typename R, bool kShifted>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
bwd_persistent_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ stats, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ dx, float2* part,
                      float2* tsum, float* __restrict__ dsb, BwdGeom gm, int relu, Shift sh) {
  using V = Vec<T, R>;
  constexpr int CV = kCV<T, R>;
  constexpr int kWarps = kThreads / 32;
  constexpr int D = kRing<R>;
  static_assert(D <= 32, "a ring slot's pad status is one bit of 32");
  // slot k holds a unit of x (ring[2k]) and of dy (ring[2k + 1]); each thread its own vectors
  __shared__ R ring[2 * D][kThreads];
  __shared__ float s_red[2][kWarps][kMaxTile];  // (t1, t2) per warp and tile channel

  const int tid = threadIdx.x;
  const int lane = tid % gm.tv, g = tid / gm.tv, rpb = kThreads / gm.tv;
  const int tch = gm.tv * CV;  // channels of a tile, a power of two <= kMaxTile
  const long long first = (long long)blockIdx.x * gm.items / gridDim.x;
  const long long last = (long long)(blockIdx.x + 1) * gm.items / gridDim.x;
  const R* xv = reinterpret_cast<const R*>(x);
  const R* dv = reinterpret_cast<const R*>(dy);

  // item `it`'s thread geometry: its vector within a row, the offset of row
  // 0 (row r: base + r * vpr), and the row this thread reads of unit k, or -1
  struct Walk {
    BwdItem w;
    int vi;
    bool on;
    long long base;
  };
  auto walk = [&](long long it) {
    Walk k;
    k.w = bwd_item(gm, it);
    k.vi = k.w.z * gm.tv + lane;
    k.on = k.vi < gm.vpr;
    k.base = (long long)k.w.n * gm.S * gm.vpr + k.vi;
    return k;
  };
  auto row = [&](const Walk& k, long long u) -> long long {
    const long long r = (k.w.j + u * gm.P) * rpb + g;
    return k.on && r < gm.S ? r : -1;
  };
  auto issue = [&](const Walk& k, long long u, int slot, bool pad) {
    const long long r = row(k, u);
    if (r >= 0 && !pad) {
      copy_async(&ring[2 * slot][tid], xv + k.base + r * gm.vpr);
      copy_async(&ring[2 * slot + 1][tid], dv + k.base + r * gm.vpr);
    }
  };

  // a. reduce
  for (long long it = first; it < last; ++it) {
    const Walk k = walk(it);
    float t1[CV], t2[CV];
    BwdChan ch[CV];
#pragma unroll
    for (int j = 0; j < CV; ++j) t1[j] = t2[j] = 0.f;
    if (k.on) {
      V first_row;
      first_row.raw = xv[k.base];
#pragma unroll
      for (int j = 0; j < CV; ++j)
        ch[j] = bwd_chan(Elem<T>::load(first_row.e[j]), stats, scale, bias,
                         (long long)k.w.n * gm.C + k.vi * CV + j, k.vi * CV + j, relu);
    }
    // shifted: each unit's pad status, decoded as the ring issues the units
    // (0, 1, ...: the walk's step is P * rpb / f cells) and kept by ring slot
    // until the unit is used; a pad row is neither copied nor summed
    PadWalk pw;
    unsigned pads = 0u;
    if constexpr (kShifted) pw = PadWalk(sh, (long long)k.w.j * rpb + g);
    ring_walk<D>(
        k.w.count,
        [&](long long u, int slot) {
          bool pad = false;
          if constexpr (kShifted) {
            pad = pw.pad(sh);
            pw.next(sh);
            pads = (pads & ~(1u << slot)) | (unsigned)pad << slot;
          }
          issue(k, u, slot, pad);
        },
        [&](long long u, int slot) {
          const long long r = row(k, u);
          if (r < 0 || ((pads >> slot) & 1u)) return;
          V vx, vd;
          vx.raw = ring[2 * slot][tid];
          vd.raw = ring[2 * slot + 1][tid];
#pragma unroll
          for (int j = 0; j < CV; ++j) {
            const float xf = Elem<T>::load(vx.e[j]);
            const float e = xf > ch[j].lo && xf < ch[j].hi ? Elem<T>::load(vd.e[j]) : 0.f;
            t1[j] += e;
            t2[j] = fmaf(e, (xf - ch[j].x0) - ch[j].mean, t2[j]);
          }
        });

    // the warp's row groups by shuffles (lane i and lane i ^ off add the same
    // pair, so every lane holds the same sums), then the warps in order
    for (int off = gm.tv; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < CV; ++j) {
        t1[j] += __shfl_xor_sync(0xffffffffu, t1[j], off);
        t2[j] += __shfl_xor_sync(0xffffffffu, t2[j], off);
      }
    }
    if (tid % 32 < gm.tv) {
#pragma unroll
      for (int j = 0; j < CV; ++j) {
        s_red[0][tid / 32][lane * CV + j] = t1[j];
        s_red[1][tid / 32][lane * CV + j] = t2[j];
      }
    }
    __syncthreads();
    if (tid < tch) {
      float a = 0.f, b = 0.f;
      for (int wp = 0; wp < kWarps; ++wp) {
        a += s_red[0][wp][tid];
        b += s_red[1][wp][tid];
      }
      const int c = k.w.z * tch + tid;
      if (c < gm.C) part[((long long)k.w.n * gm.C + c) * gm.P + k.w.j] = make_float2(a, b);
    }
    __syncthreads();
  }

  // b. merge: one warp per channel sums the P partials of each sample, and
  // with affine the samples' dscale and dbias; then every block waits
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  grid.sync();
  {
    const int l32 = tid % 32;
    const int warps = gridDim.x * kWarps;
    for (int c = blockIdx.x * kWarps + tid / 32; c < gm.C; c += warps) {
      float ds = 0.f, db = 0.f;
      for (int n = 0; n < gm.N; ++n) {
        const long long nc = (long long)n * gm.C + c;
        const float2* p = part + nc * gm.P;  // written by other blocks: read through L2
        float a = 0.f, b = 0.f;
#pragma unroll 4
        for (int j = l32; j < gm.P; j += 32) {
          const float2 v = __ldcg(p + j);
          a += v.x;
          b += v.y;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          a += __shfl_xor_sync(0xffffffffu, a, off);
          b += __shfl_xor_sync(0xffffffffu, b, off);
        }
        if (l32 == 0) tsum[nc] = make_float2(a, b);
        ds += stats[nc * 2 + 1] * b;  // dscale = sum_n inv * t2, dbias = sum_n t1
        db += a;
      }
      if (dsb && l32 == 0) {
        dsb[c] = ds;
        dsb[gm.C + c] = db;
      }
    }
  }
  grid.sync();

  // c. dx: the units backwards, the ones (a) read last first
  R* out = reinterpret_cast<R*>(dx);
  for (long long it = first; it < last; ++it) {
    const Walk k = walk(it);
    BwdChan ch[CV];
    float a[CV], b[CV];
    if (k.on) {
      V first_row;
      first_row.raw = xv[k.base];
      const float m = kShifted ? gm.m : (float)gm.S;
#pragma unroll
      for (int j = 0; j < CV; ++j) {
        const long long nc = (long long)k.w.n * gm.C + k.vi * CV + j;
        ch[j] = bwd_chan(Elem<T>::load(first_row.e[j]), stats, scale, bias, nc, k.vi * CV + j,
                         relu);
        const float2 t = __ldcg(tsum + nc);
        const float s1 = t.x, s2 = ch[j].inv * t.y;
        b[j] = -(ch[j].coef * ch[j].inv) * (s2 / m);
        a[j] = -(ch[j].coef * (s1 / m));
      }
    }
    const long long top = k.w.count - 1;  // step i walks unit top - i
    // shifted: the walk of (a) backwards, from unit top; a pad row's dx is 0,
    // stored without reading x or dy
    PadWalk pw;
    unsigned pads = 0u;
    if constexpr (kShifted) pw = PadWalk(sh, (k.w.j + top * gm.P) * rpb + g);
    ring_walk<D>(
        k.w.count,
        [&](long long i, int slot) {
          bool pad = false;
          if constexpr (kShifted) {
            pad = pw.pad(sh);
            pw.prev(sh);
            pads = (pads & ~(1u << slot)) | (unsigned)pad << slot;
          }
          issue(k, top - i, slot, pad);
        },
        [&](long long i, int slot) {
          const long long r = row(k, top - i);
          if (r < 0) return;
          V o;
          if ((pads >> slot) & 1u) {
            o.raw = R{};
          } else {
            V vx, vd;
            vx.raw = ring[2 * slot][tid];
            vd.raw = ring[2 * slot + 1][tid];
#pragma unroll
            for (int j = 0; j < CV; ++j) {
              const float xf = Elem<T>::load(vx.e[j]);
              const float e = xf > ch[j].lo && xf < ch[j].hi ? Elem<T>::load(vd.e[j]) : 0.f;
              o.e[j] = Elem<T>::store(
                  fmaf(ch[j].coef, e, fmaf((xf - ch[j].x0) - ch[j].mean, b[j], a[j])));
            }
          }
          __stcs(out + k.base + r * gm.vpr, o.raw);
        });
  }
}

template <typename T, typename R, bool kShifted>
int launch_bwd(const void* x, const void* dy, const float* stats, const float* scale,
               const float* bias, void* dx, float* part, long long part_floats, float* tsum,
               float* dsb, int N, long long S, int C, int CT, int P, int grid, int relu,
               float m, Shift sh, cudaStream_t stream) {
  constexpr int CV = kCV<T, R>;
  BwdGeom gm;
  gm.S = S;
  gm.N = N;
  gm.C = C;
  gm.vpr = C / CV;
  gm.tv = CT / CV;
  gm.P = P;
  gm.m = m;
  if (C % CV || CT % CV || gm.tv < 1 || gm.tv > 32 || (gm.tv & (gm.tv - 1)) ||
      CT > kMaxTile || P < 1 || N < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  gm.tiles = (gm.vpr + gm.tv - 1) / gm.tv;
  gm.U = (S + kThreads / gm.tv - 1) / (kThreads / gm.tv);
  gm.items = (long long)N * gm.tiles * P;
  // the partials are indexed ((n * C + c) * P + j) * 2 floats
  if (grid < 1 || grid > gm.items || P > gm.U || part_floats < 2LL * N * C * P)
    return (int)cudaErrorInvalidValue;
  // the shifted mode: a thread's rows of an item step by P * rpb / f cells
  if (kShifted && !walks_by(sh, (long long)P * (kThreads / gm.tv) >> sh.npk))
    return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  float2* pp = reinterpret_cast<float2*>(part);
  float2* tp = reinterpret_cast<float2*>(tsum);
  void* args[] = {(void*)&xp, (void*)&dyp, (void*)&stats, (void*)&scale, (void*)&bias,
                  (void*)&dxp, (void*)&pp, (void*)&tp, (void*)&dsb, (void*)&gm, (void*)&relu,
                  (void*)&sh};
  const int err = (int)cudaLaunchCooperativeKernel((const void*)bwd_persistent_kernel<T, R, kShifted>,
                                                   dim3(grid), dim3(kThreads), args, 0, stream);
  // a refused launch also sets the runtime's last error: clear it, so that
  // the next launch's check does not report it again
  if (err) return cudaGetLastError(), err;
  return (int)cudaGetLastError();
}

template <typename T, bool kShifted>
int launch_bwd_vec(int vec_bytes, const void* x, const void* dy, const float* stats,
                   const float* scale, const float* bias, void* dx, float* part,
                   long long part_floats, float* tsum, float* dsb, int N, long long S, int C,
                   int CT, int P, int grid, int relu, float m, Shift sh, cudaStream_t s) {
  switch (vec_bytes) {
    case 16: return launch_bwd<T, uint4, kShifted>(x, dy, stats, scale, bias, dx, part, part_floats, tsum, dsb, N, S, C, CT, P, grid, relu, m, sh, s);
    case 8: return launch_bwd<T, uint2, kShifted>(x, dy, stats, scale, bias, dx, part, part_floats, tsum, dsb, N, S, C, CT, P, grid, relu, m, sh, s);
    case 4: return launch_bwd<T, unsigned, kShifted>(x, dy, stats, scale, bias, dx, part, part_floats, tsum, dsb, N, S, C, CT, P, grid, relu, m, sh, s);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch_bwd<T, unsigned short, kShifted>(x, dy, stats, scale, bias, dx, part, part_floats, tsum, dsb, N, S, C, CT, P, grid, relu, m, sh, s);
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
  const Shift sh{};
  if (dtype == 0)
    return launch_vec<float, false>(vec_bytes, x, scale, bias, y, part, stats, N, S, C, CT,
                                    chunk, K, eps, relu, sh, s);
  if (dtype == 1)
    return launch_vec<__nv_bfloat16, false>(vec_bytes, x, scale, bias, y, part, stats, N, S,
                                            C, CT, chunk, K, eps, relu, sh, s);
  return (int)cudaErrorInvalidValue;
}

// hdf_instance_norm_relu in the shifted mode: x (and y) is the (N, S, C) view
// of a packed-shifted (N, *s, 2^npk * C) tensor; stride, period and step give
// its npk packed dims, leading first (ops/instance_norm.py::Shift.walk: cells
// between neighbours, extent * stride, and the residue of the threads' cell
// step, (256 / threads a row) / 2^npk, modulo the period); part holds 2 * N *
// C * K + K floats (the last K: each chunk's valid rows), and the chunk is at
// most 32 rows a thread. Statistics leave the pad rows out; y is 0 there.
extern "C" int hdf_instance_norm_relu_shifted(const void* x, const float* scale,
                                              const float* bias, void* y, float* part,
                                              float* stats, int dtype, int vec_bytes, int N,
                                              long long S, int C, int CT, int chunk, int K,
                                              float eps, int relu, int npk, const int* stride,
                                              const int* period, const int* step,
                                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Shift sh;
  if (!make_shift(sh, S, npk, stride, period, step)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_vec<float, true>(vec_bytes, x, scale, bias, y, part, stats, N, S, C, CT,
                                   chunk, K, eps, relu, sh, s);
  if (dtype == 1)
    return launch_vec<__nv_bfloat16, true>(vec_bytes, x, scale, bias, y, part, stats, N, S,
                                           C, CT, chunk, K, eps, relu, sh, s);
  return (int)cudaErrorInvalidValue;
}

// The backward of hdf_instance_norm_relu, one cooperative launch. x, dy and
// dx are contiguous (N, S, C) of one dtype; stats is what the forward wrote
// for this x (per (n, c): the mean relative to row 0, then rsqrt(var +
// eps)); scale and bias as in the forward. The caller chooses the plan
// (ops/instance_norm.py::bwd_launch_plan): vec_bytes (dividing C *
// elem_bytes and all three addresses), the channel tile CT (at most 64
// channels; CT * elem_bytes / vec_bytes threads per row, a power of two <=
// 32), the parts P of each (n, tile) (at most its units of 256 / that count
// rows), and the grid (at most N * tiles * P, and no more blocks than the
// card holds at once: hdf_instance_norm_relu_kernel_attributes). part is
// float32 scratch of part_floats >= 2 * N * C * P; tsum (N * C * 2)
// receives (t1, t2) per (n, c), and dsb, where not null, dscale then dbias
// (2 * C: sum_n inv * t2 and sum_n t1, samples in order). Returns the
// launch's error (cudaErrorCooperativeLaunchTooLarge for a grid that cannot
// co-reside), or cudaErrorInvalidValue for a dtype or plan it does not take.
extern "C" int hdf_instance_norm_relu_bwd(const void* x, const void* dy, const float* stats,
                                          const float* scale, const float* bias, void* dx,
                                          float* part, long long part_floats, float* tsum,
                                          float* dsb, int dtype, int vec_bytes, int N,
                                          long long S, int C, int CT, int P, int grid,
                                          int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shift sh{};
  if (dtype == 0)
    return launch_bwd_vec<float, false>(vec_bytes, x, dy, stats, scale, bias, dx, part,
                                        part_floats, tsum, dsb, N, S, C, CT, P, grid, relu,
                                        (float)S, sh, s);
  if (dtype == 1)
    return launch_bwd_vec<__nv_bfloat16, false>(vec_bytes, x, dy, stats, scale, bias, dx, part,
                                                part_floats, tsum, dsb, N, S, C, CT, P, grid,
                                                relu, (float)S, sh, s);
  return (int)cudaErrorInvalidValue;
}

// hdf_instance_norm_relu_bwd in the shifted mode: x, dy and dx as the
// forward's shifted mode takes x (the step here: P * (256 / threads a row) /
// 2^npk cells), stats what it wrote, m its count of valid rows a sample. dy
// at pad rows is ignored and dx is 0 there. The plan's grid comes from the
// shifted backward's blocks a multiprocessor holds
// (hdf_instance_norm_relu_kernel_attributes(2, dtype, vec_bytes, 1, out)).
extern "C" int hdf_instance_norm_relu_bwd_shifted(
    const void* x, const void* dy, const float* stats, const float* scale, const float* bias,
    void* dx, float* part, long long part_floats, float* tsum, float* dsb, int dtype,
    int vec_bytes, int N, long long S, int C, int CT, int P, int grid, int relu, float m,
    int npk, const int* stride, const int* period, const int* step, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Shift sh;
  if (!make_shift(sh, S, npk, stride, period, step) || !(m >= 1.f))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_bwd_vec<float, true>(vec_bytes, x, dy, stats, scale, bias, dx, part,
                                       part_floats, tsum, dsb, N, S, C, CT, P, grid, relu, m,
                                       sh, s);
  if (dtype == 1)
    return launch_bwd_vec<__nv_bfloat16, true>(vec_bytes, x, dy, stats, scale, bias, dx, part,
                                               part_floats, tsum, dsb, N, S, C, CT, P, grid,
                                               relu, m, sh, s);
  return (int)cudaErrorInvalidValue;
}

namespace {

// out = (registers a thread, local bytes a thread, blocks a multiprocessor
// holds at once) of kernel `which`: 0 the statistics pass, 1 the normalize
// pass, 2 the backward.
template <typename T, typename R, bool kShifted>
int kernel_attributes(int which, int* out) {
  const void* fn = which == 0   ? (const void*)partial_stats_kernel<T, R, kShifted>
                   : which == 1 ? (const void*)normalize_kernel<T, R, kShifted>
                                : (const void*)bwd_persistent_kernel<T, R, kShifted>;
  cudaFuncAttributes a;
  int err = (int)cudaFuncGetAttributes(&a, fn);
  int blocks = 0;
  if (!err) err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, 0);
  if (err) return err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
  return 0;
}

template <typename T, bool kShifted>
int kernel_attributes_vec(int which, int vec_bytes, int* out) {
  switch (vec_bytes) {
    case 16: return kernel_attributes<T, uint4, kShifted>(which, out);
    case 8: return kernel_attributes<T, uint2, kShifted>(which, out);
    case 4: return kernel_attributes<T, unsigned, kShifted>(which, out);
    case 2:
      if constexpr (sizeof(T) == 2) return kernel_attributes<T, unsigned short, kShifted>(which, out);
      else return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// cudaFuncGetAttributes and the occupancy of one InstanceNorm kernel (which:
// 0 statistics, 1 normalize, 2 backward; its shifted instantiation where
// `shifted`): out[0] registers a thread, out[1] local (spilled) bytes a
// thread, out[2] blocks of 256 threads a multiprocessor holds. Returns the
// CUDA error, or cudaErrorInvalidValue for what no kernel is built for.
extern "C" int hdf_instance_norm_relu_kernel_attributes(int which, int dtype, int vec_bytes,
                                                        int shifted, int* out) {
  if (which < 0 || which > 2) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return shifted ? kernel_attributes_vec<float, true>(which, vec_bytes, out)
                   : kernel_attributes_vec<float, false>(which, vec_bytes, out);
  if (dtype == 1)
    return shifted ? kernel_attributes_vec<__nv_bfloat16, true>(which, vec_bytes, out)
                   : kernel_attributes_vec<__nv_bfloat16, false>(which, vec_bytes, out);
  return (int)cudaErrorInvalidValue;
}
