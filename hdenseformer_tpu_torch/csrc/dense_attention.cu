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
// What bounds it on this card: not bytes (1.5 MB a launch) and not the
// tensor cores, but the per-score work that D = 4 leaves outside them. A
// launch has 64 x 729^2 = 34.0 M scores. One exp2 each is ~8 us at 16 ex2
// per clock per SM (data-sheet estimate; PERF.md holds the card's measured
// time and what holds it back).
//
// Geometry (both dtypes). A warp owns 32 query rows of one (b, h): two m16
// tiles of the mma layout. A block is 4 such row groups x 2 key splits = 8
// warps (128 rows), so N = 729 takes 6 blocks per (b, h) and the 384 blocks
// of the (8, 8, 729, 4) launch are all resident at once (3 blocks, 24 warps,
// per SM). The block stages K and V of its (b, h) in shared memory once,
// padded with zeros to whole chunks of 16 keys, each key row as one 8- or
// 16-byte load where the strides allow. Key split s walks the chunks s, s +
// 2, ...; lane (g, t) of a warp holds rows 16i + g and 16i + g + 8 of each
// tile i and keys 2t, 2t + 1, 2t + 8, 2t + 9 of each chunk, so a row is
// spread over the 4 lanes of a quad and the 2 splits. The splits merge
// through shared memory, split 1 into split 0: the exact rescale-and-add of
// split softmax, in a fixed order, so reruns agree bit for bit.
//
// bf16 (the serving path): both products on the tensor cores.
//   - scores: mma.sync m16n8k8 with bf16 operands and fp32 accumulation, D =
//     4 padded to the mma's K of 8 by zeros: the products are exact, so the
//     scores are fp32 math up to summation order;
//   - one sweep, one exp2 per score: p = exp2(s * c - m * c), c = D^-1/2 *
//     log2(e), against a running row max m that starts at the max of the
//     split's first chunk. Where some p of the warp reaches 2^32 (a score far
//     above m, which could overflow the sums), m moves up to that chunk's own
//     max, the sums are rescaled and the chunk's p recomputed; p between 1
//     and 2^32 costs no precision in fp32. Scores within ~32 / c of the first
//     chunk's max take no rescale at all;
//   - P . V: mma.sync m16n8k16 with p as the sum of two bf16 parts, hi (its
//     top 8 significant bits) and lo = bf16(p - hi), so p is carried to 2^-16
//     of itself and the products are exact in the fp32 accumulator; V^T is
//     staged in the B fragment's layout, and for D = 4 its column 4 is ones,
//     so the same mma sums p (D = 8 sums p with a second mma on ones).
// fp32: the same geometry in scalar fp32 fmas, two sweeps (the exact row
// max, then exp2, the sum and p . v); each lane keeps (max, sum, acc[D]) of
// its rows and keys, merged over the quad by warp shuffles (xor 1, then 2).
// Inputs may be strided views as long as D is innermost.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <type_traits>

namespace {

constexpr int kMT = 2;           // m16 tiles per warp
constexpr int kRows = 16 * kMT;  // query rows per warp
constexpr int kStep = 8;         // keys per QK^T mma (m16n8k8's N)
constexpr int kChunk = 16;       // keys per chunk: two steps, one P.V mma's K
constexpr int kGroups = 4;       // row groups (warps of kRows rows) per block
constexpr int kSplits = 2;       // key splits per row group
constexpr int kThreads = 32 * kGroups * kSplits;
constexpr uint32_t kOnes = 0x3f803f80u;  // two bf16 1.0
constexpr uint32_t kBig = (127u + 32u) << 7;  // bf16 bits of 2^32

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the keys of lane t in chunk cc, step h, element e of an accumulator
__device__ __forceinline__ int key_of(int cc, int h, int t, int e) {
  return cc * kChunk + h * kStep + 2 * t + e % 2;
}

// ---------------------------------------------------------------------------
// bf16: QK^T and P.V on the tensor cores
// ---------------------------------------------------------------------------

// d = a . b (m16n8k8, bf16 operands, fp32 accumulation from zero)
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "f"(0.f));
}

// d += a . b (m16n8k16, bf16 operands, fp32 accumulation)
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t max_u16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// V^T in shared memory, bf16, one line of `pitch` 8-byte words per dim; in
// chunk cc the word cc * 4 + t holds keys 2t, 2t + 1, 2t + 8, 2t + 9: lane
// (g, t)'s B fragment of the P.V mma for dim g. pitch % 16 == 4 puts the
// dims' words in distinct banks.
__host__ __device__ __forceinline__ int vt_pitch(int chunks) {
  const int w = chunks * 4;
  return w + (20 - w % 16) % 16;
}
__device__ __forceinline__ int vt_index(int pitch, int d, int j) {
  return (d * pitch + (j >> 4) * 4 + ((j & 7) >> 1)) * 4 + (j & 1) + ((j >> 2) & 2);
}

// Scores of chunk cc for the lane's rows: s[h][i] is the m16n8 accumulator of
// tile i against keys cc * 16 + 8h + [0, 8).
template <int D>
__device__ __forceinline__ void chunk_scores(const unsigned short* ks, const uint32_t (&qa)[kMT][2],
                                             int cc, int g, int t, float (&s)[2][kMT][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // B fragment: key cc * 16 + 8h + g, dims 2t and 2t + 1 (zero past D)
    uint32_t b = 0;
    if (D == 8 || t < D / 2)
      b = *reinterpret_cast<const uint32_t*>(ks + (cc * kChunk + h * kStep + g) * D + 2 * t);
#pragma unroll
    for (int i = 0; i < kMT; ++i) mma_k8(s[h][i], qa[i][0], qa[i][1], b);
  }
}

// Fold scores into the row maxima m (index 2i + half); `masked` skips keys >= N.
__device__ __forceinline__ void fold_max(const float (&s)[2][kMT][4], int cc, int t, int N,
                                         bool masked, float (&m)[2 * kMT]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!masked || key_of(cc, h, t, e) < N)
          m[2 * i + e / 2] = fmaxf(m[2 * i + e / 2], s[h][i][e]);
}

// one max per row for the quad, whose lanes feed the same rows of the P.V mma
__device__ __forceinline__ void quad_max(float (&m)[2 * kMT]) {
#pragma unroll
  for (int r = 0; r < 2 * kMT; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
}

__device__ __forceinline__ void exp_chunk(const float (&s)[2][kMT][4], const float (&mc)[2 * kMT],
                                          float c, int cc, int t, int N, bool masked,
                                          float (&p)[2][kMT][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[h][i][e] = !masked || key_of(cc, h, t, e) < N
                         ? ex2(fmaf(s[h][i][e], c, -mc[2 * i + e / 2]))
                         : 0.f;
}

// p as hi + lo in the A fragments of the P.V mma: a pair (p0 low, p1 high) of
// keys 2t, 2t + 1 (+ 8 for step 1) of row g (+ 8 for the second register)
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const uint32_t b0 = __float_as_uint(p0), b1 = __float_as_uint(p1);
  hi = __byte_perm(b0, b1, 0x7632);  // the top 16 bits of each: truncated to bf16
  const __nv_bfloat162 l = __floats2bfloat162_rn(p0 - __uint_as_float(b0 & 0xffff0000u),
                                                 p1 - __uint_as_float(b1 & 0xffff0000u));
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void split_chunk(const float (&p)[2][kMT][4], uint32_t (&hi)[kMT][4],
                                            uint32_t (&lo)[kMT][4]) {
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    split_pair(p[0][i][0], p[0][i][1], hi[i][0], lo[i][0]);
    split_pair(p[0][i][2], p[0][i][3], hi[i][1], lo[i][1]);
    split_pair(p[1][i][0], p[1][i][1], hi[i][2], lo[i][2]);
    split_pair(p[1][i][2], p[1][i][3], hi[i][3], lo[i][3]);
  }
}

// One chunk of the sweep: p against the running maxima m, then acc += p . V
// (and, for D = 8, lacc += p . 1). If some p of the warp reaches 2^32, the
// maxima first move up to the chunk's own and acc, lacc are rescaled.
template <int D>
__device__ __forceinline__ void sweep_chunk(const unsigned short* ks, const unsigned short* vt,
                                            const uint32_t (&qa)[kMT][2], int pitch, int cc,
                                            int g, int t, int N, bool masked, float c,
                                            float (&m)[2 * kMT], float (&mc)[2 * kMT],
                                            float (&acc)[kMT][4], float (&lacc)[kMT][4]) {
  float s[2][kMT][4], p[2][kMT][4];
  chunk_scores<D>(ks, qa, cc, g, t, s);
  exp_chunk(s, mc, c, cc, t, N, masked, p);
  uint32_t hi[kMT][4], lo[kMT][4];
  split_chunk(p, hi, lo);
  // p >= 0, so its bf16 bits order as its values
  uint32_t top = hi[0][0];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) top = max_u16x2(top, hi[i][u]);
  if (__any_sync(0xffffffffu, (top & 0xffffu) >= kBig || (top >> 16) >= kBig)) {
    float mx[2 * kMT];
#pragma unroll
    for (int r = 0; r < 2 * kMT; ++r) mx[r] = m[r];
    fold_max(s, cc, t, N, masked, mx);
    quad_max(mx);
#pragma unroll
    for (int r = 0; r < 2 * kMT; ++r) {
      const float corr = ex2((m[r] - mx[r]) * c);
      m[r] = mx[r];
      mc[r] = mx[r] * c;
#pragma unroll
      for (int e = 2 * (r % 2); e < 2 * (r % 2) + 2; ++e) {
        acc[r / 2][e] *= corr;
        lacc[r / 2][e] *= corr;
      }
    }
    exp_chunk(s, mc, c, cc, t, N, masked, p);
    split_chunk(p, hi, lo);
  }
  // B fragment of V: keys 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1), column g:
  // dim g, or for D = 4 ones in column 4 (the row sums) and zeros past it
  uint32_t b0, b1;
  if (g < D) {
    const uint2 w = reinterpret_cast<const uint2*>(vt)[g * pitch + cc * 4 + t];
    b0 = w.x;
    b1 = w.y;
  } else {
    b0 = b1 = g == D ? kOnes : 0u;
  }
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    mma_k16(acc[i], hi[i], b0, b1);
    mma_k16(acc[i], lo[i], b0, b1);
    if constexpr (D == 8) {
      mma_k16(lacc[i], hi[i], kOnes, kOnes);
      mma_k16(lacc[i], lo[i], kOnes, kOnes);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 3)
dense_attention_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                            int H, int N, long long sb, long long sh, long long sn, float c,
                            bool vec_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunks = (N + kChunk - 1) / kChunk, np = chunks * kChunk;
  const int pitch = vt_pitch(chunks);
  unsigned short* ks = reinterpret_cast<unsigned short*>(smem);  // K: (np, D)
  unsigned short* vt =
      reinterpret_cast<unsigned short*>(smem + (np * D * 2 + 15) / 16 * 16);  // V^T
  // the state of splits 1, 2, ... for split 0, lane-minor
  __shared__ float s_acc[kSplits - 1][kGroups][4 * kMT][32];
  __shared__ float s_m[kSplits - 1][kGroups][2 * kMT][32];
  __shared__ float s_l[kSplits - 1][kGroups][D == 8 ? 2 * kMT : 1][32];

  const int bh = blockIdx.y;
  const long long base = (long long)(bh / H) * sb + (long long)(bh % H) * sh;
  const unsigned short* kb = reinterpret_cast<const unsigned short*>(k) + base;
  const unsigned short* vb = reinterpret_cast<const unsigned short*>(v) + base;
  if (vec_rows) {
    using U = std::conditional_t<D == 8, uint4, uint2>;  // one key row
#pragma unroll 4
    for (int j = threadIdx.x; j < np; j += kThreads) {
      U kr{}, vr{};
      if (j < N) {
        kr = *reinterpret_cast<const U*>(kb + (long long)j * sn);
        vr = *reinterpret_cast<const U*>(vb + (long long)j * sn);
      }
      reinterpret_cast<U*>(ks)[j] = kr;
      const unsigned short* ve = reinterpret_cast<const unsigned short*>(&vr);
#pragma unroll
      for (int d = 0; d < D; ++d) vt[vt_index(pitch, d, j)] = ve[d];
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < np * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const long long off = (long long)j * sn + d;
      ks[i] = j < N ? kb[off] : (unsigned short)0;
      vt[vt_index(pitch, d, j)] = j < N ? vb[off] : (unsigned short)0;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = warp % kGroups, split = warp / kGroups;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (blockIdx.x * kGroups + group) * kRows;
  const bool live = row0 < N;  // uniform across the warp

  // acc[i]: rows 16i + g (elements 0, 1) and 16i + g + 8 (2, 3), columns 2t,
  // 2t + 1; m[2i + half]: the running max of row 16i + g + 8 * half
  float acc[kMT][4], lacc[kMT][4], m[2 * kMT];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = lacc[i][e] = 0.f;
#pragma unroll
  for (int r = 0; r < 2 * kMT; ++r) m[r] = -INFINITY;

  if (live) {
    // A fragments of the QK^T mma: rows 16i + g and 16i + g + 8, dims 2t, 2t + 1
    uint32_t qa[kMT][2];
    const unsigned short* qb = reinterpret_cast<const unsigned short*>(q) + base;
#pragma unroll
    for (int r = 0; r < 2 * kMT; ++r) {
      const int row = row0 + 16 * (r / 2) + g + 8 * (r % 2);
      uint32_t pair = 0u;
      if (row < N && (D == 8 || t < D / 2)) {
        const long long off = (long long)row * sn + 2 * t;
        pair = (uint32_t)qb[off] | ((uint32_t)qb[off + 1] << 16);
      }
      qa[r / 2][r % 2] = pair;
    }
    const int nfull = N / kChunk;  // whole chunks; a ragged last one is the tail
    const bool tail = N % kChunk != 0 && nfull % kSplits == split;
    // the first estimate of the row maxima: this split's first chunk
    if (split < chunks) {
      float s[2][kMT][4];
      chunk_scores<D>(ks, qa, split, g, t, s);
      fold_max(s, split, t, N, split == nfull, m);
      quad_max(m);
    }
    float mc[2 * kMT];
#pragma unroll
    for (int r = 0; r < 2 * kMT; ++r) mc[r] = m[r] * c;
#pragma unroll 4
    for (int cc = split; cc < nfull; cc += kSplits)
      sweep_chunk<D>(ks, vt, qa, pitch, cc, g, t, N, false, c, m, mc, acc, lacc);
    if (tail) sweep_chunk<D>(ks, vt, qa, pitch, nfull, g, t, N, true, c, m, mc, acc, lacc);
    if (split > 0) {
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s_acc[split - 1][group][4 * i + e][lane] = acc[i][e];
#pragma unroll
      for (int r = 0; r < 2 * kMT; ++r) s_m[split - 1][group][r][lane] = m[r];
      if constexpr (D == 8) {
#pragma unroll
        for (int r = 0; r < 2 * kMT; ++r)
          s_l[split - 1][group][r][lane] = lacc[r / 2][2 * (r % 2)];
      }
    }
  }
  __syncthreads();
  if (!live || split != 0) return;

  // the key splits into split 0, in order: the exact rescale-and-add. Each
  // product is rounded on its own, so the merge is symmetric.
  float l[2 * kMT];
#pragma unroll
  for (int r = 0; r < 2 * kMT; ++r) l[r] = lacc[r / 2][2 * (r % 2)];
#pragma unroll
  for (int sp = 0; sp < kSplits - 1; ++sp)
#pragma unroll
    for (int r = 0; r < 2 * kMT; ++r) {
      const float mb = s_m[sp][group][r][lane];
      const float mn = fmaxf(m[r], mb);
      const float ea = m[r] == -INFINITY ? 0.f : ex2((m[r] - mn) * c);
      const float eb = mb == -INFINITY ? 0.f : ex2((mb - mn) * c);
      const int i = r / 2, e0 = 2 * (r % 2);
#pragma unroll
      for (int e = e0; e < e0 + 2; ++e)
        acc[i][e] = __fadd_rn(__fmul_rn(acc[i][e], ea),
                              __fmul_rn(s_acc[sp][group][4 * i + e][lane], eb));
      if constexpr (D == 8)
        l[r] = __fadd_rn(__fmul_rn(l[r], ea), __fmul_rn(s_l[sp][group][r][lane], eb));
      m[r] = mn;
    }
  if constexpr (D < 8) {
    // the row sums are column D of acc, held by lane t = D / 2 of the quad
#pragma unroll
    for (int r = 0; r < 2 * kMT; ++r)
      l[r] = __shfl_sync(0xffffffffu, acc[r / 2][2 * (r % 2)], (lane & ~3) | (D / 2));
  }
  if (2 * t >= D) return;
  // lane t writes dims 2t, 2t + 1 of its rows
#pragma unroll
  for (int r = 0; r < 2 * kMT; ++r) {
    const int row = row0 + 16 * (r / 2) + g + 8 * (r % 2);
    if (row >= N) continue;
    const float inv = 1.f / l[r];
    const int e0 = 2 * (r % 2);
    *reinterpret_cast<__nv_bfloat162*>(o + ((long long)bh * N + row) * D + 2 * t) =
        __floats2bfloat162_rn(acc[r / 2][e0] * inv, acc[r / 2][e0 + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// fp32: the same geometry in scalar fmas
// ---------------------------------------------------------------------------

// Softmax state of one row as this lane sees it.
template <int D>
struct RowState {
  float m, l, acc[D];
};

// Fold b into a: the rescale-and-add of split softmax. Each product is
// rounded on its own, so merge(a, b) and merge(b, a) give the same bits.
template <int D>
__device__ __forceinline__ void merge(RowState<D>& a, const RowState<D>& b, float c) {
  const float mn = fmaxf(a.m, b.m);
  const float ea = a.m == -INFINITY ? 0.f : ex2((a.m - mn) * c);
  const float eb = b.m == -INFINITY ? 0.f : ex2((b.m - mn) * c);
  a.l = __fadd_rn(__fmul_rn(a.l, ea), __fmul_rn(b.l, eb));
#pragma unroll
  for (int d = 0; d < D; ++d)
    a.acc[d] = __fadd_rn(__fmul_rn(a.acc[d], ea), __fmul_rn(b.acc[d], eb));
  a.m = mn;
}

template <int D>
__device__ __forceinline__ RowState<D> shfl_state(const RowState<D>& a, int mask) {
  RowState<D> b;
  b.m = __shfl_xor_sync(0xffffffffu, a.m, mask);
  b.l = __shfl_xor_sync(0xffffffffu, a.l, mask);
#pragma unroll
  for (int d = 0; d < D; ++d) b.acc[d] = __shfl_xor_sync(0xffffffffu, a.acc[d], mask);
  return b;
}

// Scores of the lane's rows x keys (j0 + 2t, j0 + 2t + 1), unscaled, in the
// layout of the bf16 path's mma accumulator: s[i][0] = (16i + g, 2t),
// s[i][1] = (16i + g, 2t + 1), s[i][2] = (16i + g + 8, 2t), s[i][3] = (16i +
// g + 8, 2t + 1).
template <int D>
__device__ __forceinline__ void step_scores(const float* ks, const float (&qf)[2 * kMT][D], int j0,
                                            int t, float (&s)[kMT][4]) {
  const float4* ka = reinterpret_cast<const float4*>(ks + (j0 + 2 * t) * D);
  const float4* kb = ka + D / 4;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
  for (int h = 0; h < D / 4; ++h) {
    const float4 a4 = ka[h], b4 = kb[h];
    const float av[4] = {a4.x, a4.y, a4.z, a4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        s[i][0] = fmaf(qf[2 * i][4 * h + d], av[d], s[i][0]);
        s[i][1] = fmaf(qf[2 * i][4 * h + d], bv[d], s[i][1]);
        s[i][2] = fmaf(qf[2 * i + 1][4 * h + d], av[d], s[i][2]);
        s[i][3] = fmaf(qf[2 * i + 1][4 * h + d], bv[d], s[i][3]);
      }
  }
}

// p . v for one step: the lane's rows x keys (ja, ja + 1), p as step_scores;
// one load of the two V rows serves all the lane's rows.
template <int D>
__device__ __forceinline__ void accumulate(RowState<D> (&r)[2 * kMT], const float* vs, int ja,
                                           const float (&p)[kMT][4]) {
  const float4* va = reinterpret_cast<const float4*>(vs + ja * D);
  const float4* vb = reinterpret_cast<const float4*>(vs + (ja + 1) * D);
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    r[2 * i].l += p[i][0] + p[i][1];
    r[2 * i + 1].l += p[i][2] + p[i][3];
  }
#pragma unroll
  for (int h = 0; h < D / 4; ++h) {
    const float4 a = va[h], b = vb[h];
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        float& x = r[2 * i].acc[4 * h + d];
        float& y = r[2 * i + 1].acc[4 * h + d];
        x = fmaf(p[i][1], bv[d], fmaf(p[i][0], av[d], x));
        y = fmaf(p[i][3], bv[d], fmaf(p[i][2], av[d], y));
      }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 3)
dense_attention_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o, int H, int N,
                           long long sb, long long sh, long long sn, float c, bool vec_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = (N + kChunk - 1) / kChunk * kChunk;
  float* ks = reinterpret_cast<float*>(smem);  // (np, D)
  float* vs = ks + np * D;                     // (np, D)
  __shared__ RowState<D> s_split[kSplits - 1][kGroups][kRows];  // splits 1, 2, ...

  const int bh = blockIdx.y;
  const long long base = (long long)(bh / H) * sb + (long long)(bh % H) * sh;
  if (vec_rows) {
#pragma unroll 4
    for (int j = threadIdx.x; j < np; j += kThreads) {
#pragma unroll
      for (int u = 0; u < D / 4; ++u) {  // 16-byte loads a key row
        float4 kr = {0.f, 0.f, 0.f, 0.f}, vr = kr;
        if (j < N) {
          kr = reinterpret_cast<const float4*>(k + base + (long long)j * sn)[u];
          vr = reinterpret_cast<const float4*>(v + base + (long long)j * sn)[u];
        }
        reinterpret_cast<float4*>(ks + j * D)[u] = kr;
        reinterpret_cast<float4*>(vs + j * D)[u] = vr;
      }
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < np * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const long long off = base + (long long)j * sn + d;
      ks[i] = j < N ? k[off] : 0.f;
      vs[i] = j < N ? v[off] : 0.f;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = warp % kGroups, split = warp / kGroups;
  const int t = lane & 3;
  const int row0 = (blockIdx.x * kGroups + group) * kRows;
  const bool live = row0 < N;  // uniform across the warp
  // the lane's rows: 16i + g (index 2i) and 16i + g + 8 (index 2i + 1)
  int rows[2 * kMT];
#pragma unroll
  for (int r = 0; r < 2 * kMT; ++r) rows[r] = row0 + 16 * (r / 2) + (lane >> 2) + 8 * (r % 2);

  RowState<D> st[2 * kMT];
#pragma unroll
  for (int r = 0; r < 2 * kMT; ++r) {
    st[r].m = -INFINITY;
    st[r].l = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) st[r].acc[d] = 0.f;
  }

  if (live) {
    float qf[2 * kMT][D];
#pragma unroll
    for (int r = 0; r < 2 * kMT; ++r)
#pragma unroll
      for (int d = 0; d < D; ++d)
        qf[r][d] = rows[r] < N ? q[base + (long long)rows[r] * sn + d] : 0.f;
    const int nfull = N / kChunk;
    const bool tail = N % kChunk != 0 && nfull % kSplits == split;

    // sweep 1: this lane's max over its keys
#pragma unroll 1
    for (int cc = split; cc < nfull; cc += kSplits)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s[kMT][4];
        step_scores<D>(ks, qf, cc * kChunk + h * kStep, t, s);
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          st[2 * i].m = fmaxf(st[2 * i].m, fmaxf(s[i][0], s[i][1]));
          st[2 * i + 1].m = fmaxf(st[2 * i + 1].m, fmaxf(s[i][2], s[i][3]));
        }
      }
    if (tail) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s[kMT][4];
        step_scores<D>(ks, qf, nfull * kChunk + h * kStep, t, s);
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key_of(nfull, h, t, e) < N)
              st[2 * i + e / 2].m = fmaxf(st[2 * i + e / 2].m, s[i][e]);
      }
    }
    // sweep 2: one exp2 per score, the sum and p . v in fp32
    float mc[2 * kMT];
#pragma unroll
    for (int r = 0; r < 2 * kMT; ++r) mc[r] = st[r].m * c;
#pragma unroll 2
    for (int cc = split; cc < nfull; cc += kSplits)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s[kMT][4], p[kMT][4];
        step_scores<D>(ks, qf, cc * kChunk + h * kStep, t, s);
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[i][e] = ex2(fmaf(s[i][e], c, -mc[2 * i + e / 2]));
        accumulate<D>(st, vs, key_of(cc, h, t, 0), p);
      }
    if (tail) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s[kMT][4], p[kMT][4];
        step_scores<D>(ks, qf, nfull * kChunk + h * kStep, t, s);
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[i][e] = key_of(nfull, h, t, e) < N ? ex2(fmaf(s[i][e], c, -mc[2 * i + e / 2]))
                                                 : 0.f;
        accumulate<D>(st, vs, key_of(nfull, h, t, 0), p);
      }
    }
    // the quad's four lanes, in a fixed butterfly
#pragma unroll
    for (int mask = 1; mask <= 2; mask <<= 1)
#pragma unroll
      for (int r = 0; r < 2 * kMT; ++r) merge<D>(st[r], shfl_state<D>(st[r], mask), c);
    if (split > 0 && t == 0) {
#pragma unroll
      for (int r = 0; r < 2 * kMT; ++r) s_split[split - 1][group][rows[r] - row0] = st[r];
    }
  }
  __syncthreads();
  if (!live || split != 0) return;
#pragma unroll
  for (int r = 0; r < 2 * kMT; ++r) {
#pragma unroll
    for (int sp = 0; sp < kSplits - 1; ++sp)
      merge<D>(st[r], s_split[sp][group][rows[r] - row0], c);
    if (rows[r] >= N) continue;
    const float inv = 1.f / st[r].l;
    // lane t writes dims t, t + 4 of its rows
    float* out = o + ((long long)bh * N + rows[r]) * D;
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d % 4 == t) out[d] = st[r].acc[d] * inv;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int D>
struct Kernel;
template <int D>
struct Kernel<float, D> {
  static constexpr auto fn = dense_attention_kernel_f32<D>;
  // K and V, fp32 rows
  static size_t smem(int N) {
    return (size_t)2 * ((N + kChunk - 1) / kChunk * kChunk) * D * sizeof(float);
  }
};
template <int D>
struct Kernel<__nv_bfloat16, D> {
  static constexpr auto fn = dense_attention_kernel_bf16<D>;
  // K as bf16 rows, then V^T in the P.V mma's B layout
  static size_t smem(int N) {
    const int chunks = (N + kChunk - 1) / kChunk;
    return ((size_t)chunks * kChunk * D * 2 + 15) / 16 * 16 + (size_t)D * vt_pitch(chunks) * 8;
  }
};

template <typename T, int D>
int blocks_per_sm(int N) {
  using K = Kernel<T, D>;
  int blocks = 0;
  if (cudaFuncSetAttribute(K::fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)K::smem(N)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, K::fn, kThreads, K::smem(N)) !=
          cudaSuccess)
    return -1;
  return blocks;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
           long long sb, long long sh, long long sn, float c, cudaStream_t stream) {
  using K = Kernel<T, D>;
  // the static split-merge buffer counts against the same 48 KB default
  const size_t smem = K::smem(N);
  cudaError_t e = cudaFuncSetAttribute(K::fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  // whole key rows as one load (bf16: 8 or 16 bytes) or 16-byte loads (fp32)
  // where every row start is aligned
  const size_t unit = std::is_same_v<T, float> ? 16 : D * sizeof(T);
  const bool vec_rows = ((uintptr_t)k | (uintptr_t)v) % unit == 0 &&
                        (sb * sizeof(T)) % unit == 0 && (sh * sizeof(T)) % unit == 0 &&
                        (sn * sizeof(T)) % unit == 0;
  const int row_groups = (N + kRows - 1) / kRows;
  const dim3 grid((row_groups + kGroups - 1) / kGroups, B * H);
  K::fn<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                          static_cast<const T*>(v), static_cast<T*>(o), H, N, sb,
                                          sh, sn, c, vec_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k and v share shape (B, H, N, D) and
// the strides (sb, sh, sn) in elements, with D innermost and contiguous; o is
// a contiguous (B, H, N, D) tensor. The grid is (ceil(N / 128), B * H)
// blocks of 256 threads (ops/dense_attention.py::launch_plan mirrors it).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a dtype or D it was not built for.
extern "C" int hdf_dense_attention(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int H, int N, int D,
                                   long long sb, long long sh, long long sn,
                                   float scale, void* stream) {
  const float c = scale * 1.4426950408889634f;  // log2(e)
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || B * H < 1 || B * H > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 4) return launch<float, 4>(q, k, v, o, B, H, N, sb, sh, sn, c, s);
  if (dtype == 0 && D == 8) return launch<float, 8>(q, k, v, o, B, H, N, sb, sh, sn, c, s);
  if (dtype == 1 && D == 4) return launch<__nv_bfloat16, 4>(q, k, v, o, B, H, N, sb, sh, sn, c, s);
  if (dtype == 1 && D == 8) return launch<__nv_bfloat16, 8>(q, k, v, o, B, H, N, sb, sh, sn, c, s);
  return (int)cudaErrorInvalidValue;
}

// Resident blocks of 256 threads per SM for this dtype, D and N (the
// occupancy that chip_smoke.py reports beside the kernel's time), or -1.
extern "C" int hdf_dense_attention_blocks_per_sm(int dtype, int D, int N) {
  if (dtype == 0 && D == 4) return blocks_per_sm<float, 4>(N);
  if (dtype == 0 && D == 8) return blocks_per_sm<float, 8>(N);
  if (dtype == 1 && D == 4) return blocks_per_sm<__nv_bfloat16, 4>(N);
  if (dtype == 1 && D == 8) return blocks_per_sm<__nv_bfloat16, 8>(N);
  return -1;
}
