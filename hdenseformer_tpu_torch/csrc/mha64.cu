// Multi-head attention at head width 64 in bf16, forward and backward,
// hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes TransBTS's and UNETR's
// attention as plain einsums (hdenseformer_tpu/models/transbts.py:192,
// unetr.py:83), and the port's plain version (models/layers.py
// self_attention) writes and reads the (B, H, N, N) fp32 scores, softmax,
// dropout select and bf16 copy of the probabilities, forward and backward:
// at TransBTS's (2, 8, 5832, 64) each is 2.18 GB a layer. This kernel keeps
// every N x N tile on chip; only the dropout's keep mask, one byte a score
// drawn outside (torch.rand(...) >= p from the caller's generator), is read.
//
// Computes, for every (b, h): S = Q K^T with bf16 operands and fp32
// accumulation (exact products: the precision of fp32 math on bf16 inputs),
// P = softmax(S / 8) in fp32, P~ = P * keep / (1 - p) rounded to bf16 for
// P~ V with fp32 accumulation, O in bf16 (and in fp32 for the backward),
// the row's log-sum-exp (log2 units). Q, K and V are read straight from
// the qkv projection's (B, N, 3, H, 64) output through its strides; O is
// written as (B, N, H * 64).
//
// Backward, with D = rowsum(dO o O) (O in fp32):
//   dP~ = dO V^T (fp32 accumulation), dS = P o (dP~ o keep / (1 - p) - D),
//   dV = P~^T dO, dQ = dS K / 8, dK = dS^T Q / 8.
// dS enters dQ and dK at fp32 precision as the sum of three bf16 parts (hi,
// mid, lo: 24 significant bits), each an exact product with bf16 K or Q in
// the fp32 accumulator. Two launches, deterministic (no atomics): a dQ pass
// over query tiles, which also writes D, then a dK/dV pass over key tiles.
// dQ, dK and dV are written into the (B, N, 3, H, 64) gradient of qkv.
//
// What bounds it on this card: at N = 5832 the products (~0.14 TFLOP a
// layer forward, ~0.35 backward counting dS once) and the exponentials (N^2
// a (b, h), each pass) are within a factor of two of each other, and the
// mask's N^2 bytes a (b, h) a pass is the only traffic that scales with
// N^2. The design keeps the tensor cores fed from shared memory:
//   - mma.sync m16n8k16 (bf16, fp32 accumulation); a warp owns 16 rows of a
//     tile; fragments come from shared memory by ldmatrix, with each 128-byte
//     row's 16-byte chunks XOR-swizzled by row so that ldmatrix is free of
//     bank conflicts; the probabilities go from the score accumulators to
//     the next product's A operand in registers (no shared memory);
//   - tiles of 64 keys (forward, dQ) or 64 queries (dK/dV) in a ring of two
//     stages, loaded by cp.async while the previous tile is computed; the
//     mask tile rides in the same ring (8-byte copies where N % 8 == 0);
//   - a forward block is 8 warps (128 queries), a backward block 4 warps
//     (64 rows) that take each 64-wide tile in two halves of 32, so that
//     three blocks (168 registers a thread) share an SM;
//   - N need not be a multiple of 64: rows past N are zero-filled, keys past
//     N get probability 0, and no row past N is written.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;                    // head width
constexpr int kRowBytes = kD * 2;         // one bf16 row of a tile
constexpr int kTile = 64;                 // keys (forward, dQ) or queries (dK/dV) a stage
constexpr int kTileBytes = kTile * kRowBytes;
constexpr int kPitch = 72;                // bytes a row of a mask tile: 64 + 8, conflict-free
constexpr int kFwdWarps = 8;
constexpr int kFwdRows = 16 * kFwdWarps;  // queries of a forward block
constexpr int kBwdWarps = 4;
constexpr int kBwdRows = 16 * kBwdWarps;  // queries (dQ) or keys (dK/dV) of a backward block
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kBwdThreads = 32 * kBwdWarps;

// shared memory, in bytes: Q, K and V stages, mask stages (forward)
constexpr int kFwdMask = kFwdRows * kPitch;
constexpr int kFwdSmem = kFwdRows * kRowBytes + 4 * kTileBytes + 2 * kFwdMask;
// dQ: Q, dO, K and V stages, mask stages, D of the block's rows
constexpr int kBwdMask = kBwdRows * kPitch;
constexpr int kDqSmem = 2 * kBwdRows * kRowBytes + 4 * kTileBytes + 2 * kBwdMask + kBwdRows * 4;
// dK/dV: K, V, Q and dO stages, mask stages, lse and D stages
constexpr int kDkvSmem = 2 * kBwdRows * kRowBytes + 4 * kTileBytes + 2 * kBwdMask + 4 * kTile * 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of the 16-byte chunk `chunk` (8 bf16) of row r in a tile of
// 128-byte rows, swizzled by row
__device__ __forceinline__ uint32_t swz(int r, int chunk) {
  return r * kRowBytes + ((chunk ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a . b (m16n8k16, bf16 operands, fp32 accumulation); not volatile, so
// the compiler may interleave independent products
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) as hi + mid + lo, three bf16 pairs: 24 significant bits of each
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  __nv_bfloat162 l = __floats2bfloat162_rn(rx - mf.x, ry - mf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  mid = *reinterpret_cast<uint32_t*>(&m);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// R rows of 64 bf16 from g (row stride ld elements), rows row0.. of n, into
// the swizzled tile at s; rows past n are zero-filled
template <int R, int T>
__device__ __forceinline__ void load_rows(uint32_t s, const bf16* g, long long ld, int row0,
                                          int n) {
#pragma unroll
  for (int i = threadIdx.x; i < R * 8; i += T) {
    const int r = i >> 3, c = i & 7;
    const bool valid = row0 + r < n;
    cp_async16(s + swz(r, c), g + (valid ? (row0 + r) * ld + c * 8 : 0), valid);
  }
}

// the keep mask's R rows q0.. and 64 columns k0.. of an (n, n) byte matrix
// into rows of kPitch bytes at s, 0 past n; as 8-byte copies when n % 8 == 0
template <int R, int T>
__device__ __forceinline__ void load_keep(uint8_t* s, const uint8_t* g, int n, int q0, int k0,
                                          bool vec) {
  if (vec) {
#pragma unroll
    for (int i = threadIdx.x; i < R * 8; i += T) {
      const int r = i >> 3, c = i & 7;
      const bool valid = q0 + r < n && k0 + c * 8 < n;
      cp_async8(smem_u32(s + r * kPitch + c * 8),
                g + (valid ? (long long)(q0 + r) * n + k0 + c * 8 : 0), valid);
    }
  } else {
    for (int i = threadIdx.x; i < R * 64; i += T) {
      const int r = i >> 6, c = i & 63;
      s[r * kPitch + c] = (q0 + r < n && k0 + c < n) ? g[(long long)(q0 + r) * n + k0 + c] : 0;
    }
  }
}

// A fragments (16 x 64, four k16 steps) of rows r0.. of a swizzled tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], uint32_t s, int r0, int lane) {
#pragma unroll
  for (int kd = 0; kd < 4; ++kd) ldsm_x4(a[kd], s + swz(r0 + (lane & 15), kd * 2 + (lane >> 4)));
}

// acc[j] += A . B^T for NJ n8 tiles of a row-major tile B whose rows r0..
// r0 + 8 NJ - 1 are the product's n: scores Q K^T, dO V^T, and their
// transposes
template <int NJ>
__device__ __forceinline__ void gemm_abt(float (&acc)[NJ][4], const uint32_t (&a)[4][4],
                                         uint32_t sb, int r0, int lane) {
#pragma unroll
  for (int kd = 0; kd < 4; ++kd) {
#pragma unroll
    for (int np = 0; np < NJ / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, sb + swz(r0 + np * 16 + (lane & 7) + ((lane >> 4) << 3),
                          kd * 2 + ((lane >> 3) & 1)));
      mma(acc[2 * np], a[kd], b[0], b[1]);
      mma(acc[2 * np + 1], a[kd], b[2], b[3]);
    }
  }
}

// acc[j] += sum over the NT parts of a[part] . B[k0..k0 + 15, 8 j..] for a
// row-major tile B (rows = the product's k): P V, dS K, P^T dO, dS^T Q. The
// B fragments are loaded first, so that consecutive products go to
// different accumulators (no chain of dependent mma through a part loop).
template <int NT>
__device__ __forceinline__ void gemm_ab(float (&acc)[8][4], const uint32_t (&a)[NT][4], int k0,
                                        uint32_t sb, int lane) {
  uint32_t b[4][4];
#pragma unroll
  for (int dp = 0; dp < 4; ++dp)
    ldsm_x4_t(b[dp], sb + swz(k0 + (lane & 15), dp * 2 + (lane >> 4)));
#pragma unroll
  for (int part = 0; part < NT; ++part)
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      mma(acc[2 * dp], a[part], b[dp][0], b[dp][1]);
      mma(acc[2 * dp + 1], a[part], b[dp][2], b[dp][3]);
    }
}

// the A fragment of k16 step kk from the accumulators of n8 tiles 2kk, 2kk + 1
template <int NJ>
__device__ __forceinline__ void to_a(uint32_t (&a)[1][4], const float (&x)[NJ][4], int kk) {
  a[0][0] = pack(x[2 * kk][0], x[2 * kk][1]);
  a[0][1] = pack(x[2 * kk][2], x[2 * kk][3]);
  a[0][2] = pack(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[0][3] = pack(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}
// the same as three bf16 parts (hi, mid, lo)
template <int NJ>
__device__ __forceinline__ void to_a3(uint32_t (&a)[3][4], const float (&x)[NJ][4], int kk) {
  split3(x[2 * kk][0], x[2 * kk][1], a[0][0], a[1][0], a[2][0]);
  split3(x[2 * kk][2], x[2 * kk][3], a[0][1], a[1][1], a[2][1]);
  split3(x[2 * kk + 1][0], x[2 * kk + 1][1], a[0][2], a[1][2], a[2][2]);
  split3(x[2 * kk + 1][2], x[2 * kk + 1][3], a[0][3], a[1][3], a[2][3]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// forward: grid (ceil(N / 128), B * H), 8 warps; warp w owns queries 16w..
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kFwdThreads)
    mha64_fwd_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ keep,
                     bf16* __restrict__ o, float* __restrict__ o32, float* __restrict__ lse,
                     int H, int N, long long sb, long long sn, float c, float keep_scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kFwdRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long C = (long long)H * kD;
  const bf16* qg = qkv + b * sb + h * kD;
  const bf16* kg = qg + C;
  const bf16* vg = qg + 2 * C;
  const uint8_t* mg = keep ? keep + (long long)bh * N * N : nullptr;
  const bool vec = (N & 7) == 0;
  const uint32_t sQ = smem_u32(smem), sK = sQ + kFwdRows * kRowBytes, sV = sK + 2 * kTileBytes;
  uint8_t* sM = smem + kFwdRows * kRowBytes + 4 * kTileBytes;
  const int tiles = (N + kTile - 1) / kTile;

  load_rows<kFwdRows, kFwdThreads>(sQ, qg, sn, q0, N);
  load_rows<kTile, kFwdThreads>(sK, kg, sn, 0, N);
  load_rows<kTile, kFwdThreads>(sV, vg, sn, 0, N);
  if (mg) load_keep<kFwdRows, kFwdThreads>(sM, mg, N, q0, 0, vec);
  cp_async_commit();

  uint32_t qa[4][4];
  float acc[8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j = 0; j < tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < tiles) {
      const int k1 = (j + 1) * kTile;
      load_rows<kTile, kFwdThreads>(sK + (st ^ 1) * kTileBytes, kg, sn, k1, N);
      load_rows<kTile, kFwdThreads>(sV + (st ^ 1) * kTileBytes, vg, sn, k1, N);
      if (mg) load_keep<kFwdRows, kFwdThreads>(sM + (st ^ 1) * kFwdMask, mg, N, q0, k1, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (j == 0) load_a(qa, sQ, warp * 16, lane);

    float s[8][4] = {};
    gemm_abt<8>(s, qa, sK + st * kTileBytes, 0, lane);
    const int k0 = j * kTile;
    if (k0 + kTile > N) {  // the ragged last tile: keys past N out of the softmax
#pragma unroll
      for (int jt = 0; jt < 8; ++jt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + jt * 8 + 2 * t + (e & 1) >= N) s[jt][e] = -INFINITY;
    }
    // the running max m in raw score units; p = 2^(s c - m c), one FFMA a score
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jt = 0; jt < 8; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[jt][e]);
    float alpha[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = ex2((m[r] - mn) * c);
      m[r] = mn;
      mc[r] = mn * c;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] *= alpha[e >> 1];
    const uint8_t* mrow = sM + st * kFwdMask + (warp * 16 + g) * kPitch + 2 * t;
#pragma unroll
    for (int jt = 0; jt < 8; ++jt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = ex2(fmaf(s[jt][2 * r], c, -mc[r]));
        const float p1 = ex2(fmaf(s[jt][2 * r + 1], c, -mc[r]));
        l[r] += p0 + p1;
        if (mg) {
          const uint16_t w = *reinterpret_cast<const uint16_t*>(mrow + r * 8 * kPitch + jt * 8);
          s[jt][2 * r] = (w & 0xff) ? p0 * keep_scale : 0.f;
          s[jt][2 * r + 1] = (w >> 8) ? p1 * keep_scale : 0.f;
        } else {
          s[jt][2 * r] = p0;
          s[jt][2 * r + 1] = p1;
        }
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[1][4];
      to_a<8>(pa, s, kk);
      gemm_ab<1>(acc, pa, kk * 16, sV + st * kTileBytes, lane);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= N) continue;
    const float inv = 1.f / lr;
    const long long base = ((long long)b * N + row) * C + h * kD;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const int col = dt * 8 + 2 * t;
      const float v0 = acc[dt][2 * r] * inv, v1 = acc[dt][2 * r + 1] * inv;
      *reinterpret_cast<__nv_bfloat162*>(o + base + col) = __floats2bfloat162_rn(v0, v1);
      if (o32) *reinterpret_cast<float2*>(o32 + base + col) = make_float2(v0, v1);
    }
    if (lse && t == 0) lse[(long long)bh * N + row] = m[r] * c + log2f(lr);
  }
}

// ---------------------------------------------------------------------------
// backward, dQ pass: grid (ceil(N / 64), B * H), 4 warps; warp w owns
// queries 16w.. of the block and walks every key tile. Writes D.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kBwdThreads, 3)
    mha64_bwd_dq_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ keep,
                        const bf16* __restrict__ dout, const float* __restrict__ o32,
                        const float* __restrict__ lse, float* __restrict__ dlt,
                        bf16* __restrict__ dqkv, int H, int N, long long sb, long long sn,
                        float c, float scale, float keep_scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kBwdRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long C = (long long)H * kD;
  const bf16* qg = qkv + b * sb + h * kD;
  const bf16* kg = qg + C;
  const bf16* vg = qg + 2 * C;
  const bf16* dog = dout + (long long)b * N * C + h * kD;
  const uint8_t* mg = keep ? keep + (long long)bh * N * N : nullptr;
  const bool vec = (N & 7) == 0;
  const uint32_t sQ = smem_u32(smem), sdO = sQ + kBwdRows * kRowBytes;
  const uint32_t sK = sdO + kBwdRows * kRowBytes, sV = sK + 2 * kTileBytes;
  uint8_t* sM = smem + 2 * kBwdRows * kRowBytes + 4 * kTileBytes;
  float* sD = reinterpret_cast<float*>(sM + 2 * kBwdMask);
  const int tiles = (N + kTile - 1) / kTile;

  load_rows<kBwdRows, kBwdThreads>(sQ, qg, sn, q0, N);
  load_rows<kBwdRows, kBwdThreads>(sdO, dog, C, q0, N);
  load_rows<kTile, kBwdThreads>(sK, kg, sn, 0, N);
  load_rows<kTile, kBwdThreads>(sV, vg, sn, 0, N);
  if (mg) load_keep<kBwdRows, kBwdThreads>(sM, mg, N, q0, 0, vec);
  cp_async_commit();

  {  // D = rowsum(dO o O) of the block's rows: two threads a row, 32 dims each
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, row = q0 + r;
    float d = 0.f;
    if (row < N) {
      const bf16* dp = dog + row * C + half * 32;
      const float* op = o32 + ((long long)b * N + row) * C + h * kD + half * 32;
#pragma unroll
      for (int k = 0; k < 32; k += 8) {
        const uint4 u = *reinterpret_cast<const uint4*>(dp + k);
        const float4 a0 = *reinterpret_cast<const float4*>(op + k);
        const float4 a1 = *reinterpret_cast<const float4*>(op + k + 4);
        const __nv_bfloat162* w = reinterpret_cast<const __nv_bfloat162*>(&u);
        const float2 f0 = __bfloat1622float2(w[0]), f1 = __bfloat1622float2(w[1]);
        const float2 f2 = __bfloat1622float2(w[2]), f3 = __bfloat1622float2(w[3]);
        d += f0.x * a0.x + f0.y * a0.y + f1.x * a0.z + f1.y * a0.w;
        d += f2.x * a1.x + f2.y * a1.y + f3.x * a1.z + f3.y * a1.w;
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      sD[r] = d;
      if (row < N) dlt[(long long)bh * N + row] = d;
    }
  }
  float lr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lr[r] = row < N ? lse[(long long)bh * N + row] : INFINITY;
  }

  uint32_t qa[4][4], da[4][4];
  float Dr[2];
  float dq[8][4] = {};
  for (int j = 0; j < tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < tiles) {
      const int k1 = (j + 1) * kTile;
      load_rows<kTile, kBwdThreads>(sK + (st ^ 1) * kTileBytes, kg, sn, k1, N);
      load_rows<kTile, kBwdThreads>(sV + (st ^ 1) * kTileBytes, vg, sn, k1, N);
      if (mg) load_keep<kBwdRows, kBwdThreads>(sM + (st ^ 1) * kBwdMask, mg, N, q0, k1, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (j == 0) {
      load_a(qa, sQ, warp * 16, lane);
      load_a(da, sdO, warp * 16, lane);
      Dr[0] = sD[warp * 16 + g];
      Dr[1] = sD[warp * 16 + g + 8];
    }
    const int k0 = j * kTile;
    const uint32_t sKs = sK + st * kTileBytes, sVs = sV + st * kTileBytes;
    const uint8_t* mrow = sM + st * kBwdMask + (warp * 16 + g) * kPitch + 2 * t;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {  // keys 32 hf.. of the tile
      float s[4][4] = {}, dp[4][4] = {};
      gemm_abt<4>(s, qa, sKs, 32 * hf, lane);
      gemm_abt<4>(dp, da, sVs, 32 * hf, lane);
#pragma unroll
      for (int jt = 0; jt < 4; ++jt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int kc = 32 * hf + jt * 8;
          float ks0 = 1.f, ks1 = 1.f;
          if (mg) {
            const uint16_t w = *reinterpret_cast<const uint16_t*>(mrow + r * 8 * kPitch + kc);
            ks0 = (w & 0xff) ? keep_scale : 0.f;
            ks1 = (w >> 8) ? keep_scale : 0.f;
          }
          const int key = k0 + kc + 2 * t;
          const float p0 = key < N ? ex2(fmaf(s[jt][2 * r], c, -lr[r])) : 0.f;
          const float p1 = key + 1 < N ? ex2(fmaf(s[jt][2 * r + 1], c, -lr[r])) : 0.f;
          s[jt][2 * r] = p0 * (dp[jt][2 * r] * ks0 - Dr[r]);
          s[jt][2 * r + 1] = p1 * (dp[jt][2 * r + 1] * ks1 - Dr[r]);
        }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t a[3][4];
        to_a3<4>(a, s, kk);
        gemm_ab<3>(dq, a, 32 * hf + 16 * kk, sKs, lane);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= N) continue;
    bf16* out = dqkv + ((long long)b * N + row) * 3 * C + h * kD;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(out + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(dq[dt][2 * r] * scale, dq[dt][2 * r + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// backward, dK/dV pass: grid (ceil(N / 64), B * H), 4 warps; warp w owns
// keys 16w.. of the block and walks every query tile (scores transposed).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kBwdThreads, 3)
    mha64_bwd_dkv_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ keep,
                         const bf16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ dlt, bf16* __restrict__ dqkv, int H, int N,
                         long long sb, long long sn, float c, float scale, float keep_scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * kBwdRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int tid = threadIdx.x;
  const long long C = (long long)H * kD;
  const bf16* qg = qkv + b * sb + h * kD;
  const bf16* kg = qg + C;
  const bf16* vg = qg + 2 * C;
  const bf16* dog = dout + (long long)b * N * C + h * kD;
  const uint8_t* mg = keep ? keep + (long long)bh * N * N : nullptr;
  const float* lg = lse + (long long)bh * N;
  const float* dg = dlt + (long long)bh * N;
  const bool vec = (N & 7) == 0;
  const uint32_t sK = smem_u32(smem), sV = sK + kBwdRows * kRowBytes;
  const uint32_t sQ = sV + kBwdRows * kRowBytes, sdO = sQ + 2 * kTileBytes;
  uint8_t* sM = smem + 2 * kBwdRows * kRowBytes + 4 * kTileBytes;
  float* sL = reinterpret_cast<float*>(sM + 2 * kBwdMask);  // [2][kTile] lse, then [2][kTile] D
  float* sDl = sL + 2 * kTile;
  const int tiles = (N + kTile - 1) / kTile;

  load_rows<kBwdRows, kBwdThreads>(sK, kg, sn, k0, N);
  load_rows<kBwdRows, kBwdThreads>(sV, vg, sn, k0, N);
  load_rows<kTile, kBwdThreads>(sQ, qg, sn, 0, N);
  load_rows<kTile, kBwdThreads>(sdO, dog, C, 0, N);
  if (mg) load_keep<kTile, kBwdThreads>(sM, mg, N, 0, k0, vec);
  cp_async_commit();
  // the lse (+inf past N: probability 0) and D of query tile 0; thread i <
  // 64 one lse, thread 64 + i one D
  static_assert(kBwdThreads == 2 * kTile, "one lse or D a thread");
  {
    const int i = tid & (kTile - 1);
    if (tid < kTile) sL[i] = i < N ? lg[i] : INFINITY;
    else sDl[i] = i < N ? dg[i] : 0.f;
  }

  float dk[8][4] = {}, dv[8][4] = {};
  for (int it = 0; it < tiles; ++it) {
    const int st = it & 1;
    float pre = 0.f;
    if (it + 1 < tiles) {
      const int q1 = (it + 1) * kTile;
      load_rows<kTile, kBwdThreads>(sQ + (st ^ 1) * kTileBytes, qg, sn, q1, N);
      load_rows<kTile, kBwdThreads>(sdO + (st ^ 1) * kTileBytes, dog, C, q1, N);
      if (mg) load_keep<kTile, kBwdThreads>(sM + (st ^ 1) * kBwdMask, mg, N, q1, k0, vec);
      const int q = q1 + (tid & (kTile - 1));
      pre = tid < kTile ? (q < N ? lg[q] : INFINITY) : (q < N ? dg[q] : 0.f);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const uint32_t sQs = sQ + st * kTileBytes, sdOs = sdO + st * kTileBytes;
    const float* L = sL + st * kTile;
    const float* Dl = sDl + st * kTile;
    // mask bytes of (query ql, key row kl): rows of the tile are queries
    const uint8_t* mcol = sM + st * kBwdMask + warp * 16 + g;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {  // queries 32 hf.. of the tile
      float s[4][4] = {}, dp[4][4] = {};
      {
        uint32_t a[4][4];
        load_a(a, sK, warp * 16, lane);
        gemm_abt<4>(s, a, sQs, 32 * hf, lane);
        load_a(a, sV, warp * 16, lane);
        gemm_abt<4>(dp, a, sdOs, 32 * hf, lane);
      }
#pragma unroll
      for (int jt = 0; jt < 4; ++jt) {
        const int ql = 32 * hf + jt * 8 + 2 * t;
        const float2 lv = *reinterpret_cast<const float2*>(L + ql);
        const float2 dv2 = *reinterpret_cast<const float2*>(Dl + ql);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = ql + (e & 1), r = e >> 1;
          const float p = ex2(fmaf(s[jt][e], c, -((e & 1) ? lv.y : lv.x)));
          const float ks = mg ? (mcol[q * kPitch + 8 * r] ? keep_scale : 0.f) : 1.f;
          s[jt][e] = p * ks;
          dp[jt][e] = p * (dp[jt][e] * ks - ((e & 1) ? dv2.y : dv2.x));
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t a[1][4];
        to_a<4>(a, s, kk);
        gemm_ab<1>(dv, a, 32 * hf + 16 * kk, sdOs, lane);
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t a[3][4];
        to_a3<4>(a, dp, kk);
        gemm_ab<3>(dk, a, 32 * hf + 16 * kk, sQs, lane);
      }
    }
    if (it + 1 < tiles) {
      if (tid < kTile) sL[(st ^ 1) * kTile + tid] = pre;
      else sDl[(st ^ 1) * kTile + (tid - kTile)] = pre;
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + warp * 16 + g + 8 * r;
    if (row >= N) continue;
    bf16* out = dqkv + ((long long)b * N + row) * 3 * C + h * kD;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const int col = dt * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(out + C + col) =
          __floats2bfloat162_rn(dk[dt][2 * r] * scale, dk[dt][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(out + 2 * C + col) =
          __floats2bfloat162_rn(dv[dt][2 * r], dv[dt][2 * r + 1]);
    }
  }
}

template <typename F>
cudaError_t allow_smem(F* fn, int bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool bad_shape(int B, int H, int N) { return N < 1 || H < 1 || B < 1 || B * H > 65535; }

}  // namespace

// qkv: (B, N, 3, H, 64) bf16 with strides (sb, sn, ., 64, 1) in elements,
// every row 16-byte aligned; keep: null, or a contiguous (B, H, N, N) bool
// (one byte a score); o: contiguous (B, N, H * 64) bf16; o32: null, or as o
// in fp32; lse: null, or contiguous (B, H, N) fp32 (log2 units). scale is
// 64^-1/2; keep_scale 1 / (1 - p). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape it cannot grid.
extern "C" int hdf_mha64_fwd(const void* qkv, const void* keep, void* o, void* o32, void* lse,
                             int B, int H, int N, long long sb, long long sn, float scale,
                             float keep_scale, void* stream) {
  if (bad_shape(B, H, N)) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(mha64_fwd_kernel, kFwdSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + kFwdRows - 1) / kFwdRows, B * H);
  mha64_fwd_kernel<<<grid, kFwdThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const uint8_t*>(keep), static_cast<bf16*>(o),
      static_cast<float*>(o32), static_cast<float*>(lse), H, N, sb, sn,
      scale * 1.4426950408889634f, keep_scale);
  return (int)cudaGetLastError();
}

// The backward: qkv, keep, scale and keep_scale as the forward's; dout:
// contiguous (B, N, H * 64) bf16; o32 and lse: the forward's; dlt: scratch
// (B, H, N) fp32 for D; dqkv: contiguous (B, N, 3, H, 64) bf16, every element
// written. Two launches on `stream`: dQ (and D), then dK and dV.
extern "C" int hdf_mha64_bwd(const void* qkv, const void* keep, const void* dout,
                             const void* o32, const void* lse, void* dlt, void* dqkv, int B,
                             int H, int N, long long sb, long long sn, float scale,
                             float keep_scale, void* stream) {
  if (bad_shape(B, H, N)) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(mha64_bwd_dq_kernel, kDqSmem);
  if (e == cudaSuccess) e = allow_smem(mha64_bwd_dkv_kernel, kDkvSmem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float c = scale * 1.4426950408889634f;
  const dim3 grid((N + kBwdRows - 1) / kBwdRows, B * H);
  mha64_bwd_dq_kernel<<<grid, kBwdThreads, kDqSmem, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const uint8_t*>(keep),
      static_cast<const bf16*>(dout), static_cast<const float*>(o32),
      static_cast<const float*>(lse), static_cast<float*>(dlt), static_cast<bf16*>(dqkv), H, N,
      sb, sn, c, scale, keep_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mha64_bwd_dkv_kernel<<<grid, kBwdThreads, kDkvSmem, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const uint8_t*>(keep),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dlt), static_cast<bf16*>(dqkv), H, N, sb, sn, c, scale,
      keep_scale);
  return (int)cudaGetLastError();
}
