// Space-to-depth half-shift (forward) and its transpose (backward),
// hand-written for Hopper (sm_90a).
//
// Replaces: hdenseformer_tpu/ops/shift_pack.py::_pallas_shift, Pallas bodies
// `_fwd_kernel` (forward) and `_bwd_kernel` (backward), tied together by the
// custom VJP `shift_pack`. The TPU bodies select, per 128-lane chunk, between
// two input planes and 0/-1 sub-shifted copies with lane masks, because a
// TPU vector register is a full (8, 128) tile. None of that carries over.
//
// What it computes, on channels-last tensors with parity-major channels
// (packed channel = p * C + c, p the parity bits of the packed dims in dim
// order, leading dim first):
//   forward  x (N, *g, f*C) -> y (N, *(g+1), f*C):
//            y[n, j][p*C + c] = x[n, j - bits(p)][p*C + c], 0 outside x;
//   backward dy (N, *(g+1), f*C) -> dx (N, *g, f*C):
//            dx[n, j][q*C + c] = dy[n, j + bits(q)][q*C + c], always inside.
// Each output element copies exactly one input element (or is zero): the op
// is a bijective gather with no arithmetic, so the result is bitwise that of
// the plain pad + 2^d slices + concatenate.
//
// What bounds it on this card: HBM bytes. The largest serving call is
// (8, 72^3, 512) bf16: 3.06 GB read and 3.19 GB written, about 1.87 ms at
// 3.35 TB/s (data-sheet estimate; PERF.md holds the measured time).
//
// Design. The kernel never looks at the dtype: it copies V-byte vectors,
// V the widest of 16, 8, 4, 2 bytes that divides one parity block (C
// elements) and both base addresses, so a vector never straddles two blocks
// and every vector of a block comes from the same source cell. C = 32 bf16
// (64 bytes) gives 16-byte accesses; the k7 stem's C = 2 bf16 gives 4.
// Tensors are viewed as 3 spatial dims; a 2-D call adds a leading dim of 1
// that no parity bit touches. One block walks one output row (n, j0, j1):
// all j2 and all channel vectors, which are contiguous in memory, so
// neighbouring threads store neighbouring vectors, and read them from at
// most 2^d contiguous source runs (one per parity block). The zero borders
// of the forward are stored, not skipped, so the output needs no memset.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Dims {
  int n;
  int in[3];   // input spatial dims (a 2-D call has in[0] = 1)
  int out[3];  // output spatial dims
  int nsp;     // packed spatial dims: 2 or 3
  int cv;      // vectors per parity block (C * elem_bytes / V)
};

template <typename V, bool kForward>
__global__ void __launch_bounds__(kThreads)
shift_kernel(const V* __restrict__ x, V* __restrict__ y, Dims d) {
  const int fcv = d.cv << d.nsp;  // vectors per cell
  int r = blockIdx.x;             // output row (n, j0, j1)
  const int j1 = r % d.out[1];
  r /= d.out[1];
  const int j0 = r % d.out[0];
  const int n = r / d.out[0];
  const int row_len = d.out[2] * fcv;
  V* yrow = y + (long long)blockIdx.x * row_len;
  const int first = 3 - d.nsp;  // first packed dim in the 3-D view
  for (int t = threadIdx.x; t < row_len; t += kThreads) {
    const int j2 = t / fcv;
    const int v = t - j2 * fcv;
    const int p = v / d.cv;
    // parity bit of dim k: bit (2 - k) of p, for the packed dims only
    const int b0 = first == 0 ? (p >> 2) & 1 : 0;
    const int b1 = (p >> 1) & 1;
    const int b2 = p & 1;
    int s0, s1, s2;
    if (kForward) {
      s0 = j0 - b0;
      s1 = j1 - b1;
      s2 = j2 - b2;
      if (s0 < 0 || s1 < 0 || s2 < 0 || s0 >= d.in[0] || s1 >= d.in[1] ||
          s2 >= d.in[2]) {
        yrow[t] = V{};
        continue;
      }
    } else {
      s0 = j0 + b0;
      s1 = j1 + b1;
      s2 = j2 + b2;
    }
    const long long src =
        (((long long)n * d.in[0] + s0) * d.in[1] + s1) * d.in[2] + s2;
    yrow[t] = x[src * fcv + v];
  }
}

template <typename V>
int launch(const void* x, void* y, int forward, const Dims& d, cudaStream_t s) {
  const long long rows = (long long)d.n * d.out[0] * d.out[1];
  if (rows == 0 || d.out[2] == 0 || d.cv == 0) return 0;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (forward)
    shift_kernel<V, true><<<(unsigned)rows, kThreads, 0, s>>>(
        static_cast<const V*>(x), static_cast<V*>(y), d);
  else
    shift_kernel<V, false><<<(unsigned)rows, kThreads, 0, s>>>(
        static_cast<const V*>(x), static_cast<V*>(y), d);
  return (int)cudaGetLastError();
}

}  // namespace

// forward: 1 = half-shift x (N, *g, f*C) -> y (N, *(g+1), f*C); 0 = its
// transpose x (N, *(g+1), f*C) -> y (N, *g, f*C). Both contiguous. nsp is 2
// or 3; g0 is ignored (taken as 1) when nsp is 2, and g1, g2 are the input
// dims of the forward and the output dims of the backward. vec_bytes (16, 8,
// 4 or 2) must divide C * elem_bytes and both addresses; cv = C * elem_bytes
// / vec_bytes. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an unsupported vector width or rank.
extern "C" int hdf_shift_pack(const void* x, void* y, int forward, int vec_bytes,
                              int nsp, int N, int g0, int g1, int g2, int cv,
                              void* stream) {
  if (nsp != 2 && nsp != 3) return (int)cudaErrorInvalidValue;
  Dims d;
  d.n = N;
  d.nsp = nsp;
  d.cv = cv;
  const int g[3] = {nsp == 2 ? 1 : g0, g1, g2};
  for (int k = 0; k < 3; ++k) {
    const int grow = (k >= 3 - nsp) ? 1 : 0;  // packed dims gain one cell
    d.in[k] = forward ? g[k] : g[k] + grow;
    d.out[k] = forward ? g[k] + grow : g[k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: return launch<uint4>(x, y, forward, d, s);
    case 8: return launch<uint2>(x, y, forward, d, s);
    case 4: return launch<uint32_t>(x, y, forward, d, s);
    case 2: return launch<uint16_t>(x, y, forward, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
