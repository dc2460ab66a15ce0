// seqmul_kernel.cu: the paper's sequential multiplier as an elementwise pass.
//
// Replaces: src/repro/kernels/seqmul_kernel.py `_kernel` (:33; pallas_call at
// :93, entry seqmul_pallas at :150) with seqmul_packed_kernel, and
// `_words_kernel` (:54; pallas_call at :132, entry seqmul_pallas_words at
// :182) with seqmul_words_kernel.
//
// Computes, for every element i of two uint32 arrays with values in [0, 2^n),
// the n-cycle sequential product of a[i] and b[i] with the accumulator split
// at t (approximate: the LSP carry-out is deferred one cycle; fix_to_1 forces
// product bits [0, n+t) to 1 after a final-cycle carry; exact: the carry is
// consumed in its own cycle).  seqmul_packed_kernel writes the packed product
// lo + 2^(n-1) * (s_lsp + 2^t * s_msp), which needs 2n <= 31;
// seqmul_words_kernel writes low = product bits [0, n) and high = bits
// [n, 2n], as `_split_words` of the reference does, for n <= 16.
//
// Design.  The TPU kernel pads the flattened arrays to (rows, 128) tiles of
// its vector unit.  Here the pass is flat and pads nothing: each thread owns
// four consecutive elements, read as one 16-byte load per operand (and
// written as one 16-byte store per output) when every pointer is 16-byte
// aligned; the grid has ceil(len / 4) threads, and the last one takes the
// ragged tail an element at a time (so does every thread when a pointer is
// not aligned).  The recurrence is the one-word form of seqmul_product in
// seqmul_matmul.cu, which tests/test_torch_numerics.py holds equal to the
// port's recurrence: one 32-bit word W holds s_lsp in bits [0, t) and s_msp
// from bit t up, so S^{j-1} >> 1 is W >> 1, the exact cycle is s = aug + m,
// the LSP carry-out is bit t of s ^ aug ^ m, and the approximate cycle takes
// that carry back out and adds the one deferred from the cycle before.
// W < 2^(n+2) (s = s_lsp + 2^t s_msp is at most n+2 bits), so at 2n <= 31
// the packed word lo + (W << (n-1)) never wraps, and for the two-word form
// low = lo | (W & 1) << (n-1), high = W >> 1 hold for any n <= 16.  approx
// and fix_to_1 are template parameters, n and t runtime values.  A launch
// runs on the caller's stream and does not synchronise.
//
// Bound on the H100.  Integer ALU work: a product needs at least 8 int32
// operations per cycle and 7 around the loop (the count of seqmul_matmul.cu,
// chip_smoke.seqmul_ops_per_product), 8n + 7 at 64 int32 lanes per clock per
// SM, against 12 bytes (packed: two reads, one write) or 16 (words) per
// element at 3.35 TB/s.  The card does about 5 int32 operations in the time
// it moves one byte, so the operations bound from n = 7 (packed) and n = 9
// (words) up, the bytes below.  This kernel runs more than 8 operations a
// cycle (the loop over a runtime n, the bit test as shift and mask);
// unrolling over a compile-time n is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;  // one uint4 of each operand

// The product of a and b as (lo, w): lo holds product bits [0, n-1), w the
// final accumulator s_lsp + 2^t * s_msp (product bits [n-1, 2n]).
template <bool APPROX, bool FIX>
__device__ __forceinline__ void seqmul_one(unsigned a, unsigned b, int n, int t, unsigned& lo,
                                           unsigned& w) {
  const unsigned bit_t = 1u << t;
  unsigned c_prev = 0u;
  lo = 0u;
  w = 0u;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const unsigned aug = w >> 1;  // S^{j-1} >> 1, across the split
    const unsigned m = ((b >> j) & 1u) ? a : 0u;
    const unsigned s = aug + m;  // the exact cycle
    if (APPROX) {
      const unsigned c = (s ^ aug ^ m) & bit_t;  // this cycle's LSP carry-out, at bit t
      w = s - c + c_prev;                        // deferred one cycle
      c_prev = c;
    } else {
      w = s;
    }
    lo |= (s & 1u) << j;
  }
  const unsigned lo_mask = n > 1 ? (1u << (n - 1)) - 1u : 0u;
  lo &= lo_mask;
  if (APPROX && FIX && c_prev) {
    lo = lo_mask;
    w |= (bit_t << 1) - 1u;  // s_lsp = 2^t - 1, s_msp |= 1
  }
}

template <bool APPROX, bool FIX>
__device__ __forceinline__ unsigned packed_product(unsigned a, unsigned b, int n, int t) {
  unsigned lo, w;
  seqmul_one<APPROX, FIX>(a, b, n, t, lo, w);
  return lo + (w << (n - 1));
}

template <bool APPROX, bool FIX>
__device__ __forceinline__ void words_product(unsigned a, unsigned b, int n, int t,
                                              unsigned& low, unsigned& high) {
  unsigned lo, w;
  seqmul_one<APPROX, FIX>(a, b, n, t, lo, w);
  low = lo | ((w & 1u) << (n - 1));
  high = w >> 1;
}

__device__ __forceinline__ long long first_element() {
  return (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kPerThread;
}

template <bool APPROX, bool FIX>
__global__ void __launch_bounds__(kThreads)
seqmul_packed_kernel(const unsigned* __restrict__ a, const unsigned* __restrict__ b,
                     unsigned* __restrict__ out, long long len, int n, int t, bool vec) {
  const long long i0 = first_element();
  if (i0 >= len) return;
  if (vec && i0 + kPerThread <= len) {
    const uint4 av = *reinterpret_cast<const uint4*>(a + i0);
    const uint4 bv = *reinterpret_cast<const uint4*>(b + i0);
    uint4 ov;
    ov.x = packed_product<APPROX, FIX>(av.x, bv.x, n, t);
    ov.y = packed_product<APPROX, FIX>(av.y, bv.y, n, t);
    ov.z = packed_product<APPROX, FIX>(av.z, bv.z, n, t);
    ov.w = packed_product<APPROX, FIX>(av.w, bv.w, n, t);
    *reinterpret_cast<uint4*>(out + i0) = ov;
    return;
  }
  for (long long i = i0; i < len && i < i0 + kPerThread; ++i)
    out[i] = packed_product<APPROX, FIX>(a[i], b[i], n, t);
}

template <bool APPROX, bool FIX>
__global__ void __launch_bounds__(kThreads)
seqmul_words_kernel(const unsigned* __restrict__ a, const unsigned* __restrict__ b,
                    unsigned* __restrict__ low, unsigned* __restrict__ high, long long len,
                    int n, int t, bool vec) {
  const long long i0 = first_element();
  if (i0 >= len) return;
  if (vec && i0 + kPerThread <= len) {
    const uint4 av = *reinterpret_cast<const uint4*>(a + i0);
    const uint4 bv = *reinterpret_cast<const uint4*>(b + i0);
    uint4 lv, hv;
    words_product<APPROX, FIX>(av.x, bv.x, n, t, lv.x, hv.x);
    words_product<APPROX, FIX>(av.y, bv.y, n, t, lv.y, hv.y);
    words_product<APPROX, FIX>(av.z, bv.z, n, t, lv.z, hv.z);
    words_product<APPROX, FIX>(av.w, bv.w, n, t, lv.w, hv.w);
    *reinterpret_cast<uint4*>(low + i0) = lv;
    *reinterpret_cast<uint4*>(high + i0) = hv;
    return;
  }
  for (long long i = i0; i < len && i < i0 + kPerThread; ++i)
    words_product<APPROX, FIX>(a[i], b[i], n, t, low[i], high[i]);
}

unsigned blocks_for(long long len) {
  const long long threads = (len + kPerThread - 1) / kPerThread;
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool valid_split(int n, int t) { return n == 1 ? t == 1 : (t >= 1 && t <= n - 1); }

template <bool APPROX, bool FIX>
cudaError_t launch_packed(const void* a, const void* b, void* out, long long len, int n, int t,
                          cudaStream_t stream) {
  const bool vec = aligned16(a) && aligned16(b) && aligned16(out);
  seqmul_packed_kernel<APPROX, FIX><<<blocks_for(len), kThreads, 0, stream>>>(
      static_cast<const unsigned*>(a), static_cast<const unsigned*>(b),
      static_cast<unsigned*>(out), len, n, t, vec);
  return cudaGetLastError();
}

template <bool APPROX, bool FIX>
cudaError_t launch_words(const void* a, const void* b, void* low, void* high, long long len,
                         int n, int t, cudaStream_t stream) {
  const bool vec = aligned16(a) && aligned16(b) && aligned16(low) && aligned16(high);
  seqmul_words_kernel<APPROX, FIX><<<blocks_for(len), kThreads, 0, stream>>>(
      static_cast<const unsigned*>(a), static_cast<const unsigned*>(b),
      static_cast<unsigned*>(low), static_cast<unsigned*>(high), len, n, t, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int seqmul_packed_launch(const void* a, const void* b, void* out, long long len,
                                    int n, int t, int approx, int fix_to_1, int device,
                                    void* stream) {
  if (n < 1 || 2 * n > 31 || !valid_split(n, t) || len < 1 ||
      (len + kPerThread - 1) / kPerThread / kThreads >= (1LL << 31) - 1)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const auto s = static_cast<cudaStream_t>(stream);
  if (!approx) return int(launch_packed<false, false>(a, b, out, len, n, t, s));
  if (fix_to_1) return int(launch_packed<true, true>(a, b, out, len, n, t, s));
  return int(launch_packed<true, false>(a, b, out, len, n, t, s));
}

extern "C" int seqmul_words_launch(const void* a, const void* b, void* low, void* high,
                                   long long len, int n, int t, int approx, int fix_to_1,
                                   int device, void* stream) {
  if (n < 1 || n > 16 || !valid_split(n, t) || len < 1 ||
      (len + kPerThread - 1) / kPerThread / kThreads >= (1LL << 31) - 1)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const auto s = static_cast<cudaStream_t>(stream);
  if (!approx) return int(launch_words<false, false>(a, b, low, high, len, n, t, s));
  if (fix_to_1) return int(launch_words<true, true>(a, b, low, high, len, n, t, s));
  return int(launch_words<true, false>(a, b, low, high, len, n, t, s));
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
