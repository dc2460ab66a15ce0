// seqmul_matmul.cu: the paper's split-word recurrence itself as a GEMM.
//
// Replaces: src/repro/kernels/seqmul_matmul.py `_kernel` (pallas_call at
// :116, entry seqmul_matmul_pallas at :132).
//
// Computes out[m, j] = sum_k sa[m,k] * sb[k,j] * P(ma[m,k], mb[k,j]) where
// P is the n-cycle sequential product with the accumulator split at t
// (approximate: the LSP carry-out is deferred one cycle; fix_to_1 forces
// product bits [0, n+t) to 1 after a final-cycle carry), assembled as
// lo + 2^(n-1) * (s_lsp + 2^t * s_msp).  Magnitudes int16 (n <= 12), signs
// int8.  No table: any n <= 12.
//
// Design.  The same tiling as lut_matmul.cu without the table: the grid
// covers (N-tile, M-tile), each block walks all of K in steps of kBK with
// both operands' magnitudes and signs staged in shared memory, and each
// thread owns one output column and BM/4 rows.  seqmul_product() below runs
// the recurrence of src/repro_torch/engine/recurrence.py (a line-for-line
// port of src/repro/engine/recurrence.py) on one 32-bit word W that holds
// s_lsp in bits [0, t) and s_msp from bit t up.  Then the augend
// S^{j-1} >> 1 is W >> 1 (the MSP's LSB lands in bit t-1 by itself), the
// exact cycle is s = aug + m, the LSP carry-out is bit t of s ^ aug ^ m,
// and the approximate cycle takes that carry back out and adds the one
// deferred from the cycle before.  tests/test_torch_numerics.py holds a
// copy of this form equal to the recurrence for every (a, b) at n <= 8 and
// on random pairs at n = 12, for every t, approx and fix_to_1.  The chip
// smoke holds this kernel bit-equal to its plain version on the card.
// Every word stays below 2^(n+2) and the product
// below 2^24 for n <= 12.  Pad lanes carry magnitude 0 and sign 0: 0 * 0
// never produces an LSP carry, so fix_to_1 cannot fire on them, and their
// sign 0 adds 0 either way.
//
// Exactness.  Products and sums are integers, accumulated in int32 when
// K * (2^(2n) - 1) < 2^31 and in int64 otherwise (n = 12 needs int64 at
// any K past 128), converted to float32 once.  The plain version sums the
// same integers in int64, so the two are bit-equal; the JAX reference sums
// in float32 and is exact only while |sum| < 2^24.
//
// Bound on the H100.  Integer ALU work, not tensor cores.  The least an
// approximate product needs, one Hopper instruction each (IADD3 and LOP3
// take three inputs; per-a terms, masks and the cycle loop unrolled away):
// 8 per cycle (W >> 1, bit j of b, select a, s = aug + m, s ^ aug ^ m, its
// bit t, W = s - c + c_prev, a funnel shift of s's LSB into lo) and 7 per
// product (shift lo into place, the fix_to_1 test and its two predicated
// writes, lo + (W << (n-1)), the sign product, the accumulate): 8n + 7,
// at 64 int32 lanes per clock per SM (chip_smoke.py).  This kernel runs
// more than that (the loop over a runtime n, the bit test as shift and
// mask); at decode the grid has N/64 blocks, fewer than the 132 SMs.
// Split-K and unrolling over a compile-time n are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kRowGroups = kThreads / kBN;

__device__ __forceinline__ int seqmul_product(unsigned a, unsigned b, int n, int t,
                                              bool approx, bool fix_to_1) {
  const unsigned bit_t = 1u << t;
  unsigned w = 0u, c_prev = 0u, lo = 0u;
  for (int j = 0; j < n; ++j) {
    const unsigned aug = w >> 1;  // S^{j-1} >> 1, across the split
    const unsigned m = ((b >> j) & 1u) ? a : 0u;
    const unsigned s = aug + m;                 // the exact cycle
    const unsigned c = (s ^ aug ^ m) & bit_t;   // this cycle's LSP carry-out, at bit t
    w = approx ? s - c + c_prev : s;            // approximate: defer it one cycle
    c_prev = c;
    lo |= (s & 1u) << j;
  }
  const unsigned lo_mask = n > 1 ? (1u << (n - 1)) - 1u : 0u;
  lo &= lo_mask;
  if (approx && fix_to_1 && c_prev) {
    lo = lo_mask;
    w |= (bit_t << 1) - 1u;  // s_lsp = 2^t - 1, s_msp |= 1
  }
  return int(lo + (w << (n - 1)));
}

template <int BM, typename Acc>
__global__ void __launch_bounds__(kThreads)
seqmul_matmul_kernel(const int16_t* __restrict__ mag_a, const int8_t* __restrict__ sign_a,
                     const int16_t* __restrict__ mag_b, const int8_t* __restrict__ sign_b,
                     float* __restrict__ out, int M, int N, int K, int n, int t, int approx,
                     int fix_to_1) {
  constexpr int TM = BM / kRowGroups;
  __shared__ int a_mag[BM * kBK];
  __shared__ int b_mag[kBK * kBN];
  __shared__ int8_t a_sgn[BM * kBK];
  __shared__ int8_t b_sgn[kBK * kBN];

  const int tx = threadIdx.x % kBN;
  const int ty = threadIdx.x / kBN;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * kBN;
  const bool ap = approx != 0, fix = fix_to_1 != 0;
  Acc acc[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) acc[i] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();
    for (int i = threadIdx.x; i < BM * kBK; i += kThreads) {
      const int r = row0 + i / kBK, k = k0 + i % kBK;
      int mag = 0, sg = 0;
      if (r < M && k < K) {
        const size_t off = size_t(r) * K + k;
        mag = mag_a[off];
        sg = sign_a[off];
      }
      a_mag[i] = mag;
      a_sgn[i] = int8_t(sg);
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int k = k0 + i / kBN, c = col0 + i % kBN;
      int mag = 0, sg = 0;
      if (k < K && c < N) {
        const size_t off = size_t(k) * N + c;
        mag = mag_b[off];
        sg = sign_b[off];
      }
      b_mag[i] = mag;
      b_sgn[i] = int8_t(sg);
    }
    __syncthreads();
    for (int kk = 0; kk < kBK; ++kk) {
      const unsigned b_val = unsigned(b_mag[kk * kBN + tx]);
      const int bs = b_sgn[kk * kBN + tx];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = ty * TM + i;
        const int prod = seqmul_product(unsigned(a_mag[r * kBK + kk]), b_val, n, t, ap, fix);
        acc[i] += Acc(a_sgn[r * kBK + kk] * bs) * Acc(prod);
      }
    }
  }
  const int col = col0 + tx;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r < M && col < N) out[size_t(r) * N + col] = float(acc[i]);
  }
}

template <int BM, typename Acc>
cudaError_t launch(const void* ma, const void* sa, const void* mb, const void* sb, void* out,
                   int M, int N, int K, int n, int t, int approx, int fix_to_1,
                   cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM);
  seqmul_matmul_kernel<BM, Acc><<<grid, kThreads, 0, stream>>>(
      static_cast<const int16_t*>(ma), static_cast<const int8_t*>(sa),
      static_cast<const int16_t*>(mb), static_cast<const int8_t*>(sb),
      static_cast<float*>(out), M, N, K, n, t, approx, fix_to_1);
  return cudaGetLastError();
}

template <typename Acc>
cudaError_t launch_acc(const void* ma, const void* sa, const void* mb, const void* sb,
                       void* out, int M, int N, int K, int n, int t, int approx,
                       int fix_to_1, int bm, cudaStream_t s) {
  if (bm == 4) return launch<4, Acc>(ma, sa, mb, sb, out, M, N, K, n, t, approx, fix_to_1, s);
  if (bm == 16) return launch<16, Acc>(ma, sa, mb, sb, out, M, N, K, n, t, approx, fix_to_1, s);
  if (bm == 64) return launch<64, Acc>(ma, sa, mb, sb, out, M, N, K, n, t, approx, fix_to_1, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int seqmul_matmul_launch(const void* mag_a, const void* sign_a, const void* mag_b,
                                    const void* sign_b, void* out, int M, int N, int K, int n,
                                    int t, int approx, int fix_to_1, int bm, int wide_acc, int device,
                                    void* stream) {
  const bool t_ok = (n == 1) ? (t == 1) : (t >= 1 && t <= n - 1);
  if (n < 1 || n > 12 || !t_ok || M < 1 || N < 1 || K < 0 || (bm != 4 && bm != 16 && bm != 64) ||
      (M + bm - 1) / bm > 65535)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const auto s = static_cast<cudaStream_t>(stream);
  err = wide_acc
            ? launch_acc<long long>(mag_a, sign_a, mag_b, sign_b, out, M, N, K, n, t, approx,
                                    fix_to_1, bm, s)
            : launch_acc<int>(mag_a, sign_a, mag_b, sign_b, out, M, N, K, n, t, approx,
                              fix_to_1, bm, s);
  return int(err);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
