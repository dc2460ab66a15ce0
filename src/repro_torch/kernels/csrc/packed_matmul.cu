// packed_matmul.cu: the integer GEMM on two int16 K-lanes per 32-bit word.
//
// Replaces: src/repro/kernels/packed_matmul.py `_kernel` (pallas_call at
// :100, entry packed_matmul_pallas at :114; packing in pack_i16_pairs at
// :41).  This is the `inject` body of the `draft` tier: the quantized
// exact GEMM, to which the moment-matched noise is added outside the
// kernel (src/repro/engine/modes.py:329).
//
// Computes out[m, j] = sum_w even(A[m,w]) * even(B[w,j]) + odd(A[m,w]) *
// odd(B[w,j]) over (M, K/2) x (K/2, N) words, where even() is the low
// 16 bits and odd() the high 16 bits, both sign-extended.
//
// Design.  Hopper has no int16 tensor-core product, so this first kernel
// multiplies on the integer ALUs (one IMAD per lane pair); splitting the
// lanes into int8 halves for the int8 tensor cores is later work.  Lanes
// are unpacked once per element when a tile is staged in shared memory,
// not once per product.  The grid and tiling follow lut_matmul.cu: grid
// over (N-tile, M-tile), the K loop inside the block, one output column
// and BM/4 rows per thread.  Pad words are 0 (two zero lanes) and add 0.
//
// Exactness.  Lane values satisfy |q| <= 2^n - 1 (n <= 15), so each lane
// product is below 2^30; sums are kept in int32 when K * (2^n - 1)^2 < 2^31
// and in int64 otherwise, and converted to float32 once.  The plain
// version computes the same integer sums exactly (float64 products of
// integers below 2^53), so the two are bit-equal; the JAX reference's
// float32 dots are exact only while |sum| < 2^24.
//
// Bound on the H100.  Per output M*K/2 words of A and K/2*N of B are read
// once, and M*K*N integer multiply-adds run at the int32 issue rate.  At
// decode the N/64 blocks leave most SMs idle; at prefill the kernel is
// bounded by the IMAD rate of the SMs it occupies.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;
constexpr int kBK = 32;  // packed words per step (64 K-lanes)
constexpr int kRowGroups = kThreads / kBN;

__device__ __forceinline__ int lane_even(int32_t w) {
  return int(int16_t(uint16_t(uint32_t(w) & 0xFFFFu)));
}

__device__ __forceinline__ int lane_odd(int32_t w) {
  return int(int16_t(uint16_t(uint32_t(w) >> 16)));
}

template <int BM, typename Acc>
__global__ void __launch_bounds__(kThreads)
packed_matmul_kernel(const int32_t* __restrict__ pa, const int32_t* __restrict__ pb,
                     float* __restrict__ out, int M, int N, int KW) {
  constexpr int TM = BM / kRowGroups;
  __shared__ int a_even[BM * kBK];
  __shared__ int a_odd[BM * kBK];
  __shared__ int b_even[kBK * kBN];
  __shared__ int b_odd[kBK * kBN];

  const int tx = threadIdx.x % kBN;
  const int ty = threadIdx.x / kBN;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * kBN;
  Acc acc[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) acc[i] = 0;

  for (int k0 = 0; k0 < KW; k0 += kBK) {
    __syncthreads();
    for (int i = threadIdx.x; i < BM * kBK; i += kThreads) {
      const int r = row0 + i / kBK, k = k0 + i % kBK;
      const int32_t w = (r < M && k < KW) ? pa[size_t(r) * KW + k] : 0;
      a_even[i] = lane_even(w);
      a_odd[i] = lane_odd(w);
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int k = k0 + i / kBN, c = col0 + i % kBN;
      const int32_t w = (k < KW && c < N) ? pb[size_t(k) * N + c] : 0;
      b_even[i] = lane_even(w);
      b_odd[i] = lane_odd(w);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const int be = b_even[kk * kBN + tx];
      const int bo = b_odd[kk * kBN + tx];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = (ty * TM + i) * kBK + kk;
        acc[i] += Acc(a_even[r] * be) + Acc(a_odd[r] * bo);
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
cudaError_t launch(const void* pa, const void* pb, void* out, int M, int N, int KW,
                   cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM);
  packed_matmul_kernel<BM, Acc><<<grid, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(pa), static_cast<const int32_t*>(pb),
      static_cast<float*>(out), M, N, KW);
  return cudaGetLastError();
}

template <typename Acc>
cudaError_t launch_acc(const void* pa, const void* pb, void* out, int M, int N, int KW,
                       int bm, cudaStream_t s) {
  if (bm == 4) return launch<4, Acc>(pa, pb, out, M, N, KW, s);
  if (bm == 16) return launch<16, Acc>(pa, pb, out, M, N, KW, s);
  if (bm == 64) return launch<64, Acc>(pa, pb, out, M, N, KW, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int packed_matmul_launch(const void* pa, const void* pb, void* out, int M, int N,
                                    int KW, int bm, int wide_acc, int device, void* stream) {
  if (M < 1 || N < 1 || KW < 0 || (bm != 4 && bm != 16 && bm != 64) ||
      (M + bm - 1) / bm > 65535) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const auto s = static_cast<cudaStream_t>(stream);
  err = wide_acc ? launch_acc<long long>(pa, pb, out, M, N, KW, bm, s)
                 : launch_acc<int>(pa, pb, out, M, N, KW, bm, s);
  return int(err);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
