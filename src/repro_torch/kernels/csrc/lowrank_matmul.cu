// lowrank_matmul.cu: the `lowrank` GEMM, exact product plus the rank-r
// SVD correction of the approximate multiplier's error.
//
// Replaces: src/repro/kernels/lowrank_matmul.py `_kernel` (pallas_call at
// :75, entry lowrank_matmul_pallas at :91).
//
// Computes out[m, j] = float(sum_k a[m,k] * b[k,j])
//                    + sum_k sum_r sa[m,k] U[|a[m,k]|, r] * sb[k,j] V[|b[k,j]|, r]
// for sign-magnitude operands (magnitudes uint8, signs int8 in {-1, 0, 1},
// a = sa * |a|), with U, V the (2^n, rank) float32 SVD factors of the error
// table (n <= 8).  This is the reference's `A@B + Ue' @ Ve'` with Ue' =
// sa * U[|a|] (M, K*r) and Ve' = sb * V[|b|] (K*r, N).
//
// Design.  The reference gathers Ve' as a (K, N, r) float32 tensor in
// device memory before the kernel (100 MB per call at qwen3's (3072, 1024)
// down projection, r = 8).  Here both tables (8 KiB each at n = 8, r = 8)
// are copied once per block into shared memory, and the block gathers
// U[|a|] and V[|b|] itself for each K step, so the kernel reads only the
// int8 magnitudes and signs.  The grid covers (N-tile, M-tile); each block
// walks the whole K axis itself in steps of kBK, staging the signed
// integers and the gathered, signed embeddings of both operands in shared
// memory.  Each of the 256 threads owns one output column and BM/4 rows; a
// warp reads one A-side value (broadcast) and 32 consecutive B-side values
// (no bank conflict) per step.
//
// Sums.  The exact part is an integer, summed in int32 while
// K * (2^n - 1)^2 < 2^31 and in int64 beyond (the host picks), and
// converted to float32 once, as the port's other integer GEMMs do
// (PERF.md, "Integer accumulation").  The correction is summed in float32
// over k, then r.  The plain version (kernels/lowrank_matmul.py) computes
// the same split, with the correction's float32 sums in another order.
//
// Bound on the H100.  The operands are a few MB of int8, so the work
// bounds it: 2 * M * K * N * r float32 FLOPs for the correction (the exact
// part fits the int8 tensor cores' rate and costs little beside it).  At
// decode (M = 4) the grid has N/64 blocks (16..48 of 132 SMs) and each
// walks all of K, so this first kernel sits far from that bound; split-K
// and tensor-core tiles are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;  // output columns per block, one per thread column
constexpr int kBK = 16;  // K extent staged in shared memory per step
constexpr int kRowGroups = kThreads / kBN;

// bytes of dynamic shared memory at row tile bm (kept in step with
// engine/config.py `_lowrank_smem_bytes`)
__host__ __device__ constexpr size_t smem_bytes(int bm, int side, int rank) {
  return 4 * (size_t(2) * side * rank + size_t(bm) * kBK + size_t(kBK) * kBN +
              size_t(bm) * kBK * rank + size_t(kBK) * rank * kBN);
}

template <int BM, typename Acc>
__global__ void __launch_bounds__(kThreads)
lowrank_matmul_kernel(const float* __restrict__ u, const float* __restrict__ v,
                      const uint8_t* __restrict__ mag_a, const int8_t* __restrict__ sign_a,
                      const uint8_t* __restrict__ mag_b, const int8_t* __restrict__ sign_b,
                      float* __restrict__ out, int M, int N, int K, int n, int rank) {
  constexpr int TM = BM / kRowGroups;
  extern __shared__ __align__(16) unsigned char smem[];
  const int side = 1 << n;
  const int qmax = side - 1;
  float* ut = reinterpret_cast<float*>(smem);  // [side][rank]
  float* vt = ut + side * rank;                // [side][rank]
  int* a_val = reinterpret_cast<int*>(vt + side * rank);  // [BM][kBK]
  int* b_val = a_val + BM * kBK;                          // [kBK][kBN]
  float* ue = reinterpret_cast<float*>(b_val + kBK * kBN);  // [BM][kBK][rank]
  float* ve = ue + BM * kBK * rank;                         // [kBK][rank][kBN]

  for (int i = threadIdx.x; i < side * rank; i += kThreads) {
    ut[i] = u[i];
    vt[i] = v[i];
  }

  const int tx = threadIdx.x % kBN;
  const int ty = threadIdx.x / kBN;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * kBN;
  Acc acc[TM];
  float corr[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    acc[i] = 0;
    corr[i] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the tables are in; the previous step's tiles are consumed
    for (int i = threadIdx.x; i < BM * kBK; i += kThreads) {
      const int r = row0 + i / kBK, k = k0 + i % kBK;
      int mag = 0, sg = 0;  // pad lanes: magnitude 0, sign 0 -> add 0
      if (r < M && k < K) {
        const size_t off = size_t(r) * K + k;
        mag = min(int(mag_a[off]), qmax);
        sg = sign_a[off];
      }
      a_val[i] = sg * mag;
      for (int j = 0; j < rank; ++j) ue[i * rank + j] = float(sg) * ut[mag * rank + j];
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, c = i % kBN;
      const int k = k0 + kk, col = col0 + c;
      int mag = 0, sg = 0;
      if (k < K && col < N) {
        const size_t off = size_t(k) * N + col;
        mag = min(int(mag_b[off]), qmax);
        sg = sign_b[off];
      }
      b_val[i] = sg * mag;
      for (int j = 0; j < rank; ++j) ve[(kk * rank + j) * kBN + c] = float(sg) * vt[mag * rank + j];
    }
    __syncthreads();
    for (int kk = 0; kk < kBK; ++kk) {
      const int b = b_val[kk * kBN + tx];
#pragma unroll
      for (int i = 0; i < TM; ++i) acc[i] += Acc(a_val[(ty * TM + i) * kBK + kk] * b);
      for (int j = 0; j < rank; ++j) {
        const float vj = ve[(kk * rank + j) * kBN + tx];
#pragma unroll
        for (int i = 0; i < TM; ++i) corr[i] += ue[((ty * TM + i) * kBK + kk) * rank + j] * vj;
      }
    }
  }
  const int col = col0 + tx;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r < M && col < N) out[size_t(r) * N + col] = __fadd_rn(float(acc[i]), corr[i]);
  }
}

template <int BM, typename Acc>
cudaError_t launch(const void* u, const void* v, const void* ma, const void* sa, const void* mb,
                   const void* sb, void* out, int M, int N, int K, int n, int rank,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(BM, 1 << n, rank);
  auto kernel = lowrank_matmul_kernel<BM, Acc>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<const uint8_t*>(ma), static_cast<const int8_t*>(sa),
      static_cast<const uint8_t*>(mb), static_cast<const int8_t*>(sb), static_cast<float*>(out),
      M, N, K, n, rank);
  return cudaGetLastError();
}

template <typename Acc>
cudaError_t launch_acc(const void* u, const void* v, const void* ma, const void* sa,
                       const void* mb, const void* sb, void* out, int M, int N, int K, int n,
                       int rank, int bm, cudaStream_t stream) {
  if (bm == 4) return launch<4, Acc>(u, v, ma, sa, mb, sb, out, M, N, K, n, rank, stream);
  if (bm == 16) return launch<16, Acc>(u, v, ma, sa, mb, sb, out, M, N, K, n, rank, stream);
  if (bm == 64) return launch<64, Acc>(u, v, ma, sa, mb, sb, out, M, N, K, n, rank, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int lowrank_matmul_launch(const void* u, const void* v, const void* mag_a,
                                     const void* sign_a, const void* mag_b, const void* sign_b,
                                     void* out, int M, int N, int K, int n, int rank, int bm,
                                     int wide_acc, int device, void* stream) {
  if (n < 1 || n > 8 || rank < 1 || M < 1 || N < 1 || K < 0 ||
      (bm != 4 && bm != 16 && bm != 64) || (M + bm - 1) / bm > 65535 ||
      smem_bytes(bm, 1 << n, rank) > 232448)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const auto s = static_cast<cudaStream_t>(stream);
  err = wide_acc ? launch_acc<long long>(u, v, mag_a, sign_a, mag_b, sign_b, out, M, N, K, n,
                                         rank, bm, s)
                 : launch_acc<int>(u, v, mag_a, sign_a, mag_b, sign_b, out, M, N, K, n, rank,
                                   bm, s);
  return int(err);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
