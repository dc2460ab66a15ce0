// lut_matmul.cu: the `bitexact` GEMM through the approximate-product table.
//
// Replaces: src/repro/kernels/lut_matmul.py `_kernel` (pallas_call at :83,
// entry lut_matmul_pallas at :100).
//
// Computes out[m, j] = sum_k sa[m,k] * sb[k,j] * LUT[min(ma[m,k], 2^n-1),
// min(mb[k,j], 2^n-1)] for sign-magnitude operands: magnitudes uint8,
// signs int8 in {-1, 0, 1}, table uint16 of 2^(2n) entries (n <= 8).
//
// Design.  The whole table is copied once per block into dynamic shared
// memory as uint16: products are < 2^16 at n <= 8, so n=8 takes 128 KiB,
// where the TPU kernel's int32 table (256 KiB) would not fit in the
// 227 KiB a block may use.  The grid covers (N-tile, M-tile); each block
// walks the whole K axis itself in steps of kBK, staging clamped
// magnitudes and signs of both operands in shared memory, so no sum
// crosses blocks.  Each of the 256 threads owns one output column and
// TM = BM/4 rows of the tile; a warp reads one A element (broadcast) and
// 32 consecutive B elements (no bank conflict) per step, then gathers 32
// table entries.
//
// Exactness.  Every product and partial sum is an integer, accumulated
// in int32 when K * (2^(2n) - 1) < 2^31 and in int64 otherwise (the host
// picks), and converted to float32 once at the end.  The plain version
// (kernels/lut_matmul.py) sums the same integers in int64 and converts
// once, so the two are bit-equal at any K.  The JAX reference sums in
// float32 instead, which is exact only while |sum| < 2^24 (K <= 256 at
// n=8); beyond that it rounds in its own order and the port does not.
//
// Bound on the H100.  At decode (M = 4) the block count is N/64 (16..48 of
// 132 SMs) and one block fills an SM's shared memory at n=8, so the kernel
// is bounded by the per-block gather rate, far from either roofline: the
// bytes (operands once, output once) and the table lookups at the
// shared-memory rate are both microseconds.  Split-K and a persistent grid
// are later work; this kernel is the simple, right one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;  // output columns per block, one per thread column
constexpr int kBK = 32;  // K extent staged in shared memory per step
constexpr int kRowGroups = kThreads / kBN;

template <int BM>
__host__ __device__ constexpr size_t tile_bytes() {
  return size_t(BM) * kBK * 4 + size_t(kBK) * kBN * 4 + size_t(BM) * kBK + size_t(kBK) * kBN;
}

template <int BM, typename Acc>
__global__ void __launch_bounds__(kThreads)
lut_matmul_kernel(const uint16_t* __restrict__ lut, const uint8_t* __restrict__ mag_a,
                  const int8_t* __restrict__ sign_a, const uint8_t* __restrict__ mag_b,
                  const int8_t* __restrict__ sign_b, float* __restrict__ out,
                  int M, int N, int K, int n) {
  constexpr int TM = BM / kRowGroups;
  extern __shared__ __align__(16) unsigned char smem[];
  int* a_idx = reinterpret_cast<int*>(smem);                      // [BM][kBK]: mag << n
  int* b_mag = a_idx + BM * kBK;                                  // [kBK][kBN]
  int8_t* a_sgn = reinterpret_cast<int8_t*>(b_mag + kBK * kBN);  // [BM][kBK]
  int8_t* b_sgn = a_sgn + BM * kBK;                               // [kBK][kBN]
  uint16_t* table = reinterpret_cast<uint16_t*>(smem + tile_bytes<BM>());

  const int side = 1 << n;
  const int qmax = side - 1;
  // 2^(2n) uint16 entries, copied as 32-bit words (the count is even)
  const uint32_t* lut_words = reinterpret_cast<const uint32_t*>(lut);
  uint32_t* table_words = reinterpret_cast<uint32_t*>(table);
  for (int i = threadIdx.x; i < side * side / 2; i += kThreads) table_words[i] = lut_words[i];

  const int tx = threadIdx.x % kBN;
  const int ty = threadIdx.x / kBN;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * kBN;
  Acc acc[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) acc[i] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous step's tiles are consumed
    for (int i = threadIdx.x; i < BM * kBK; i += kThreads) {
      const int r = row0 + i / kBK, k = k0 + i % kBK;
      int mag = 0, sg = 0;  // pad lanes: magnitude 0, sign 0 -> add 0
      if (r < M && k < K) {
        const size_t off = size_t(r) * K + k;
        mag = min(int(mag_a[off]), qmax);  // edge clamp, as the TPU kernel's
        sg = sign_a[off];
      }
      a_idx[i] = mag << n;
      a_sgn[i] = int8_t(sg);
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int k = k0 + i / kBN, c = col0 + i % kBN;
      int mag = 0, sg = 0;
      if (k < K && c < N) {
        const size_t off = size_t(k) * N + c;
        mag = min(int(mag_b[off]), qmax);
        sg = sign_b[off];
      }
      b_mag[i] = mag;
      b_sgn[i] = int8_t(sg);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const int b_val = b_mag[kk * kBN + tx];
      const int bs = b_sgn[kk * kBN + tx];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = ty * TM + i;
        const int prod = table[a_idx[r * kBK + kk] + b_val];
        acc[i] += Acc(a_sgn[r * kBK + kk] * bs * prod);
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
cudaError_t launch(const void* lut, const void* ma, const void* sa, const void* mb,
                   const void* sb, void* out, int M, int N, int K, int n, cudaStream_t stream) {
  const size_t smem = tile_bytes<BM>() + (size_t(1) << (2 * n)) * sizeof(uint16_t);
  auto kernel = lut_matmul_kernel<BM, Acc>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(lut), static_cast<const uint8_t*>(ma),
      static_cast<const int8_t*>(sa), static_cast<const uint8_t*>(mb),
      static_cast<const int8_t*>(sb), static_cast<float*>(out), M, N, K, n);
  return cudaGetLastError();
}

template <typename Acc>
cudaError_t launch_acc(const void* lut, const void* ma, const void* sa, const void* mb,
                       const void* sb, void* out, int M, int N, int K, int n,
                       int bm, cudaStream_t stream) {
  if (bm == 4) return launch<4, Acc>(lut, ma, sa, mb, sb, out, M, N, K, n, stream);
  if (bm == 16) return launch<16, Acc>(lut, ma, sa, mb, sb, out, M, N, K, n, stream);
  if (bm == 64) return launch<64, Acc>(lut, ma, sa, mb, sb, out, M, N, K, n, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int lut_matmul_launch(const void* lut, const void* mag_a, const void* sign_a,
                                 const void* mag_b, const void* sign_b, void* out, int M,
                                 int N, int K, int n, int bm, int wide_acc, int device,
                                 void* stream) {
  if (n < 1 || n > 8 || M < 1 || N < 1 || K < 0 || (bm != 4 && bm != 16 && bm != 64) ||
      (M + bm - 1) / bm > 65535)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const auto s = static_cast<cudaStream_t>(stream);
  err = wide_acc ? launch_acc<long long>(lut, mag_a, sign_a, mag_b, sign_b, out, M, N, K, n, bm, s)
                 : launch_acc<int>(lut, mag_a, sign_a, mag_b, sign_b, out, M, N, K, n, bm, s);
  return int(err);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
