// seqmul_matmul.cu: the paper's split-word recurrence itself as a GEMM.
//
// Replaces: src/repro/kernels/seqmul_matmul.py `_kernel` (pallas_call at
// :116, entry seqmul_matmul_pallas at :132).
//
// Computes out[m, j] = sum_k sa[m,k] * sb[k,j] * P(ma[m,k], mb[k,j]) where
// P is the n-cycle sequential product with the accumulator split at t
// (approximate: the LSP carry-out is deferred one cycle; fix_to_1 forces
// product bits [0, n+t) to 1 after a final-cycle carry), assembled as
// lo + 2^(n-1) * (s_lsp + 2^t * s_msp).  Magnitudes int16 in [0, 2^n)
// (n <= 12; bits at n and above are not read), signs int8 in {-1, 0, 1}.
//
// Design: the recurrence bit-sliced over K.  32 values of k sit in the 32
// bits of a word, one word ("plane") per bit position, so one instruction
// runs one step of 32 products.  Each block stages 128 K values (four K
// words) of its rows and columns as planes in shared memory: the n
// magnitude planes, the nonzero plane (bit 0 of the sign byte) and the
// negative plane (bit 7).  A thread builds the planes of one row or column
// and one K word from 32 coalesced loads (a warp reads 32 neighbouring
// columns, 64 contiguous bytes), shifting each bit into place.  Then each
// thread owns one output column and one or two rows (`tile_ok` below) and
// runs, per K word, the recurrence on planes held in registers:
//   - the state W = s_lsp + 2^t s_msp is n + 1 planes (s_msp never passes
//     n - t + 1 bits); its augend S >> 1 is the planes renamed down by one;
//   - the partial product of cycle j is A_i & B_j per plane i; bits add as
//     full adders, sum = aug ^ m ^ c (LOP3 0x96), carry = maj (LOP3 0xE8);
//   - the split is a renaming: at bit t the ripple carry is saved as the
//     next cycle's deferred carry and the previous cycle's deferred carry
//     is the carry-in (approximate), or the ripple carry goes on (exact);
//   - lo's plane j is plane 0 of cycle j's sum (j < n - 1); the product's
//     planes are lo's n - 1 followed by W's n + 1 (they do not overlap);
//   - fix_to_1 ORs the final deferred-carry plane C into lo's planes and
//     W's planes 0..t, fused into the masks below.
// The signed sum over the 32 lanes is sum_i 2^i (popc(P_i & pos) -
// popc(P_i & neg)), pos = nonzero & same sign, neg = nonzero & signs
// differ, kept as one int32 count per plane and summed with its weight
// once per slice.  n and t are template arguments (67 kernels, n = 1..12
// and every t), so the planes live in registers and every loop unrolls;
// approx and fix_to_1 are uniform flags (one select per cycle).
// tests/test_torch_gemm_redesign.py holds a PyTorch model of this form
// bit-equal to the recurrence of the port and of the JAX package (every
// (a, b) at n <= 6, random pairs to n = 12, every t) and its signed
// popcount sums equal to the plain version; the chip smoke and the
// card-only tests hold this kernel bit-equal to its plain version.  Pad
// lanes (k past K, rows past M, columns past N) are magnitude 0, sign 0:
// they fall out of both sign masks, and 0 * 0 raises no carry.
//
// Exactness.  Each plane count is an integer below 2^31 in magnitude
// (at most K); the slice's sum sum_i 2^i count_i is formed in int64 and
// is exactly the plain version's integer sum over the slice.  Partials
// cross blocks in int32 when K * (2^(2n) - 1) < 2^31 and in int64
// otherwise (build.wide_accumulator); the total is converted to float32
// once, as the plain version converts its int64 sum.
//
// Bound on the H100 (chip_smoke.py `seqmul_ops`), integer ALU slots per K
// word of one output, one Hopper instruction each, POPC at its sm_90 rate
// of 16 per clock and SM, a quarter of LOP3's and IADD3's 64:
//   cycle 0       n      A_i & B_0 (the state is zero)
//   cycles 1..n-1 2      bit 0: aug ^ (A_0 & B_j) and aug & A_0 & B_j
//                 3(n-1) bits 1..n-1: A_i & B_j, sum, carry (bit n and
//                        the split are renamings)
//   signs         3      signs differ; pos; neg
//   sum, 2n planes 3     (P | C) & pos, (P | C) & neg, count += a - b
//                 2 POPC (4 slots each)
// = n + (n-1)(3n-1) + 3 + 6n ALU + 4n POPC = 3n^2 + 19n + 4 slots per
// 32 products (348 at n = 8: 10.9 per product, where the one-word form
// of seqmul_kernel.cu needs 8n + 7 = 71), plus 2 (n + 2) per operand
// element to build its planes (a shift and a LOP3 per plane).  At 64
// slots per clock per SM.
//
// Split K, fixed order.  The host (kernels/seqmul_matmul.py
// `launch_plan`) picks the tile from M (`tile`) and cuts K into slices of
// whole stages over gridDim.z so that tiles x splits fill one wave of two
// blocks per SM (M = 4: 48 tiles x 4 slices of 256).  Every block of a
// split launch writes its integer partials to the workspace [split][M][N];
// the last block of a tile to finish (a counter per tile, split_k.cuh)
// adds them in split order, converts, writes the output and resets its
// counter to 0.
// One launch, no memset, no allocation.

#include <cstdint>
#include <cuda_runtime.h>

#include "split_k.cuh"

namespace {

constexpr int kThreads = 256;            // eight warps
constexpr int kWords = 4;                // K words of 32 lanes per stage
constexpr int kStageK = 32 * kWords;
constexpr int kMaxRows = 2;              // rows per thread at most
constexpr int kMaxN = 12;

// Words per (row, K word) of the A planes: n + 2 rounded up to whole uint4s.
__host__ __device__ constexpr int a_stride(int n) { return (n + 2 + 3) & ~3; }

// Shared memory: A planes [bm][kWords][a_stride], B planes [kWords][n+2][bn].
__host__ __device__ constexpr size_t smem_bytes(int n, int bm, int bn) {
  return 4 * (size_t(bm) * kWords * a_stride(n) + size_t(kWords) * (n + 2) * bn);
}

// The tiles kernels/seqmul_matmul.py TILES names: (bm, bn) with bn / 32
// warps across the columns, 8 / (bn / 32) across the rows, bm / that rows
// per thread.
__host__ __device__ constexpr bool tile_ok(int bm, int bn) {
  return (bm == 2 && bn == 128) || (bm == 4 && bn == 64) || (bm == 8 && bn == 32) ||
         (bm == 16 && bn == 32);
}

// The planes of `count` values (the rest zero) `stride` elements apart:
// n magnitude bits, then the nonzero and the negative plane of the signs.
template <int NB>
__device__ __forceinline__ void build_planes(const int16_t* __restrict__ mag,
                                             const int8_t* __restrict__ sgn, size_t stride,
                                             int count, uint32_t (&p)[NB + 2]) {
#pragma unroll
  for (int i = 0; i < NB + 2; ++i) p[i] = 0u;
#pragma unroll
  for (int kk = 0; kk < 32; ++kk) {
    uint32_t m = 0u, s = 0u;
    if (kk < count) {
      m = uint16_t(mag[kk * stride]);
      s = uint8_t(sgn[kk * stride]);
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) p[i] |= ((m >> i) & 1u) << kk;
    p[NB] |= (s & 1u) << kk;
    p[NB + 1] |= (s >> 7) << kk;
  }
}

// One K word of one output: the 32 products' recurrence on planes, their
// signed sums added into the per-plane counts.
template <int NB, int T>
__device__ __forceinline__ void product_sum(const uint32_t* __restrict__ a,
                                            const uint32_t (&b)[NB + 2], bool approx, bool fix,
                                            int (&count)[2 * NB]) {
  uint32_t w[NB + 1];  // W = s_lsp + 2^T s_msp
  uint32_t lo[NB];     // product bits 0..NB-2 (one per cycle but the last)
#pragma unroll
  for (int i = 0; i <= NB; ++i) w[i] = 0u;
  uint32_t deferred = 0u;  // the LSP carry-out of the cycle before
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const uint32_t bj = b[j];
    uint32_t next[NB + 1], carry = 0u;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if (i == T) {  // the split
        const uint32_t out = carry;
        carry = approx ? deferred : out;
        deferred = out;
      }
      const uint32_t aug = w[i + 1];  // (S >> 1) bit i
      const uint32_t m = a[i] & bj;
      next[i] = aug ^ m ^ carry;
      carry = (aug & m) | (carry & (aug ^ m));
    }
    if (T == NB) {  // n = 1: the split sits at the top bit
      const uint32_t out = carry;
      carry = approx ? deferred : out;
      deferred = out;
    }
    next[NB] = carry;  // aug and m are 0 at bit NB
#pragma unroll
    for (int i = 0; i <= NB; ++i) w[i] = next[i];
    if (j < NB - 1) lo[j] = w[0];
  }
  const uint32_t c = (approx && fix) ? deferred : 0u;
  const uint32_t differ = a[NB + 1] ^ b[NB + 1];
  const uint32_t pos = a[NB] & b[NB] & ~differ;
  const uint32_t neg = a[NB] & b[NB] & differ;
#pragma unroll
  for (int p = 0; p < NB - 1; ++p) {
    const uint32_t v = lo[p] | c;
    count[p] += __popc(v & pos) - __popc(v & neg);
  }
#pragma unroll
  for (int p = 0; p <= NB; ++p) {
    const uint32_t v = p <= T ? (w[p] | c) : w[p];
    count[NB - 1 + p] += __popc(v & pos) - __popc(v & neg);
  }
}

// The output: float32, or (int_out) the exact sum as int32 (int64 if wide):
// the integer epilogue of a tensor-parallel K shard, whose sums the shards
// add as integers before the one conversion (engine/modes.py).
__device__ __forceinline__ void store_out(float* out, size_t o, long long v, int int_out,
                                          bool wide) {
  if (!int_out)
    out[o] = __ll2float_rn(v);
  else if (wide)
    reinterpret_cast<long long*>(out)[o] = v;
  else
    reinterpret_cast<int*>(out)[o] = int(v);
}

template <int NB, int T>
__global__ void __launch_bounds__(kThreads, 2)
seqmul_matmul_kernel(const int16_t* __restrict__ mag_a, const int8_t* __restrict__ sign_a,
                     const int16_t* __restrict__ mag_b, const int8_t* __restrict__ sign_b,
                     float* __restrict__ out, void* __restrict__ ws, int* __restrict__ counters,
                     int M, int N, int K, int bm, int bn, int k_chunk, int approx, int fix_to_1,
                     int wide, int int_out) {
  constexpr int NP = NB + 2, AS = a_stride(NB);
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* a_pl = smem;                           // [bm][kWords][AS]
  uint32_t* b_pl = smem + bm * kWords * AS;        // [kWords][NP][bn]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = bn >> 5, rows = bm / (8 / wn);    // rows per thread
  const int c_local = (warp % wn) * 32 + lane;
  const int r_local = (warp / wn) * rows;
  const int col = blockIdx.x * bn + c_local;
  const int row0 = blockIdx.y * bm;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const bool ap = approx != 0, fix = fix_to_1 != 0;

  int count[kMaxRows][2 * NB];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i)
#pragma unroll
    for (int p = 0; p < 2 * NB; ++p) count[i][p] = 0;

  for (int k0 = k_begin; k0 < k_end; k0 += kStageK) {
    __syncthreads();  // the previous stage's planes are consumed
    for (int task = tid; task < kWords * bn; task += kThreads) {
      const int w = task / bn, c = task % bn;
      const int kb = k0 + 32 * w, j = blockIdx.x * bn + c;
      const int cnt = j < N ? max(0, min(32, k_end - kb)) : 0;
      const size_t off = cnt > 0 ? size_t(kb) * N + j : 0;
      uint32_t p[NP];
      build_planes<NB>(mag_b + off, sign_b + off, size_t(N), cnt, p);
#pragma unroll
      for (int i = 0; i < NP; ++i) b_pl[(w * NP + i) * bn + c] = p[i];
    }
    for (int task = tid; task < bm * kWords; task += kThreads) {
      const int r = task / kWords, w = task % kWords;
      const int m = row0 + r, kb = k0 + 32 * w;
      const int cnt = m < M ? max(0, min(32, k_end - kb)) : 0;
      const size_t off = cnt > 0 ? size_t(m) * K + kb : 0;
      uint32_t p[NP];
      build_planes<NB>(mag_a + off, sign_a + off, 1, cnt, p);
      uint32_t* dst = a_pl + (r * kWords + w) * AS;
#pragma unroll
      for (int i = 0; i < AS; i += 4)
        *reinterpret_cast<uint4*>(dst + i) =
            make_uint4(p[i], i + 1 < NP ? p[i + 1] : 0u, i + 2 < NP ? p[i + 2] : 0u,
                       i + 3 < NP ? p[i + 3] : 0u);
    }
    __syncthreads();
    const int words = min(kWords, (k_end - k0 + 31) / 32);
    for (int w = 0; w < words; ++w) {
      uint32_t b[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i) b[i] = b_pl[(w * NP + i) * bn + c_local];
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i) {
        if (i < rows && row0 + r_local + i < M) {  // uniform in the warp
          const uint4* src =
              reinterpret_cast<const uint4*>(a_pl + ((r_local + i) * kWords + w) * AS);
          uint32_t a[AS];
#pragma unroll
          for (int q = 0; q < AS / 4; ++q) {
            const uint4 v = src[q];
            a[4 * q] = v.x;
            a[4 * q + 1] = v.y;
            a[4 * q + 2] = v.z;
            a[4 * q + 3] = v.w;
          }
          product_sum<NB, T>(a, b, ap, fix, count[i]);
        }
      }
    }
  }

  // this block's integer sums over its slice
  long long part[kMaxRows];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    part[i] = 0;
#pragma unroll
    for (int p = 0; p < 2 * NB; ++p) part[i] += (long long)count[i][p] << p;
  }
  const size_t plane = size_t(M) * N;
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    const int m = row0 + r_local + i;
    if (i >= rows || m >= M || col >= N) continue;
    const size_t o = size_t(m) * N + col;
    if (!split)
      store_out(out, o, part[i], int_out, wide);
    else if (wide)
      static_cast<long long*>(ws)[blockIdx.z * plane + o] = part[i];
    else
      static_cast<int*>(ws)[blockIdx.z * plane + o] = int(part[i]);
  }
  if (!split) return;

  // the last block of this tile to finish adds the partials in split order
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (!split_k_last(counters, tile, gridDim.z)) return;
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    const int m = row0 + r_local + i;
    if (i >= rows || m >= M || col >= N) continue;
    const size_t o = size_t(m) * N + col;
    long long sum = 0;
    for (int s = 0; s < int(gridDim.z); ++s)
      sum += wide ? __ldcg(static_cast<const long long*>(ws) + s * plane + o)
                  : (long long)__ldcg(static_cast<const int*>(ws) + s * plane + o);
    store_out(out, o, sum, int_out, wide);
  }
  split_k_release(counters, tile);
}

using Kernel = void (*)(const int16_t*, const int8_t*, const int16_t*, const int8_t*, float*,
                        void*, int*, int, int, int, int, int, int, int, int, int, int);

template <int NB, int T = 1>
Kernel kernel_for_t(int t) {
  if constexpr (T > (NB > 1 ? NB - 1 : 1)) {
    return nullptr;
  } else {
    if (t == T) return seqmul_matmul_kernel<NB, T>;
    return kernel_for_t<NB, T + 1>(t);
  }
}

template <int NB = 1>
Kernel kernel_for(int n, int t) {
  if constexpr (NB > kMaxN) {
    return nullptr;
  } else {
    if (n == NB) return kernel_for_t<NB>(t);
    return kernel_for<NB + 1>(n, t);
  }
}

struct Plan {
  dim3 grid;
  int threads;
  size_t smem;
};

// The launch for these arguments, or false where they are refused.
bool make_plan(int M, int N, int K, int n, int t, int bm, int bn, int splits, int k_chunk,
               Plan* plan) {
  const bool t_ok = (n == 1) ? (t == 1) : (t >= 1 && t <= n - 1);
  if (n < 1 || n > kMaxN || !t_ok || M < 1 || N < 1 || K < 0 || !tile_ok(bm, bn) ||
      splits < 1 || splits > 65535 || k_chunk < kStageK || k_chunk % kStageK != 0 ||
      (long long)splits * k_chunk < K || (splits > 1 && (long long)(splits - 1) * k_chunk >= K) ||
      (M + bm - 1) / bm > 65535)
    return false;
  plan->grid = dim3((N + bn - 1) / bn, (M + bm - 1) / bm, splits);
  plan->threads = kThreads;
  plan->smem = smem_bytes(n, bm, bn);
  return true;
}

}  // namespace

// bm, bn: the tile (kernels/seqmul_matmul.py TILES); splits * k_chunk
// covers K in whole stages of 128, no slice empty; ws (splits * M * N
// int32, or int64 if wide_acc) and counters (one per tile, zeroed) are
// needed only when splits > 1; int_out: out holds M * N int32 (int64 if
// wide_acc) exact sums in place of float32.
extern "C" int seqmul_matmul_launch(const void* mag_a, const void* sign_a, const void* mag_b,
                                    const void* sign_b, void* out, int M, int N, int K, int n,
                                    int t, int approx, int fix_to_1, int bm, int wide_acc, int bn,
                                    int splits, int k_chunk, void* ws, void* counters,
                                    int int_out, int device, void* stream) {
  Plan p;
  if (!make_plan(M, N, K, n, t, bm, bn, splits, k_chunk, &p) ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return int(cudaErrorInvalidValue);
  const Kernel kernel = kernel_for(n, t);
  if (kernel == nullptr) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  kernel<<<p.grid, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(mag_a), static_cast<const int8_t*>(sign_a),
      static_cast<const int16_t*>(mag_b), static_cast<const int8_t*>(sign_b),
      static_cast<float*>(out), ws, static_cast<int*>(counters), M, N, K, bm, bn, k_chunk,
      approx, fix_to_1, wide_acc, int_out);
  return int(cudaGetLastError());
}

// The launch seqmul_matmul_launch makes for these arguments:
// out = {grid x, y, z, threads, shared-memory bytes}.
extern "C" int seqmul_matmul_plan(int M, int N, int K, int n, int t, int bm, int bn, int splits,
                                  int k_chunk, long long* out) {
  Plan p;
  if (!make_plan(M, N, K, n, t, bm, bn, splits, k_chunk, &p)) return int(cudaErrorInvalidValue);
  const long long plan[5] = {p.grid.x, p.grid.y, p.grid.z, p.threads, (long long)p.smem};
  for (int i = 0; i < 5; ++i) out[i] = plan[i];
  return 0;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
