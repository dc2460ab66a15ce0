// lut_matmul.cu: the `bitexact` GEMM through the approximate-product table.
//
// Replaces: src/repro/kernels/lut_matmul.py `_kernel` (pallas_call at :83,
// entry lut_matmul_pallas at :100).
//
// Computes out[m, j] = sum_k sa[m,k] * sb[k,j] * LUT[min(ma[m,k], 2^n-1),
// min(mb[k,j], 2^n-1)] for sign-magnitude operands: magnitudes uint8,
// signs int8 in {-1, 0, 1}, table uint16 of 2^(2n) entries (n <= 8).
//
// Design: a persistent grid that copies the table once per SM.  The table
// is uint16 in shared memory (products are < 2^16 at n <= 8, so n = 8
// takes 128 KiB, where the TPU kernel's int32 table, 256 KiB, would not
// fit in the 227 KiB a block may use); at n = 8 that leaves room for one
// block per SM.  So the grid is min(work items, SMs) blocks of 512
// threads; each copies the table once and walks a static list of work
// items, item b, b + grid, ...: (row tile, column tile, K slice).  A tile
// is BM rows (4, 16 or 32, `tile` in kernels/lut_matmul.py) by 512
// columns; a thread owns TM rows and TN columns (4 x 1, 8 x 2, 8 x 4), K
// is staged 32 at a time.  Operands come in with 16-byte loads (when the
// shapes and pointers allow; else byte loads) for the next stage while
// this one computes, and are stored clamped to 2^n - 1, one word per (k,
// column): the column's byte offset in a table row, its sign in the high
// half; and one per (k, row): the byte offset of the row's table row, its
// sign in the top byte.
//
// Gather order.  A warp is 32 neighbouring columns of one row: `a` is the
// same for all its lanes (a broadcast read), and its 32 lookups fall in
// one table row of 2^n entries.  With 32 banks of 4 bytes a row of 256
// uint16 spans four bank cycles, so two lanes conflict only when their
// b differ by a multiple of 64 and are not in one word; b below 64 never
// conflicts.  The other order (lanes across rows, b broadcast) puts all
// 32 lanes in one bank (a row is 128 words, a multiple of 32).  chip_smoke
// times each lut row again with every magnitude below 64: the difference
// is what the conflicts cost (a quarter at (128, 1024, 3072) on an H100
// 80GB HBM3 with the main path's quantized Gaussian operands).  A word
// read by the whole warp also costs a shared-memory wavefront, as a
// gather does, so a row's offset and sign share one word and a thread's
// TN columns share it: per (k, row) a warp reads one word for 32 TN
// lookups.
//
// Exactness.  Every product and partial sum is an integer, summed in
// int32 when K * (2^(2n) - 1) < 2^31 (the host picks,
// build.wide_accumulator) and otherwise per stage in int32 (32 products,
// below 2^21) folded into int64, and converted to float32 once.
// The plain version (kernels/lut_matmul.py) sums the same integers in
// int64 and converts once, so the two are bit-equal at any K.  The JAX
// reference sums in float32 instead, which is exact only while |sum| <
// 2^24 (K <= 256 at n=8); beyond that it rounds in its own order and the
// port does not.
//
// Split K, fixed order.  The host (`launch_plan`) cuts K over the items
// so that they fill the SMs at small M (M = 4, N = 3072: 6 tiles x 16
// slices of 64).  Every item of a split tile writes its integer partials
// to the workspace [split][M][N]; the last item of a tile to finish (a
// counter per tile, split_k.cuh) adds them in split order, converts,
// writes the output and resets its counter to 0.
//
// Integer epilogue (int_out).  A tensor-parallel shard of a row-parallel
// layer holds a slice of K; the shards' sums must be added as the exact
// integers they are before the one conversion, or the shard count would
// move the result wherever |sum| >= 2^24 (engine/modes.py).  With int_out
// the kernel writes the accumulator itself, int32 or int64 as the host
// chose it (build.wide_accumulator), in place of float(acc); the split-K
// sum is the same integer, so the output equals the float32 one before
// its conversion, bit for bit.
//
// Bound on the H100 (chip_smoke.py): the larger of the table lookups at
// the shared-memory rate (32 a clock per SM) and the bytes the function
// must move at the HBM rate: operands once, output once, the table once.
// The table's other copies, one per block of the grid, come from L2 and
// are this design's choice, not bytes the function needs: chip_smoke
// prints them beside the bound (`table_copy_bytes`), outside it.
// Per product the design issues one lookup and three integer
// instructions (the address add, the sign product, the multiply-add),
// and per (k, row) one broadcast word for its TN columns.

#include <cstdint>
#include <cuda_runtime.h>

#include "split_k.cuh"

namespace {

constexpr int kThreads = 512;  // sixteen warps
constexpr int kBN = 512;       // output columns per tile, one per thread
constexpr int kBK = 32;        // K values per stage
constexpr int kMaxDevices = 64;

// The table's bytes, rounded up to whole 16-byte words (n = 1 has 8).
__host__ __device__ constexpr size_t table_bytes(int n) {
  return ((size_t(2) << (2 * n)) + 15) & ~size_t(15);
}

// Shared memory: the table, then B words [kBK][kBN], then A words [kBK][bm].
__host__ __device__ constexpr size_t smem_bytes(int n, int bm) {
  return table_bytes(n) + size_t(4) * kBK * kBN + size_t(4) * kBK * bm;
}

// The next stage's operands, held in registers while this one computes:
// B as two 16-byte runs (16 columns of one k) of magnitudes and of signs
// per thread, A as one run of 16 k of one row (threads < 2 BM).
struct Staged {
  uint4 bm[2], bs[2], am, as;
};

__device__ __forceinline__ uint8_t byte_of(const uint4& v, int e) {
  const uint32_t w = e < 4 ? v.x : e < 8 ? v.y : e < 12 ? v.z : v.w;
  return uint8_t(w >> (8 * (e & 3)));
}

// 16 bytes at p, or those of them before `limit` (zeros after), when the
// run may be ragged or unaligned.
__device__ __forceinline__ uint4 load16(const uint8_t* p, int limit, bool vec) {
  if (vec && limit >= 16) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (e < limit) w[e >> 2] |= uint32_t(p[e]) << (8 * (e & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The output: float32, or (int_out) the exact sum in the accumulator's type.
template <typename Acc>
__device__ __forceinline__ void store_out(float* out, size_t o, Acc v, int int_out) {
  if (int_out)
    reinterpret_cast<Acc*>(out)[o] = v;
  else
    out[o] = float(v);
}

// A block of 16 warps: TN row groups of TM rows by 16 / TN column groups
// of 32 * TN columns (BM = TM * TN rows by 512 columns); a thread owns TM
// rows and the TN columns lane + 32 j of its warp's span.
template <int TM, int TN, typename Acc>
__global__ void __launch_bounds__(kThreads, 1)
lut_matmul_kernel(const uint16_t* __restrict__ lut, const uint8_t* __restrict__ mag_a,
                  const int8_t* __restrict__ sign_a, const uint8_t* __restrict__ mag_b,
                  const int8_t* __restrict__ sign_b, float* __restrict__ out,
                  Acc* __restrict__ ws, int* __restrict__ counters, int M, int N, int K, int n,
                  int splits, int k_chunk, int vec, int int_out) {
  constexpr int BM = TM * TN, kColGroups = 16 / TN;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qmax = (1 << n) - 1;
  int* b_s = reinterpret_cast<int*>(smem + table_bytes(n));  // [kBK][kBN]
  int* a_s = b_s + kBK * kBN;                                // [kBK][BM]
  const int r_local = (warp / kColGroups) * TM;
  const int c_local = (warp % kColGroups) * 32 * TN + lane;

  // the table, once: 2^(2n) uint16 as 32-bit words (the count is even)
  {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(lut);
    uint32_t* dst = reinterpret_cast<uint32_t*>(smem);
    for (int i = tid; i < (1 << (2 * n)) / 2; i += kThreads) dst[i] = __ldg(src + i);
  }

  const int tiles_m = (M + BM - 1) / BM;
  const int items = tiles_m * ((N + kBN - 1) / kBN) * splits;
  const bool vec_b = vec != 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int split = item % splits, tile = item / splits;
    const int row0 = (tile % tiles_m) * BM, col0 = (tile / tiles_m) * kBN;
    const int k_begin = split * k_chunk, k_end = min(K, k_begin + k_chunk);
    const int stages = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

    // what each thread stages: B runs (k row, 16 columns), an A run (row, 16 k)
    auto fetch = [&](int st, Staged& g) {
      const int k0 = k_begin + st * kBK;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = tid + h * kThreads;  // 1024 runs: 32 k rows x 32 runs of 16
        const int k = k0 + c / 32, j = col0 + (c % 32) * 16;
        const int limit = k < k_end ? min(16, N - j) : 0;
        const size_t off = limit > 0 ? size_t(k) * N + j : 0;
        g.bm[h] = load16(mag_b + off, limit, vec_b);
        g.bs[h] = load16(reinterpret_cast<const uint8_t*>(sign_b) + off, limit, vec_b);
      }
      if (tid < 2 * BM) {
        const int m = row0 + tid / 2, k = k0 + (tid % 2) * 16;
        const int limit = m < M ? max(0, min(16, k_end - k)) : 0;
        const size_t off = limit > 0 ? size_t(m) * K + k : 0;
        g.am = load16(mag_a + off, limit, vec_b);
        g.as = load16(reinterpret_cast<const uint8_t*>(sign_a) + off, limit, vec_b);
      }
    };
    auto store = [&](const Staged& g) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = tid + h * kThreads;
        int* dst = b_s + (c / 32) * kBN + (c % 32) * 16;
#pragma unroll
        for (int e = 0; e < 16; e += 4) {
          int v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int mag = min(int(byte_of(g.bm[h], e + q)), qmax);
            const int sg = int(int8_t(byte_of(g.bs[h], e + q)));
            v[q] = (2 * mag) | int(uint32_t(sg) << 16);  // sign in the high half
          }
          *reinterpret_cast<int4*>(dst + e) = make_int4(v[0], v[1], v[2], v[3]);
        }
      }
      if (tid < 2 * BM) {
        const int r = tid / 2, kk0 = (tid % 2) * 16;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int mag = min(int(byte_of(g.am, e)), qmax);
          const int sg = int(int8_t(byte_of(g.as, e)));
          // the byte offset of its table row (below 2^17), the sign in the top byte
          a_s[(kk0 + e) * BM + r] = ((2 * mag) << n) | int(uint32_t(sg) << 24);
        }
      }
    };

    // int32 sums while the whole K's fits (the host's wide_accumulator);
    // else each stage's (below 2^21) is folded into int64
    int part[TM][TN];
    Acc acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0, acc[i][j] = 0;
    Staged g;
    if (stages > 0) fetch(0, g);
    for (int st = 0; st < stages; ++st) {
      __syncthreads();  // the table has landed; the previous stage is consumed
      store(g);
      __syncthreads();
      if (st + 1 < stages) fetch(st + 1, g);  // in flight while this stage computes
      const int kk_end = min(kBK, k_end - (k_begin + st * kBK));
#pragma unroll 2
      for (int kk = 0; kk < kk_end; ++kk) {
        int boff[TN], sb[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int bw = b_s[kk * kBN + c_local + 32 * j];
          boff[j] = bw & 0xFFFF;
          sb[j] = bw >> 16;
        }
        const int4* aw = reinterpret_cast<const int4*>(a_s + kk * BM + r_local);
#pragma unroll
        for (int q = 0; q < TM / 4; ++q) {
          const int4 v = aw[q];  // four rows' words, the same for the whole warp
          const int w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int off = w4[r] & 0xFFFFFF, sa = w4[r] >> 24;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              const int p = *reinterpret_cast<const uint16_t*>(smem + off + boff[j]);
              part[4 * q + r][j] += (sa * sb[j]) * p;
            }
          }
        }
      }
      if constexpr (sizeof(Acc) == 8) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j], part[i][j] = 0;
      }
    }
    if constexpr (sizeof(Acc) == 4) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = part[i][j];
    }

    const size_t plane = size_t(M) * N;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int m = row0 + r_local + i, col = col0 + c_local + 32 * j;
        if (m >= M || col >= N) continue;
        const size_t o = size_t(m) * N + col;
        if (splits == 1)
          store_out(out, o, acc[i][j], int_out);
        else
          ws[split * plane + o] = acc[i][j];
      }
    if (splits == 1) continue;
    // the last item of this tile to finish adds the partials in split order
    if (!split_k_last(counters, tile, splits)) continue;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int m = row0 + r_local + i, col = col0 + c_local + 32 * j;
        if (m >= M || col >= N) continue;
        const size_t o = size_t(m) * N + col;
        Acc sum = 0;
        for (int s = 0; s < splits; ++s) sum += __ldcg(ws + s * plane + o);
        store_out(out, o, sum, int_out);
      }
    split_k_release(counters, tile);
  }
}

struct Plan {
  int grid;
  int threads;
  size_t smem;
};

bool make_plan(int M, int N, int K, int n, int bm, int splits, int k_chunk, int sms, Plan* plan) {
  if (n < 1 || n > 8 || M < 1 || N < 1 || K < 0 || (bm != 4 && bm != 16 && bm != 32) ||
      splits < 1 || k_chunk < kBK || k_chunk % kBK != 0 || (long long)splits * k_chunk < K ||
      (splits > 1 && (long long)(splits - 1) * k_chunk >= K) || sms < 1)
    return false;
  const long long items =
      (long long)((M + bm - 1) / bm) * ((N + kBN - 1) / kBN) * splits;
  if (items > (1LL << 31) - 1) return false;
  plan->grid = int(items < sms ? items : sms);
  plan->threads = kThreads;
  plan->smem = smem_bytes(n, bm);
  return plan->smem <= 232448;
}

template <int TM, int TN, typename Acc>
cudaError_t launch(const Plan& p, const void* lut, const void* ma, const void* sa, const void* mb,
                   const void* sb, void* out, void* ws, void* counters, int M, int N, int K,
                   int n, int splits, int k_chunk, int vec, int int_out, cudaStream_t stream) {
  auto kernel = lut_matmul_kernel<TM, TN, Acc>;
  // the attribute once per kernel and device (at its largest, n = 8), not once per launch
  static bool sized[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !sized[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem_bytes(8, TM * TN)));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) sized[dev] = true;
  }
  kernel<<<p.grid, p.threads, p.smem, stream>>>(
      static_cast<const uint16_t*>(lut), static_cast<const uint8_t*>(ma),
      static_cast<const int8_t*>(sa), static_cast<const uint8_t*>(mb),
      static_cast<const int8_t*>(sb), static_cast<float*>(out), static_cast<Acc*>(ws),
      static_cast<int*>(counters), M, N, K, n, splits, k_chunk, vec, int_out);
  return cudaGetLastError();
}

template <typename Acc>
cudaError_t launch_acc(const Plan& p, int bm, const void* lut, const void* ma, const void* sa,
                       const void* mb, const void* sb, void* out, void* ws, void* counters, int M,
                       int N, int K, int n, int splits, int k_chunk, int vec, int int_out,
                       cudaStream_t s) {
  if (bm == 4) return launch<4, 1, Acc>(p, lut, ma, sa, mb, sb, out, ws, counters, M, N, K, n, splits, k_chunk, vec, int_out, s);
  if (bm == 16) return launch<8, 2, Acc>(p, lut, ma, sa, mb, sb, out, ws, counters, M, N, K, n, splits, k_chunk, vec, int_out, s);
  if (bm == 32) return launch<8, 4, Acc>(p, lut, ma, sa, mb, sb, out, ws, counters, M, N, K, n, splits, k_chunk, vec, int_out, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// bm: the row tile (kernels/lut_matmul.py TILES); splits * k_chunk covers
// K in whole stages of 32, no slice empty; sms: the grid's cap (one block
// per SM); vec: 16-byte loads (K and N multiples of 16, 16-byte aligned
// operands); ws (splits * M * N int32, or int64 if wide_acc) and counters
// (one per tile, zeroed) are needed only when splits > 1; int_out: out
// holds M * N int32 (int64 if wide_acc) exact sums in place of float32.
extern "C" int lut_matmul_launch(const void* lut, const void* mag_a, const void* sign_a,
                                 const void* mag_b, const void* sign_b, void* out, int M,
                                 int N, int K, int n, int bm, int wide_acc, int splits,
                                 int k_chunk, int sms, int vec, void* ws, void* counters,
                                 int int_out, int device, void* stream) {
  Plan p;
  if (!make_plan(M, N, K, n, bm, splits, k_chunk, sms, &p) ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const auto s = static_cast<cudaStream_t>(stream);
  err = wide_acc ? launch_acc<long long>(p, bm, lut, mag_a, sign_a, mag_b, sign_b, out, ws,
                                         counters, M, N, K, n, splits, k_chunk, vec, int_out, s)
                 : launch_acc<int>(p, bm, lut, mag_a, sign_a, mag_b, sign_b, out, ws, counters,
                                   M, N, K, n, splits, k_chunk, vec, int_out, s);
  return int(err);
}

// The launch lut_matmul_launch makes for these arguments:
// out = {grid x, y, z, threads, shared-memory bytes}.
extern "C" int lut_matmul_plan(int M, int N, int K, int n, int bm, int splits, int k_chunk,
                               int sms, long long* out) {
  Plan p;
  if (!make_plan(M, N, K, n, bm, splits, k_chunk, sms, &p)) return int(cudaErrorInvalidValue);
  const long long plan[5] = {p.grid, 1, 1, p.threads, (long long)p.smem};
  for (int i = 0; i < 5; ++i) out[i] = plan[i];
  return 0;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
