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
// What bounds it on the H100.  The words: 4 bytes per two K values of
// each operand, read once (the (K/2, N) weight is 6.3 MB at qwen3's
// (1024, 3072): 1.9 us at 3.35 TB/s).  Its products, four int8 tensor-core
// products per lane product (below), are 8*M*K*N operations at 1,979
// TOP/s, under the bytes' time up to M of about 300.
//
// Int8 planes.  Lane values satisfy |q| <= 2^n - 1 (n <= 15), so each
// lane is q = 256 h + l with l = q & 255 (u8) and h = q >> 8 (s8): the
// low and high bytes of the int16 lane as it sits in the word.  A
// __byte_perm of two words gathers four lanes' low bytes (selector 0x6420)
// or high bytes (0x7531) into one MMA register, so the planes are split
// as the fragments are read, with no conversion pass.  a*b = 65536 hh +
// 256 (hl + lh) + ll: mma.sync.m16n8k32 with s8.s8, s8.u8, u8.s8 and u8.u8
// operands and s32 accumulators.  Each plane sum over one K step of 32
// lanes is below 2^21 in magnitude, exact in int32; the steps are folded
// into the block's sum in int32 while K * (2^n - 1)^2 < 2^31
// (wide_accumulator, computed modulo 2^32, exact since the total fits)
// and in int64 otherwise, and the total is converted to float32 once.
// The plain version computes the same integer sums exactly (float64
// products of integers below 2^53), so the two are bit-equal.
//
// Tiles.  Each block owns a BM x BN output tile and one K slice.  Warps
// are 32 weight columns by 8*MT tokens, "swapped": the weight's N in the
// MMA's 16 rows, the tokens in its 8 columns (a decode batch of 4 fills
// half of one 8-column tile).  Lane (g, t) owns weight columns 4g..4g+3
// of its warp's 32, rows g and g+8 of the warp's two 16-row MMA tiles:
// one 16-byte shared load gives it a word of each.  The word tiles of
// each stage (32 words, 64 K lanes) are copied with cp.async into a ring
// of kStages, so the next stages' copies are in flight during this one's
// MMAs.  Shared-memory rows are padded (weight rows by 8 words, token rows
// by 4) so that every fragment load is free of bank conflicts.
//
// Split K, fixed order.  At decode the output has 8-24 tiles for 132 SMs,
// so the host (kernels/packed_matmul.py `launch_plan`) splits K over
// gridDim.z, up to one wave of two blocks per SM.  Every block writes its
// integer partial to the workspace [split][M][N]; the last block of a tile
// to finish (a counter per tile, split_k.cuh) sums the
// partials in split order (in int32 unless wide, the next split's loads in
// flight while one is added), converts, writes the output and resets its
// counter to 0.  One launch, no memset: the counters are zeroed once when
// the host first allocates them, and launches on one stream never overlap.

#include <cstdint>
#include <cuda_runtime.h>

#include "split_k.cuh"

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kBKW = 32;       // words per stage (64 K lanes, two m16n8k32 steps)
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kXRow = kBKW + 4;  // words per token row (pad: conflict-free fragment loads)
constexpr int kMaxDevices = 64;

template <int WN, int MT>
struct Tile {
  static constexpr int kWarpsM = 4 / WN;
  static constexpr int BN = 32 * WN;
  static constexpr int BM = 8 * MT * kWarpsM;
  static constexpr int kWRow = BN + 8;  // words per K row of the weight tile
  static constexpr int kStage = kBKW * kWRow + BM * kXRow;  // words
  static constexpr size_t kSmem = size_t(kStages) * kStage * 4;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // src-size 0 fills the 16 bytes with zeros: zero lanes add 0
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

#define PACKED_MMA(ATYPE, BTYPE)                                                              \
  __device__ __forceinline__ void mma_##ATYPE##_##BTYPE(int(&d)[4], const uint32_t(&a)[4],    \
                                                        const uint32_t(&b)[2]) {              \
    asm("mma.sync.aligned.m16n8k32.row.col.s32." #ATYPE "." #BTYPE                            \
        ".s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"                        \
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])                                      \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));                  \
  }
PACKED_MMA(s8, s8)
PACKED_MMA(s8, u8)
PACKED_MMA(u8, s8)
PACKED_MMA(u8, u8)
#undef PACKED_MMA

// four lanes (two per word) -> their high bytes (s8) and low bytes (u8)
__device__ __forceinline__ uint32_t high_bytes(uint32_t w0, uint32_t w1) {
  return __byte_perm(w0, w1, 0x7531);
}
__device__ __forceinline__ uint32_t low_bytes(uint32_t w0, uint32_t w1) {
  return __byte_perm(w0, w1, 0x6420);
}

// total += 65536 hh + 256 mid + ll, modulo 2^32 for int32 (the total fits)
__device__ __forceinline__ void fold(int& total, int hh, int mid, int ll) {
  total = int(uint32_t(total) + (uint32_t(hh) << 16) + (uint32_t(mid) << 8) + uint32_t(ll));
}
__device__ __forceinline__ void fold(long long& total, int hh, int mid, int ll) {
  total += (long long)hh * 65536 + (long long)mid * 256 + ll;
}

// four consecutive partials (16-byte aligned), read through L2
__device__ __forceinline__ void load4(const int* p, int (&v)[4]) {
  const int4 q = __ldcg(reinterpret_cast<const int4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
// four consecutive outputs of the integer epilogue (16-byte aligned: N % 4 == 0)
__device__ __forceinline__ void store4(int* p, const int (&v)[4]) {
  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(long long* p, const long long (&v)[4]) {
  reinterpret_cast<longlong2*>(p)[0] = make_longlong2(v[0], v[1]);
  reinterpret_cast<longlong2*>(p)[1] = make_longlong2(v[2], v[3]);
}
__device__ __forceinline__ void load4(const long long* p, long long (&v)[4]) {
  const longlong2 a = __ldcg(reinterpret_cast<const longlong2*>(p));
  const longlong2 b = __ldcg(reinterpret_cast<const longlong2*>(p + 2));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// The output: float32, or (int_out) the exact sum in the accumulator's type:
// the integer epilogue of a tensor-parallel K shard, whose sums the shards
// add as integers before the one conversion (engine/modes.py).
template <typename Acc>
__device__ __forceinline__ void store_out(float* out, size_t o, Acc v, int int_out) {
  if (int_out)
    reinterpret_cast<Acc*>(out)[o] = v;
  else
    out[o] = float(v);
}

template <int WN, int MT, typename Acc>
__global__ void __launch_bounds__(kThreads)
packed_matmul_kernel(const int32_t* __restrict__ pa, const int32_t* __restrict__ pb,
                     float* __restrict__ out, Acc* __restrict__ ws, int* __restrict__ counters,
                     int M, int N, int KW, int kw_chunk, int vec, int int_out) {
  using T = Tile<WN, MT>;
  extern __shared__ __align__(16) uint32_t ring[];
  const int tid = threadIdx.x;
  const int n_base = blockIdx.x * T::BN, m_base = blockIdx.y * T::BM;
  const int kw_begin = blockIdx.z * kw_chunk;
  const int kw_end = min(KW, kw_begin + kw_chunk);
  const int stages = kw_end > kw_begin ? (kw_end - kw_begin + kBKW - 1) / kBKW : 0;

  auto load_stage = [&](int st) {
    uint32_t* wt = ring + (st % kStages) * T::kStage;  // [kBKW][kWRow]
    uint32_t* xt = wt + kBKW * T::kWRow;               // [BM][kXRow]
    const int k0 = kw_begin + st * kBKW;
    if (vec) {  // KW % 4 == N % 4 == 0, 16-byte aligned operands
      constexpr int kRowChunks = T::BN / 4;
      for (int c = tid; c < kBKW * kRowChunks; c += kThreads) {
        const int kk = c / kRowChunks, col = (c % kRowChunks) * 4;
        const int k = k0 + kk, j = n_base + col;
        const bool ok = k < kw_end && j < N;
        cp_async16(wt + kk * T::kWRow + col, pb + (ok ? size_t(k) * N + j : 0), ok);
      }
      for (int c = tid; c < T::BM * (kBKW / 4); c += kThreads) {
        const int r = c / (kBKW / 4), col = (c % (kBKW / 4)) * 4;
        const int m = m_base + r, k = k0 + col;
        const bool ok = m < M && k < kw_end;
        cp_async16(xt + r * kXRow + col, pa + (ok ? size_t(m) * KW + k : 0), ok);
      }
    } else {  // ragged shapes: word loads, zeros past the edges
      for (int e = tid; e < kBKW * T::BN; e += kThreads) {
        const int kk = e / T::BN, col = e % T::BN;
        const int k = k0 + kk, j = n_base + col;
        wt[kk * T::kWRow + col] = (k < kw_end && j < N) ? uint32_t(pb[size_t(k) * N + j]) : 0u;
      }
      for (int e = tid; e < T::BM * kBKW; e += kThreads) {
        const int r = e / kBKW, kk = e % kBKW;
        const int m = m_base + r, k = k0 + kk;
        xt[r * kXRow + kk] = (m < M && k < kw_end) ? uint32_t(pa[size_t(m) * KW + k]) : 0u;
      }
    }
  };

  for (int st = 0; st < kStages - 1; ++st) {
    if (st < stages) load_stage(st);
    cp_async_commit();
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n0w = (warp % WN) * 32, m0w = (warp / WN) * 8 * MT;
  Acc total[2][MT][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) total[j][mt][c] = 0;

  for (int st = 0; st < stages; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this stage landed; the previous one is consumed
    if (st + kStages - 1 < stages) load_stage(st + kStages - 1);
    cp_async_commit();
    const uint32_t* wt = ring + (st % kStages) * T::kStage;
    const uint32_t* xt = wt + kBKW * T::kWRow;
#pragma unroll
    for (int step = 0; step < kBKW; step += 16) {
      // Lane t reads words step + t + 4p, p = 0..3, on both operands: the
      // lanes of words p = 0, 1 are the MMA's logical K 4t..4t+3, those of
      // p = 2, 3 its K 16+4t..16+4t+3.
      uint32_t w[4][4];  // [p][column 4g + i]
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const uint4 q =
            *reinterpret_cast<const uint4*>(wt + (step + t + 4 * p) * T::kWRow + n0w + 4 * g);
        w[p][0] = q.x;
        w[p][1] = q.y;
        w[p][2] = q.z;
        w[p][3] = q.w;
      }
      uint32_t ah[2][4], al[2][4];  // [tile j][register]: column 4g + 2j + r is row g + 8r
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = i >> 1, r = i & 1;
        ah[j][r] = high_bytes(w[0][i], w[1][i]);
        al[j][r] = low_bytes(w[0][i], w[1][i]);
        ah[j][2 + r] = high_bytes(w[2][i], w[3][i]);
        al[j][2 + r] = low_bytes(w[2][i], w[3][i]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t* xr = xt + (m0w + 8 * mt + g) * kXRow + step + t;
        const uint32_t x0 = xr[0], x1 = xr[4], x2 = xr[8], x3 = xr[12];
        const uint32_t bh[2] = {high_bytes(x0, x1), high_bytes(x2, x3)};
        const uint32_t bl[2] = {low_bytes(x0, x1), low_bytes(x2, x3)};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          int hh[4] = {0, 0, 0, 0}, mid[4] = {0, 0, 0, 0}, ll[4] = {0, 0, 0, 0};
          mma_s8_s8(hh, ah[j], bh);
          mma_s8_u8(mid, ah[j], bl);
          mma_u8_s8(mid, al[j], bh);
          mma_u8_u8(ll, al[j], bl);
#pragma unroll
          for (int c = 0; c < 4; ++c) fold(total[j][mt][c], hh[c], mid[c], ll[c]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // C fragment c of tile (j, mt): weight column 4g + 2j + (c >> 1), token 2t + (c & 1)
  const size_t plane = size_t(M) * N;
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = n_base + n0w + 4 * g + 2 * j + (c >> 1);
        const int m = m_base + m0w + 8 * mt + 2 * t + (c & 1);
        if (m >= M || col >= N) continue;
        const size_t o = size_t(m) * N + col;
        if (split)
          ws[blockIdx.z * plane + o] = total[j][mt][c];
        else
          store_out(out, o, total[j][mt][c], int_out);
      }
  if (!split) return;

  // the last block of this tile to finish sums the partials in split order
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (!split_k_last(counters, tile, gridDim.z)) return;
  // Each thread owns kGroups runs of four outputs; the loads of all its
  // runs for split s + 1 are in flight while split s is added.  The sums
  // stay in Acc: int32 holds the total wherever wide_accumulator says no.
  const int splits = gridDim.z;
  if ((N & 3) == 0) {
    constexpr int kGroups = T::BM * T::BN / (4 * kThreads);
    Acc sum[kGroups][4], next[kGroups][4];
    size_t off[kGroups];
    bool ok[kGroups];
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int e = 4 * (tid + i * kThreads);
      const int m = m_base + e / T::BN, col = n_base + e % T::BN;
      ok[i] = m < M && col < N;
      off[i] = ok[i] ? size_t(m) * N + col : 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[i][c] = next[i][c] = 0;
      if (ok[i]) load4(ws + off[i], next[i]);
    }
    for (int s = 0; s < splits; ++s) {
      Acc part[kGroups][4];
#pragma unroll
      for (int i = 0; i < kGroups; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[i][c] = next[i][c];
      if (s + 1 < splits) {
#pragma unroll
        for (int i = 0; i < kGroups; ++i)
          if (ok[i]) load4(ws + (s + 1) * plane + off[i], next[i]);
      }
#pragma unroll
      for (int i = 0; i < kGroups; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) sum[i][c] += part[i][c];
    }
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      if (!ok[i]) continue;
      if (int_out) {
        store4(reinterpret_cast<Acc*>(out) + off[i], sum[i]);
      } else {
        *reinterpret_cast<float4*>(out + off[i]) =
            make_float4(float(sum[i][0]), float(sum[i][1]), float(sum[i][2]), float(sum[i][3]));
      }
    }
  } else {  // ragged N: one output at a time
    for (int e = tid; e < T::BM * T::BN; e += kThreads) {
      const int m = m_base + e / T::BN, col = n_base + e % T::BN;
      if (m >= M || col >= N) continue;
      const size_t o = size_t(m) * N + col;
      long long sum = 0;
      for (int s = 0; s < splits; ++s) sum += __ldcg(ws + s * plane + o);
      if (int_out)
        reinterpret_cast<Acc*>(out)[o] = Acc(sum);
      else
        out[o] = __ll2float_rn(sum);
    }
  }
  split_k_release(counters, tile);
}

template <int WN, int MT, typename Acc>
cudaError_t launch(const void* pa, const void* pb, void* out, void* ws, void* counters, int M,
                   int N, int KW, int splits, int kw_chunk, int vec, int int_out,
                   cudaStream_t stream) {
  using T = Tile<WN, MT>;
  if ((M + T::BM - 1) / T::BM > 65535) return cudaErrorInvalidValue;
  auto kernel = packed_matmul_kernel<WN, MT, Acc>;
  // the attribute once per kernel and device, not once per launch
  static bool sized[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !sized[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(T::kSmem));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) sized[dev] = true;
  }
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, splits);
  kernel<<<grid, kThreads, T::kSmem, stream>>>(
      static_cast<const int32_t*>(pa), static_cast<const int32_t*>(pb), static_cast<float*>(out),
      static_cast<Acc*>(ws), static_cast<int*>(counters), M, N, KW, kw_chunk, vec, int_out);
  return cudaGetLastError();
}

template <typename Acc>
cudaError_t launch_acc(const void* pa, const void* pb, void* out, void* ws, void* counters,
                       int M, int N, int KW, int bm, int splits, int kw_chunk, int vec,
                       int int_out, cudaStream_t s) {
  if (bm == 8) return launch<4, 1, Acc>(pa, pb, out, ws, counters, M, N, KW, splits, kw_chunk, vec, int_out, s);
  if (bm == 32) return launch<2, 2, Acc>(pa, pb, out, ws, counters, M, N, KW, splits, kw_chunk, vec, int_out, s);
  if (bm == 64) return launch<2, 4, Acc>(pa, pb, out, ws, counters, M, N, KW, splits, kw_chunk, vec, int_out, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// bm picks the tile (kernels/packed_matmul.py TILES): 8 -> 128 columns x 8
// tokens, 32 -> 64 x 32, 64 -> 64 x 64.  splits * kw_chunk words cover KW;
// one step's plane sums stay far inside int32 at any chunk; int_out: out
// holds M * N int32 (int64 if wide_acc) exact sums in place of float32.
extern "C" int packed_matmul_launch(const void* pa, const void* pb, void* out, void* ws,
                                    void* counters, int M, int N, int KW, int bm, int splits,
                                    int kw_chunk, int vec, int wide_acc, int int_out, int device,
                                    void* stream) {
  if (M < 1 || N < 1 || KW < 0 || splits < 1 || splits > 65535 || kw_chunk < kBKW ||
      kw_chunk % kBKW != 0 || (long long)splits * kw_chunk < KW ||
      (splits > 1 && ((long long)(splits - 1) * kw_chunk >= KW || ws == nullptr ||
                      counters == nullptr)))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const auto s = static_cast<cudaStream_t>(stream);
  err = wide_acc
            ? launch_acc<long long>(pa, pb, out, ws, counters, M, N, KW, bm, splits, kw_chunk, vec,
                                    int_out, s)
            : launch_acc<int>(pa, pb, out, ws, counters, M, N, KW, bm, splits, kw_chunk, vec, int_out,
                              s);
  return int(err);
}

// The launch packed_matmul_launch makes for these arguments: out[0..2] the
// grid, out[3] the threads, out[4] the dynamic shared memory in bytes
// (kernels/packed_matmul.py built_launch_plan holds launch_plan to it).
template <int WN, int MT>
void plan_of(int M, int N, int splits, long long* out) {
  using T = Tile<WN, MT>;
  const long long plan[5] = {(N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, splits, kThreads,
                             (long long)T::kSmem};
  for (int i = 0; i < 5; ++i) out[i] = plan[i];
}

extern "C" int packed_matmul_plan(int M, int N, int KW, int bm, int splits, int kw_chunk,
                                  long long* out) {
  if (M < 1 || N < 1 || KW < 0 || splits < 1 || splits > 65535 || kw_chunk < kBKW ||
      kw_chunk % kBKW != 0 || (long long)splits * kw_chunk < KW ||
      (splits > 1 && (long long)(splits - 1) * kw_chunk >= KW))
    return int(cudaErrorInvalidValue);
  if (bm == 8) plan_of<4, 1>(M, N, splits, out);
  else if (bm == 32) plan_of<2, 2>(M, N, splits, out);
  else if (bm == 64) plan_of<2, 4>(M, N, splits, out);
  else return int(cudaErrorInvalidValue);
  return 0;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
