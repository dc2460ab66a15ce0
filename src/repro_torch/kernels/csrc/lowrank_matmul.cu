// lowrank_matmul.cu: the `lowrank` GEMM, exact product plus the rank-r
// SVD correction of the approximate multiplier's error.
//
// Replaces: src/repro/kernels/lowrank_matmul.py `_kernel` (pallas_call at
// :75, entry lowrank_matmul_pallas at :91).
//
// Computes out[m, j] = float(sum_k a[m,k] * b[k,j])
//                    + sum_k sum_r sa[m,k] U[|a[m,k]|, r] * sb[k,j] V[|b[k,j]|, r]
// for sign-magnitude operands (magnitudes uint8 clamped to 2^n - 1, signs
// int8 in {-1, 0, 1}, a = sa * |a|), with U, V the (2^n, rank) float32 SVD
// factors of the error table (n <= 8).  This is the reference's
// `A@B + Ue' @ Ve'` with Ue' = sa * U[|a|] (M, K*r), Ve' = sb * V[|b|].
//
// What bounds it on the H100.  The correction is 2*M*K*N*r FLOPs; on the
// tensor cores as three TF32 products (below) that is 6*M*K*N*r at 495
// TFLOP/s, 0.039 ms at (M, K, N, r) = (128, 1024, 3072, 8).  The operands
// are 2 bytes per element (magnitude and sign), so at decode (M = 4) the
// weight's bytes bound it instead (1-3 us at 3.35 TB/s).  In practice the
// kernel is bound by the instructions that feed the MMAs: every K step a
// lane loads its entries and six to eight table rows and assembles the
// fragments, several instructions per mma.sync (PERF.md, PR 15).
//
// Tiles.  Each block owns a BM x BN output tile and one K slice.  Warps
// are 16 * MT tokens by 32 weight columns: tokens are the MMA's rows (A),
// weight columns its columns (B), and MMA column g of n-tile j is weight
// column 4g + j of the warp's 32, so a lane's four columns are adjacent.
// The magnitude and sign tiles of each K step of 32 are staged with
// cp.async in a ring of kStages (the next steps' copies in flight while
// this one computes).  When a stage lands, each element is converted once
// for the whole block: into its int8 planes and into a uint16 table entry.
//
// Exact part, int8 tensor cores.  |x| = 128 h + l splits each operand
// into two signed int8 planes, s*h in {-1, 0, 1} and s*l in [-127, 127]
// (byte-SIMD; the weight's planes transposed to K-contiguous rows).
// a*b = 16384 hh + 128 (hl + lh) + ll: four mma.sync.m16n8k32.s8.s8 per
// tile and step, folded into one int32 sum per output.  The host sizes
// each block's K slice so that K_slice * (2^n - 1)^2 < 2^31
// (kernels/lowrank_matmul.py `max_k_chunk`): the block's partial is exact
// in int32, the split-K partials are summed in int64, and the total is
// converted to float32 once, as the plain version converts its float64
// sum.  Bit-equal to the plain version's exact part.
//
// Correction, split TF32 on the tensor cores.  Both (2^n, r) tables sit
// in shared memory as (hi, lo) pairs, hi = tf32(x), lo = tf32(x - hi),
// with a zero row (32 KiB for both at n = 8, r = 8).  A table entry names
// the row of an element (its clamped magnitude, or the zero row for sign
// 0) and its sign.  Per K step a lane loads the table row pairs its
// fragments need, one 16-byte load each, flips their sign bits where the
// entry says (a weight row's load is then its B fragment as it is), and
// the MMA m16n8k8 .tf32 runs
// lo*hi + hi*lo + hi*hi (lo*lo, about 2^-22 of a product, is dropped).
// Each product then carries a relative error near 2^-21; the tensor
// core's float32 accumulation truncates, so a fresh accumulator takes
// kFlush = 16 K steps and is then added (round to nearest) to the running
// float32 sum: the truncation error stays relative to 16 steps' sum, not
// to the whole K, where it would grow with K * ulp(sum).  The plain
// version sums in float32 in another order; the two agree within
// 2e-6 * max|want| (chip_smoke.py, tests/test_torch_gpu.py).
//
// The planes, table entries, gathers, table fill and MMAs are the device
// routines of lowrank_tiles.cuh, shared with approx_attention.cu.
//
// Split K, fixed order.  At decode the output has 8-24 tiles for 132 SMs,
// so the host splits K over gridDim.z (up to one wave of two blocks per
// SM, K slices of at least 64).  Every block writes its int32 partial and
// float32 correction to the workspace [split][M][N]; the last block of a
// tile to finish (a counter per tile, split_k.cuh) sums
// the partials in split order 0, 1, ..., converts, writes the output and
// resets its counter to 0, so the next launch finds it zeroed.  No float
// atomics: two launches on the same inputs give the same bits.  One
// launch, no memset; the counters are zeroed once when the host first
// allocates them, and launches on one stream never overlap.

#include <cstdint>
#include <cuda_runtime.h>

#include "lowrank_tiles.cuh"
#include "split_k.cuh"

namespace {

constexpr int kThreads = 128;   // four warps
constexpr int kBK = 32;         // K per stage: one m16n8k32 step, 32 m16n8k8 steps
constexpr int kStages = 3;      // cp.async ring depth
constexpr int kFlush = 16;      // K steps per tensor-core partial of the correction
constexpr int kXRow = 48;       // bytes per token row of a raw tile (32 + pad: no bank conflict)
constexpr int kWPlaneRow = 40;  // bytes per weight column of a plane tile (32 + pad)
constexpr int kXPlaneRow = 32;  // bytes per token row of a plane tile
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;

// WM warps along M (16 * MT tokens each), 4 / WM along N (32 weight columns each)
template <int WM, int MT>
struct Tile {
  static constexpr int kWarpsN = 4 / WM;
  static constexpr int BM = 16 * MT * WM;
  static constexpr int BN = 32 * kWarpsN;
  static constexpr int kWRaw = kBK * BN;    // bytes of one raw weight array (magnitude or sign)
  static constexpr int kXRaw = BM * kXRow;  // bytes of one raw token array
  static constexpr int kStage = 2 * kWRaw + 2 * kXRaw;
  static constexpr int kPlanes = 2 * BN * kWPlaneRow + 2 * BM * kXPlaneRow;
  static constexpr int kEntries = 2 * kBK * (BN + BM);  // uint16 table-row entries
};

// both tables as (hi, lo) float pairs, 2^n rows and a zero row; kept in
// step with kernels/lowrank_matmul.py `smem_bytes`
__host__ __device__ size_t table_bytes(int side, int r8) { return size_t(16) * (side + 1) * r8; }

template <int WM, int MT>
size_t smem_bytes(int side, int r8) {
  using T = Tile<WM, MT>;
  return table_bytes(side, r8) + size_t(kStages) * T::kStage + T::kPlanes + T::kEntries;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // src-size 0 fills the 16 bytes with zeros: magnitude 0 and sign 0 add 0
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int WM, int MT>
__global__ void __launch_bounds__(kThreads)
lowrank_matmul_kernel(const float* __restrict__ u, const float* __restrict__ v,
                      const uint8_t* __restrict__ mag_a, const int8_t* __restrict__ sign_a,
                      const uint8_t* __restrict__ mag_b, const int8_t* __restrict__ sign_b,
                      float* __restrict__ out, int* __restrict__ ws_int,
                      float* __restrict__ ws_corr, int* __restrict__ counters, int M, int N,
                      int K, int n, int rank, int k_chunk, int vec) {
  using T = Tile<WM, MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int side = 1 << n, qmax = side - 1;
  const int r8 = (rank + 7) & ~7;
  const int row_f = 2 * r8;  // floats per table row: (hi, lo) per r
  float* utab = reinterpret_cast<float*>(smem);  // [side + 1][row_f], row `side` zero
  float* vtab = utab + (side + 1) * row_f;
  unsigned char* ring = smem + table_bytes(side, r8);
  unsigned char* wph = ring + kStages * T::kStage;  // [BN][kWPlaneRow] weight s*h
  unsigned char* wpl = wph + T::BN * kWPlaneRow;   // weight s*l
  unsigned char* xph = wpl + T::BN * kWPlaneRow;   // [BM][kXPlaneRow] token s*h
  unsigned char* xpl = xph + T::BM * kXPlaneRow;   // token s*l
  uint16_t* went = reinterpret_cast<uint16_t*>(xpl + T::BM * kXPlaneRow);  // [kBK][BN]
  uint16_t* xent = went + kBK * T::BN;  // [kBK][BM]: tokens g and g + 8 of a 16 adjacent

  const int tid = threadIdx.x;
  const int n_base = blockIdx.x * T::BN, m_base = blockIdx.y * T::BM;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int stages = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  fill_tables<kThreads>(utab, vtab, u, v, side, rank, r8, tid);

  auto load_stage = [&](int st) {
    unsigned char* base = ring + (st % kStages) * T::kStage;
    unsigned char* wm = base;
    unsigned char* wsg = wm + T::kWRaw;
    unsigned char* xm = wsg + T::kWRaw;
    unsigned char* xsg = xm + T::kXRaw;
    const int k0 = k_begin + st * kBK;
    if (vec) {  // K % 16 == N % 16 == 0, 16-byte aligned operands
      constexpr int kRowChunks = T::BN / 16;
      for (int c = tid; c < kBK * kRowChunks; c += kThreads) {
        const int kk = c / kRowChunks, col = (c % kRowChunks) * 16;
        const int k = k0 + kk, j = n_base + col;
        const bool ok = k < k_end && j < N;
        const size_t off = ok ? size_t(k) * N + j : 0;
        cp_async16(wm + kk * T::BN + col, mag_b + off, ok);
        cp_async16(wsg + kk * T::BN + col, sign_b + off, ok);
      }
      for (int c = tid; c < T::BM * 2; c += kThreads) {
        const int r = c >> 1, col = (c & 1) * 16;
        const int m = m_base + r, k = k0 + col;
        const bool ok = m < M && k < k_end;
        const size_t off = ok ? size_t(m) * K + k : 0;
        cp_async16(xm + r * kXRow + col, mag_a + off, ok);
        cp_async16(xsg + r * kXRow + col, sign_a + off, ok);
      }
    } else {  // ragged shapes: byte loads, zeros past the edges
      for (int e = tid; e < kBK * T::BN; e += kThreads) {
        const int k = k0 + e / T::BN, j = n_base + e % T::BN;
        const bool ok = k < k_end && j < N;
        const size_t off = size_t(k) * N + j;
        wm[e] = ok ? mag_b[off] : 0;
        wsg[e] = ok ? uint8_t(sign_b[off]) : 0;
      }
      for (int e = tid; e < T::BM * kBK; e += kThreads) {
        const int r = e / kBK, kk = e % kBK;
        const int m = m_base + r, k = k0 + kk;
        const bool ok = m < M && k < k_end;
        const size_t off = size_t(m) * K + k;
        xm[r * kXRow + kk] = ok ? mag_a[off] : 0;
        xsg[r * kXRow + kk] = ok ? uint8_t(sign_a[off]) : 0;
      }
    }
  };

  for (int st = 0; st < kStages - 1; ++st) {
    if (st < stages) load_stage(st);
    cp_async_commit();
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n0w = (warp % T::kWarpsN) * 32, m0w = (warp / T::kWarpsN) * 16 * MT;
  const uint32_t qmax4 = 0x01010101u * uint32_t(qmax);
  float acc[MT][4][4], part[MT][4][4];
  int iacc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[mt][j][c] = 0.f;
        part[mt][j][c] = 0.f;
        iacc[mt][j][c] = 0;
      }

  for (int st = 0; st < stages; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this stage landed; the previous stage's tiles, planes and entries are consumed
    if (st + kStages - 1 < stages) load_stage(st + kStages - 1);
    cp_async_commit();
    const unsigned char* wm = ring + (st % kStages) * T::kStage;
    const unsigned char* wsg = wm + T::kWRaw;
    const unsigned char* xm = wsg + T::kWRaw;
    const unsigned char* xsg = xm + T::kXRaw;

    // Once per stage and element: the int8 planes (the weight's 4 x 4 byte
    // blocks transposed to K-contiguous rows) and the table entries.
    for (int b = tid; b < (kBK / 4) * (T::BN / 4); b += kThreads) {
      const int kb = b / (T::BN / 4), nb = b % (T::BN / 4);
      uint32_t h[4], l[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int off = (4 * kb + i) * T::BN + 4 * nb;
        const uint32_t mw = *reinterpret_cast<const uint32_t*>(wm + off);
        const uint32_t sw = *reinterpret_cast<const uint32_t*>(wsg + off);
        split_planes(mw, sw, qmax4, h[i], l[i]);
        *reinterpret_cast<uint2*>(went + off) =
            make_uint2(table_entry(mw, sw, 0, qmax) | table_entry(mw, sw, 1, qmax) << 16,
                       table_entry(mw, sw, 2, qmax) | table_entry(mw, sw, 3, qmax) << 16);
      }
      transpose4(h);
      transpose4(l);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<uint32_t*>(wph + (4 * nb + i) * kWPlaneRow + 4 * kb) = h[i];
        *reinterpret_cast<uint32_t*>(wpl + (4 * nb + i) * kWPlaneRow + 4 * kb) = l[i];
      }
    }
    for (int w = tid; w < T::BM * (kBK / 4); w += kThreads) {
      const int r = w / (kBK / 4), c = w % (kBK / 4);
      const uint32_t mw = *reinterpret_cast<const uint32_t*>(xm + r * kXRow + 4 * c);
      const uint32_t sw = *reinterpret_cast<const uint32_t*>(xsg + r * kXRow + 4 * c);
      uint32_t h, l;
      split_planes(mw, sw, qmax4, h, l);
      *reinterpret_cast<uint32_t*>(xph + r * kXPlaneRow + 4 * c) = h;
      *reinterpret_cast<uint32_t*>(xpl + r * kXPlaneRow + 4 * c) = l;
      const int pos = (r & ~15) + (r & 7) * 2 + ((r >> 3) & 1);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xent[(4 * c + e) * T::BM + pos] = table_entry(mw, sw, e, qmax);
    }
    __syncthreads();

    // Exact part: tokens are the MMA's rows (A), weight columns its
    // columns (B); MMA column g of tile j is weight column 4g + j of the
    // warp's 32.  Lane t's K bytes 8t..8t+7 are the MMA's logical K
    // 4t..4t+3 (first word) and 16+4t..16+4t+3 (second), on both operands.
    {
      uint32_t xa[2][MT][4], wb[2][4][2];  // [plane h, l][tile][register]
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g + 8
          const int off = (m0w + 16 * mt + 8 * h + g) * kXPlaneRow + 8 * t;
          const uint2 hv = *reinterpret_cast<const uint2*>(xph + off);
          const uint2 lv = *reinterpret_cast<const uint2*>(xpl + off);
          xa[0][mt][h] = hv.x;
          xa[0][mt][2 + h] = hv.y;
          xa[1][mt][h] = lv.x;
          xa[1][mt][2 + h] = lv.y;
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int off = (n0w + 4 * g + j) * kWPlaneRow + 8 * t;
        const uint2 hv = *reinterpret_cast<const uint2*>(wph + off);
        const uint2 lv = *reinterpret_cast<const uint2*>(wpl + off);
        wb[0][j][0] = hv.x;
        wb[0][j][1] = hv.y;
        wb[1][j][0] = lv.x;
        wb[1][j][1] = lv.y;
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int hh[4] = {0, 0, 0, 0}, mid[4] = {0, 0, 0, 0}, ll[4] = {0, 0, 0, 0};
          mma_s8(hh, xa[0][mt], wb[0][j]);
          mma_s8(mid, xa[0][mt], wb[1][j]);
          mma_s8(mid, xa[1][mt], wb[0][j]);
          mma_s8(ll, xa[1][mt], wb[1][j]);
#pragma unroll
          for (int c = 0; c < 4; ++c) iacc[mt][j][c] += 16384 * hh[c] + 128 * mid[c] + ll[c];
        }
    }

    // Correction: per K step, the (hi, lo) table pairs of each lane's
    // entries straight into the fragments.  A (tokens) takes rows g and
    // g + 8, B (weight) its column; logical K column t / t + 4 is
    // r = 8q + 2t / + 1, so a weight row's load is its B fragment as it is.
    // Four K steps at a time: their entries first, then for each block of
    // 8 r their gathers and MMAs in one straight run, so that the next
    // steps' loads overlap this step's MMAs.
#pragma unroll 1
    for (int k4 = 0; k4 < kBK; k4 += 4) {
      uint2 we[4];
      uint32_t xe[4][MT];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        we[e] = *reinterpret_cast<const uint2*>(went + (k4 + e) * T::BN + n0w + 4 * g);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          xe[e][mt] = *reinterpret_cast<const uint32_t*>(xent + (k4 + e) * T::BM + m0w +
                                                         16 * mt + 2 * g);
      }
      for (int q = 0; q < r8 / 8; ++q) {
        const int off = q * 16 + 4 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint4 wv[4], xv[MT][2];
          wv[0] = gather(vtab, row_f, we[e].x & 0xffffu, off);
          wv[1] = gather(vtab, row_f, we[e].x >> 16, off);
          wv[2] = gather(vtab, row_f, we[e].y & 0xffffu, off);
          wv[3] = gather(vtab, row_f, we[e].y >> 16, off);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            xv[mt][0] = gather(utab, row_f, xe[e][mt] & 0xffffu, off);
            xv[mt][1] = gather(utab, row_f, xe[e][mt] >> 16, off);
          }
          // lo * hi, hi * lo, then hi * hi, each over every tile first
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_tf32(part[mt][j], xv[mt][0].z, xv[mt][1].z, xv[mt][0].w, xv[mt][1].w,
                       wv[j].x, wv[j].y);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_tf32(part[mt][j], xv[mt][0].x, xv[mt][1].x, xv[mt][0].y, xv[mt][1].y,
                       wv[j].z, wv[j].w);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_tf32(part[mt][j], xv[mt][0].x, xv[mt][1].x, xv[mt][0].y, xv[mt][1].y,
                       wv[j].x, wv[j].y);
        }
      }
      if ((k4 + 4) % kFlush == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[mt][j][c] = __fadd_rn(acc[mt][j][c], part[mt][j][c]);
              part[mt][j][c] = 0.f;
            }
      }
    }
  }
  cp_async_wait<0>();

  // C fragment c of tile (mt, j): token 16 mt + g + 8 (c >> 1), weight
  // column 4 (2t + (c & 1)) + j
  const size_t plane = size_t(M) * N;
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = m_base + m0w + 16 * mt + g + 8 * (c >> 1);
        const int col = n_base + n0w + 4 * (2 * t + (c & 1)) + j;
        if (m >= M || col >= N) continue;
        const size_t o = size_t(m) * N + col;
        if (split) {
          ws_int[blockIdx.z * plane + o] = iacc[mt][j][c];
          ws_corr[blockIdx.z * plane + o] = acc[mt][j][c];
        } else {
          out[o] = __fadd_rn(__int2float_rn(iacc[mt][j][c]), acc[mt][j][c]);
        }
      }
  if (!split) return;

  // the last block of this tile to finish sums the partials in split order
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (!split_k_last(counters, tile, gridDim.z)) return;
  // Each thread owns kGroups runs of four outputs; for each split, the
  // loads of all its runs are issued together, then added in split order
  // 0, 1, 2, ... (the float32 sums' order is fixed).
  const int splits = gridDim.z;
  if ((N & 3) == 0) {
    constexpr int kGroups = T::BM * T::BN / (4 * kThreads);
    long long isum[kGroups][4];
    float csum[kGroups][4];
    size_t off[kGroups];
    bool ok[kGroups];
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int e = 4 * (tid + i * kThreads);
      const int m = m_base + e / T::BN, col = n_base + e % T::BN;
      ok[i] = m < M && col < N;
      off[i] = ok[i] ? size_t(m) * N + col : 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        isum[i][c] = 0;
        csum[i][c] = 0.f;
      }
    }
    for (int s = 0; s < splits; ++s) {
      int4 iv[kGroups];
      float4 cv[kGroups];
#pragma unroll
      for (int i = 0; i < kGroups; ++i) {
        iv[i] = ok[i] ? __ldcg(reinterpret_cast<const int4*>(ws_int + s * plane + off[i]))
                      : make_int4(0, 0, 0, 0);
        cv[i] = ok[i] ? __ldcg(reinterpret_cast<const float4*>(ws_corr + s * plane + off[i]))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < kGroups; ++i) {
        isum[i][0] += iv[i].x;
        isum[i][1] += iv[i].y;
        isum[i][2] += iv[i].z;
        isum[i][3] += iv[i].w;
        csum[i][0] = __fadd_rn(csum[i][0], cv[i].x);
        csum[i][1] = __fadd_rn(csum[i][1], cv[i].y);
        csum[i][2] = __fadd_rn(csum[i][2], cv[i].z);
        csum[i][3] = __fadd_rn(csum[i][3], cv[i].w);
      }
    }
#pragma unroll
    for (int i = 0; i < kGroups; ++i)
      if (ok[i])
        *reinterpret_cast<float4*>(out + off[i]) = make_float4(
            __fadd_rn(__ll2float_rn(isum[i][0]), csum[i][0]),
            __fadd_rn(__ll2float_rn(isum[i][1]), csum[i][1]),
            __fadd_rn(__ll2float_rn(isum[i][2]), csum[i][2]),
            __fadd_rn(__ll2float_rn(isum[i][3]), csum[i][3]));
  } else {  // ragged N: one output at a time
    for (int e = tid; e < T::BM * T::BN; e += kThreads) {
      const int m = m_base + e / T::BN, col = n_base + e % T::BN;
      if (m >= M || col >= N) continue;
      const size_t o = size_t(m) * N + col;
      long long isum = 0;
      float csum = 0.f;
      for (int s = 0; s < splits; ++s) {
        isum += __ldcg(ws_int + s * plane + o);
        csum = __fadd_rn(csum, __ldcg(ws_corr + s * plane + o));
      }
      out[o] = __fadd_rn(__ll2float_rn(isum), csum);
    }
  }
  split_k_release(counters, tile);
}

template <int WM, int MT>
cudaError_t launch(const void* u, const void* v, const void* ma, const void* sa, const void* mb,
                   const void* sb, void* out, void* ws_int, void* ws_corr, void* counters, int M,
                   int N, int K, int n, int rank, int splits, int k_chunk, int vec,
                   cudaStream_t stream) {
  using T = Tile<WM, MT>;
  const size_t smem = smem_bytes<WM, MT>(1 << n, (rank + 7) & ~7);
  if (smem > size_t(kMaxSmem) || (M + T::BM - 1) / T::BM > 65535) return cudaErrorInvalidValue;
  auto kernel = lowrank_matmul_kernel<WM, MT>;
  // the largest footprint allowed so far on each device: the attribute is
  // set when a launch needs more, not once per launch
  static size_t sized[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || smem > sized[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) sized[dev] = smem;
  }
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<const uint8_t*>(ma), static_cast<const int8_t*>(sa),
      static_cast<const uint8_t*>(mb), static_cast<const int8_t*>(sb), static_cast<float*>(out),
      static_cast<int*>(ws_int), static_cast<float*>(ws_corr), static_cast<int*>(counters), M,
      N, K, n, rank, k_chunk, vec);
  return cudaGetLastError();
}

}  // namespace

// bm picks the tile (kernels/lowrank_matmul.py TILES): 16 tokens x 128
// columns, 32 x 64 or 64 x 64.  splits * k_chunk covers K; each
// slice's int32 partial must be exact.
extern "C" int lowrank_matmul_launch(const void* u, const void* v, const void* mag_a,
                                     const void* sign_a, const void* mag_b, const void* sign_b,
                                     void* out, void* ws_int, void* ws_corr, void* counters,
                                     int M, int N, int K, int n, int rank, int bm, int splits,
                                     int k_chunk, int vec, int device, void* stream) {
  const long long qmax = (1LL << n) - 1;
  if (n < 1 || n > 8 || rank < 1 || M < 1 || N < 1 || K < 0 || splits < 1 || splits > 65535 ||
      k_chunk < kBK || k_chunk % kBK != 0 || (long long)splits * k_chunk < K ||
      (splits > 1 && (long long)(splits - 1) * k_chunk >= K) ||
      (long long)k_chunk * qmax * qmax >= (1LL << 31) ||
      (splits > 1 && (ws_int == nullptr || ws_corr == nullptr || counters == nullptr)))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const auto s = static_cast<cudaStream_t>(stream);
  if (bm == 16)
    err = launch<1, 1>(u, v, mag_a, sign_a, mag_b, sign_b, out, ws_int, ws_corr, counters, M, N,
                       K, n, rank, splits, k_chunk, vec, s);
  else if (bm == 32)
    err = launch<2, 1>(u, v, mag_a, sign_a, mag_b, sign_b, out, ws_int, ws_corr, counters, M, N,
                       K, n, rank, splits, k_chunk, vec, s);
  else if (bm == 64)
    err = launch<2, 2>(u, v, mag_a, sign_a, mag_b, sign_b, out, ws_int, ws_corr, counters, M, N,
                       K, n, rank, splits, k_chunk, vec, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

// The launch lowrank_matmul_launch makes for these arguments: out[0..2]
// the grid, out[3] the threads, out[4] the dynamic shared memory in bytes
// (kernels/lowrank_matmul.py built_launch_plan holds launch_plan to it).
template <int WM, int MT>
void plan_of(int M, int N, int n, int rank, int splits, long long* out) {
  using T = Tile<WM, MT>;
  const long long plan[5] = {(N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, splits, kThreads,
                             (long long)smem_bytes<WM, MT>(1 << n, (rank + 7) & ~7)};
  for (int i = 0; i < 5; ++i) out[i] = plan[i];
}

extern "C" int lowrank_matmul_plan(int M, int N, int K, int n, int rank, int bm, int splits,
                                   int k_chunk, long long* out) {
  const long long qmax = (1LL << n) - 1;
  if (n < 1 || n > 8 || rank < 1 || M < 1 || N < 1 || K < 0 || splits < 1 || splits > 65535 ||
      k_chunk < kBK || k_chunk % kBK != 0 || (long long)splits * k_chunk < K ||
      (splits > 1 && (long long)(splits - 1) * k_chunk >= K) ||
      (long long)k_chunk * qmax * qmax >= (1LL << 31))
    return int(cudaErrorInvalidValue);
  if (bm == 16) plan_of<1, 1>(M, N, n, rank, splits, out);
  else if (bm == 32) plan_of<2, 1>(M, N, n, rank, splits, out);
  else if (bm == 64) plan_of<2, 2>(M, N, n, rank, splits, out);
  else return int(cudaErrorInvalidValue);
  return 0;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
