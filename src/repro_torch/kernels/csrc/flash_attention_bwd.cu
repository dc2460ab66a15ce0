// flash_attention_bwd.cu: the FlashAttention-2 backward of flash_attention.cu's
// prefill forward (and of approx_attention.cu's, which is straight-through:
// the same exact backward runs on the approximate forward's o and lse).
//
// Replaces: src/repro/kernels/flash_attention.py `_dq_kernel` (:126,
// pallas_call at :205) and `_dkv_kernel` (:158, pallas_call at :224), both
// launched by `_bwd` (:193).
//
// Both recompute, per query row with position qp and key slot j with
// position kp[j]:  raw = (q . k_j) * scale;  s = tanh(raw / softcap) *
// softcap when softcap != 0 (else raw);  s = NEG_INF where the slot is not
// allowed (kp < 0, causal and qp < kp, a window and qp - kp >= window);
// p = exp(s - lse);  dp = do . v_j;  ds = p (dp - dd) (1 - tanh^2 under
// softcap), 0 where not allowed.  lse (B, H, S) is the forward's residual
// m + log(max(l, 1e-30)) and dd = sum(do * o) (B, H, S) is computed by the
// caller, as `_bwd` does at :201.  Query head h reads KV head h / g.
//
//   dq_i  = scale * sum_j ds_ij k_j            (`_dq_kernel`)
//   dk_j  = scale * sum_{h in group, i} ds_ij q_i,
//   dv_j  = sum_{h in group, i} p_ij do_i      (`_dkv_kernel`)
//
// NEG_INF is the reference's finite -2.3819763e38.  A query row with no
// allowed slot (a left pad) has lse = NEG_INF + log T = NEG_INF in float32,
// so p = exp(NEG_INF - NEG_INF) = 1 on every slot.  Its ds is masked to 0,
// but p is not: as in the reference (`_dkv_kernel` :184 does not mask
// p.T @ do), dv_j receives that row's do with weight 1 at every slot j,
// the unwritten ones too.  Rows past S and slots past T do not exist and
// add nothing.
//
// What bounds it on the H100.  Five products per allowed (query head,
// slot) pair, each 2*hd FLOPs: QK^T and dO.V^T in both kernels, dS.K (dq),
// dS^T.Q and P^T.dO (dk/dv).  On the bf16 tensor cores with the splits
// below (5 bf16 MMA products per pair in dq, 8 in dk/dv) that is 3.5 GFLOP
// at the train shape (B 8, S = T = 128, causal, 16 query and 8 KV heads of
// 128), 3.6 us at 989 TFLOP/s, against 34 MB of operands and outputs read
// or written once (10 us at 3.35 TB/s): bytes bound it there.  At S = T =
// 1024 (B 1) the products take 28 us and the same bytes 10 us.  At head
// width 256 (gemma2-9b's 16 / 8 heads) both double: 7.0 GFLOP (7.1 us)
// against 67 MB (20 us) at the train shape, 56 us against 20 us at 1024.
//
// Tensor cores with float32-accurate products.  The reference computes the
// backward in float32; one bf16 rounding of a float32 operand (2^-8
// relative) would be far outside the limit (1e-4 * max|want| per output).
// Every product runs mma.sync.m16n8k16 bf16 with float32 accumulation:
//   - a bf16 operand (q, k, v on the main path) enters as it is: its
//     products are exact;
//   - a float32 operand x (do; the recomputed p and ds; q, k, v when the
//     inputs are float32) enters as kSplit = 2 bf16 terms, x1 = bf16(x),
//     x2 = bf16(x - x1), |x - x1 - x2| <= 2^-16 |x|;
//   - a float32 x bf16 product runs both terms (2 MMAs, error <= 2^-16 of
//     the product); a float32 x float32 product runs x1 y1 + x1 y2 + x2 y1
//     (3 MMAs; the dropped x2 y2 and the two residuals: <= 3 * 2^-16).
// Per product:
//   QK^T    bf16 q, k: exact (float32 inputs: 3 MMAs, <= 3 * 2^-16 per
//           term).  An error e in s moves p by a factor exp(e).  At worst
//           |e| <= 3 * 2^-16 * scale * sum_d |q_d k_d|, which grows as
//           sqrt(hd): about 0.64 sqrt(hd) * 4.6e-5 at unit-variance q, k,
//           3.3e-4 at hd = 128 and 4.7e-4 (sqrt(2) times) at hd = 256.  The
//           terms' errors have no common sign, so e is about 4.6e-5 *
//           scale * sqrt(sum_d (q_d k_d)^2), some 5e-5 at either width;
//           on the main path (bf16 inputs) it is 0.
//   dO.V^T  do split, v exact: <= 2^-16 per term (float32 v: 3 * 2^-16).
//   dS.K    ds split, k exact: <= 2^-16 per term.
//   dS^T.Q  ds split, q exact: <= 2^-16 per term.
//   P^T.dO  p and do split: <= 3 * 2^-16 per term.
// The terms' errors have no common sign, so a sum of n of them carries
// about sqrt(n) times one term's error, as its value grows about sqrt(n)
// times one term: the outputs' error stays near 2^-16 to 3 * 2^-16 of their
// size, against a limit of 1e-4 = 6.6 * 2^-16 of the largest.  The tensor
// core's float32 sum truncates, adding at most an ulp of the partial per
// MMA.  The sums into one output run over slots and rows, not over hd, so
// their MMA counts do not change with the head width: up to 2 * T / 16
// (bf16; float32 inputs 3 * T / 16) into one dq, 3 * g * S / 16 into one
// dv: at S = T = 1024, g = 2, 384 ulps = 4.6e-5 of the partial, seldom all
// of one sign.  The sums into one s or dp run over hd: hd / 16 MMAs (three
// times that for float32 inputs), 16 (48) at hd = 256, each adding at most
// an ulp of its partial: under 6e-6 of the partials' size.
// chip_smoke.py prints max|err| / limit for each output.
//
// Skipped tiles, decided from the data (positions and lse, never assuming
// that positions are monotone).  dq: a key tile none of whose (row, slot)
// pairs is allowed contributes exactly 0 (ds is masked); it is skipped when
// no slot of it can be allowed for the block's query positions, judged by
// their min and max.  dk/dv: a query tile is skipped only when none of its
// pairs can be allowed (judged by the block's slot positions' min and max)
// and none of its rows puts p != 0 on a masked slot (exp(NEG_INF - lse) is
// 0 for every row but a pad row).  Each block makes a bit mask of its live
// tiles first and walks only those; kernels/flash_attention.py
// `bwd_tile_plan` is the same rule in PyTorch.
//
// Tiles.  Rows of every bf16 tile are padded by 16 bytes (HD + 8 values),
// so the eight rows an ldmatrix reads fall in eight distinct bank groups.
//   dq: one block per (64 query rows, head, batch), four warps of 16 rows;
//       q (bf16 as it is) and do (split) are staged once; key tiles of 32
//       stream through a two-stage cp.async ring (k, v and the slot
//       positions), the next live tile's copy in flight while this one
//       computes.  Grid (S/64) H B: 256 blocks at the train shape and at
//       S = T = 1024, two resident per SM (85 KiB of shared memory each).
//       At hd = 256 a warp's dq tile is 128 floats a thread and a bf16
//       block takes 165 KiB, one per SM; float32 inputs (kDirect) split
//       k and v straight from device memory into one step's planes (198
//       KiB), as a two-stage raw ring would need 326 KiB.
//   dk/dv: one block per (64 key slots, KV head, batch); k and v are staged
//       once.  The walk over the group's g query heads and the query tiles
//       of 32 is split between two warp groups of four warps (bf16
//       inputs), the live tiles taken in turn, each group with its own
//       cp.async ring (q, raw float32 do, positions, lse, dd) and named
//       barrier.  Grid (T/64) KV B: 128 blocks at the train shape and at
//       S = T = 1024 for 132 SMs, one resident per SM (168 KiB), so without
//       the split each SM would hold four warps; with it, eight.  At the
//       end the second group hands its dk/dv partials to the first through
//       shared memory, which adds them in that fixed order.
//       At hd > 128 (KvLayout::kWide) a warp's dk and dv over the whole
//       width would be 256 floats a thread, more than its registers, and
//       two groups would need 328 KiB: one group of eight warps, warps w
//       and w + 4 on the same 16 slots, each summing half of dk's and dv's
//       columns (2 x 64 accumulators a thread).  Both compute the whole s,
//       p, dp, ds tile from the same shared memory with the same
//       instructions, so they hold the same bits.  bf16: 197 KiB; float32
//       (kDirect): q and do split straight from device memory into one
//       step's planes, 198 KiB.
//   Per step each warp recomputes its 16 x 32 tile of s and dp on the
//   tensor cores, forms p and ds in the accumulator registers, and feeds
//   them (split) as the A operand of the next products: the C fragment of
//   two 8-column tiles is the A fragment of one 16-deep step.
// No float atomics: every output element is summed by one thread in a
// fixed order, so two launches on the same inputs give the same bits.
// Both kernels write float32; the cast to the input dtype happens outside,
// as at :253.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_tiles.cuh"

namespace {

constexpr float kNegInf = -2.3819763e38f;
constexpr int kSplit = 2;     // bf16 terms of a float32 operand
constexpr int kStages = 2;    // cp.async ring depth
constexpr int kDqRows = 64;   // dq: query rows per block (four warps of 16)
constexpr int kDqKeys = 32;   // dq: key slots per step
constexpr int kDqThreads = 128;
constexpr int kKvKeys = 64;   // dk/dv: key slots per block (four warps of 16)
constexpr int kKvRows = 32;   // dk/dv: query rows per step
constexpr int kGroupWarps = 4;  // dk/dv: warps of a group, 16 slots each
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;
static_assert(kDqKeys == 32 && kKvRows == 32, "a warp judges one tile, a lane per row or slot");

// bf16 inputs are exact MMA operands; float32 inputs are split like do
template <typename T>
struct Input;
template <>
struct Input<__nv_bfloat16> {
  static constexpr int kPlanes = 1, kGroups = 2;
};
template <>
struct Input<float> {
  static constexpr int kPlanes = kSplit, kGroups = 1;
};

// Shared memory, in bytes; kept in step with kernels/flash_attention.py
// `smem_bytes`.  A plane is one bf16 term of a tile, rows of HD + 8 values.
template <typename T, int HD>
struct DqLayout {
  static constexpr int LD = HD + 8;
  static constexpr int P = Input<T>::kPlanes;
  static constexpr bool kRaw = P > 1;  // float32 k, v: staged raw, then split
  // float32 past head width 128: k and v split straight from device memory
  // into one step's planes, no ring (two raw stages would not fit)
  static constexpr bool kDirect = kRaw && HD > 128;
  static constexpr int kRow = 2 * LD;
  static constexpr int kQ = P * kDqRows * kRow;
  static constexpr int kDo = kSplit * kDqRows * kRow;
  static constexpr int kKvPlanes = 2 * P * kDqKeys * kRow;  // k and v of one step
  static constexpr int kStage = (kRaw ? 2 * kDqKeys * HD * 4 : kKvPlanes) + kDqKeys * 4;
  static constexpr int kFixed = kDirect ? kQ + kDo + kKvPlanes + kDqKeys * 4
                                        : kQ + kDo + kStages * kStage + (kRaw ? kKvPlanes : 0);
};

template <typename T, int HD>
struct KvLayout {
  static constexpr int LD = HD + 8;
  static constexpr int P = Input<T>::kPlanes;
  static constexpr bool kRaw = P > 1;  // float32 q: staged raw, then split
  // past head width 128 two warps share each 16 slots, each half of dk's
  // and dv's columns, in one group of eight warps; float32 q and do are
  // then split straight from device memory into one step's planes, no ring
  static constexpr bool kWide = HD > 128;
  static constexpr bool kDirect = kRaw && kWide;
  static constexpr int kHalves = kWide ? 2 : 1;
  static constexpr int G = kWide ? 1 : Input<T>::kGroups;
  static constexpr int kGroupThreads = kHalves * kGroupWarps * 32;
  static constexpr int kThreads = G * kGroupThreads;
  static constexpr int kRow = 2 * LD;
  static constexpr int kKv = 2 * P * kKvKeys * kRow;
  static constexpr int kQStage = kRaw ? kKvRows * HD * 4 : kKvRows * kRow;
  // q, raw do, then the rows' positions, lse and dd
  static constexpr int kStage = kQStage + kKvRows * HD * 4 + 3 * kKvRows * 4;
  static constexpr int kStats = 3 * kKvRows * 4;
  static constexpr int kGroup =
      kDirect ? (kSplit + P) * kKvRows * kRow + kStats
              : kStages * kStage + kSplit * kKvRows * kRow + (kRaw ? P * kKvRows * kRow : 0);
  static constexpr int kFixed = kKv + G * kGroup;
  static_assert(G <= 2, "two warp groups at most");
  static_assert(G == 1 || kGroup >= 2 * kKvKeys * HD * 4, "a group's area holds its dk/dv partials");
};

// the named barrier of one warp group of N threads (barrier 0 is __syncthreads)
template <int N>
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "n"(N) : "memory");
}

// `n` live tiles on from `pos` (-1: before the first), or -1
__device__ __forceinline__ int advance_live(const uint32_t* mask, int words, int pos, int n) {
  for (int i = 0; i < n; ++i) {
    pos = next_live(mask, words, pos + 1);
    if (pos < 0) break;
  }
  return pos;
}

// One recomputed (row, slot) pair: p and the masked ds.
struct Pair {
  float p, ds;
};

__device__ __forceinline__ Pair recompute(float dot, float dpv, float lse, float dd, bool ok,
                                          float scale, float softcap) {
  const float raw = dot * scale;
  float s = raw, dcap = 1.f;
  if (softcap != 0.f) {
    const float th = tanhf(raw / softcap);
    s = th * softcap;
    dcap = 1.f - th * th;
  }
  const float p = expf((ok ? s : kNegInf) - lse);
  const float ds = p * (dpv - dd) * dcap;
  return {p, ok ? ds : 0.f};
}

template <typename T, int HD>
__global__ void __launch_bounds__(kDqThreads, 2)
flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ dd,
                              const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                              float* __restrict__ dq, int S, int T_len, int H, int KV,
                              int causal, int window, float softcap, float scale) {
  using L = DqLayout<T, HD>;
  constexpr int LD = L::LD, P = L::P;
  constexpr int kPlaneQ = kDqRows * LD, kPlaneK = kDqKeys * LD;  // values per plane
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);           // [P][64][LD]
  __nv_bfloat16* dos = reinterpret_cast<__nv_bfloat16*>(smem + L::kQ);  // [kSplit][64][LD]
  unsigned char* ring = smem + L::kQ + L::kDo;                          // kStages x (k, v, slots)
  // the split k and v planes: after the ring, or in its place (kDirect)
  __nv_bfloat16* kv_split =
      reinterpret_cast<__nv_bfloat16*>(L::kDirect ? ring : ring + kStages * L::kStage);
  int* direct_kps = reinterpret_cast<int*>(ring + L::kKvPlanes);  // kDirect: the step's slots
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + L::kFixed);
  __shared__ int red[8];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kDqRows, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int rows = min(kDqRows, S - q0);
  const int tiles = (T_len + kDqKeys - 1) / kDqKeys;
  const int words = (tiles + 31) >> 5;
  const size_t q_row = size_t(H) * HD, k_row = size_t(KV) * HD;  // values between rows
  const size_t q_off = ((size_t(b) * S + q0) * H + h) * HD;

  // q (as it is, or split) and do (split), once per block
  if constexpr (L::kRaw) {
    load_split_rows<HD>(qs, kPlaneQ, q + q_off, q_row, kDqRows, rows, tid, kDqThreads);
  } else {
    copy_rows<T, HD, LD>(qs, q + q_off, q_row, kDqRows, rows, tid, kDqThreads);
    cp_async_commit();
  }
  load_split_rows<HD>(dos, kPlaneQ, dout + q_off, q_row, kDqRows, rows, tid, kDqThreads);

  // this thread's rows: g and g + 8 of its warp's 16
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
  const bool live_lo = r_lo < rows, live_hi = r_hi < rows;
  const size_t stat = (size_t(b) * H + h) * S + q0;
  const int* qpos = q_pos + size_t(b) * S + q0;
  const int qp_lo = live_lo ? qpos[r_lo] : 0, qp_hi = live_hi ? qpos[r_hi] : 0;
  const float lse_lo = live_lo ? lse[stat + r_lo] : 0.f, lse_hi = live_hi ? lse[stat + r_hi] : 0.f;
  const float dd_lo = live_lo ? dd[stat + r_lo] : 0.f, dd_hi = live_hi ? dd[stat + r_hi] : 0.f;

  // the block's query positions: min and max
  int qmin = INT_MAX, qmax = INT_MIN;
  if (tid < rows) qmin = qmax = qpos[tid];
  warp_min_max(qmin, qmax);
  if (lane == 0) {
    red[2 * warp] = qmin;
    red[2 * warp + 1] = qmax;
  }
  for (int i = tid; i < words; i += kDqThreads) mask[i] = 0;
  __syncthreads();
  qmin = min(min(red[0], red[2]), min(red[4], red[6]));
  qmax = max(max(red[1], red[3]), max(red[5], red[7]));

  // live key tiles: some slot that some query of the block may attend
  const int* kpos = k_pos + size_t(b) * T_len;
  for (int kt = warp; kt < tiles; kt += kDqThreads / 32) {
    const int key = kt * kDqKeys + lane;
    const int kp = key < T_len ? kpos[key] : -1;
    const bool may = kp >= 0 && (!causal || kp <= qmax) &&
                     (window < 0 || (long long)qmin - kp < window);
    if (__any_sync(0xffffffffu, may) && lane == 0) atomicOr(mask + (kt >> 5), 1u << (kt & 31));
  }
  if constexpr (!L::kRaw) cp_async_wait<0>();
  __syncthreads();

  auto load_tile = [&](int kt, int st) {
    unsigned char* base = ring + st * L::kStage;
    const int k0 = kt * kDqKeys, nvalid = T_len - k0;
    const size_t off = ((size_t(b) * T_len + k0) * KV + kvh) * HD;
    if constexpr (L::kRaw) {
      float* raw = reinterpret_cast<float*>(base);
      copy_rows<T, HD, HD>(raw, k + off, k_row, kDqKeys, nvalid, tid, kDqThreads);
      copy_rows<T, HD, HD>(raw + kDqKeys * HD, v + off, k_row, kDqKeys, nvalid, tid, kDqThreads);
    } else {
      T* planes = reinterpret_cast<T*>(base);
      copy_rows<T, HD, LD>(planes, k + off, k_row, kDqKeys, nvalid, tid, kDqThreads);
      copy_rows<T, HD, LD>(planes + kPlaneK, v + off, k_row, kDqKeys, nvalid, tid, kDqThreads);
    }
    int* kps = reinterpret_cast<int*>(base + L::kStage - kDqKeys * 4);
    if (tid < kDqKeys) cp_async4(kps + tid, kpos + (tid < nvalid ? k0 + tid : 0), tid < nvalid);
  };

  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  int cur = next_live(mask, words, 0);
  if constexpr (!L::kDirect) {
    if (cur >= 0) load_tile(cur, 0);
    cp_async_commit();
  }
  for (int it = 0; cur >= 0; ++it) {
    const int nxt = next_live(mask, words, cur + 1);
    const int k0 = cur * kDqKeys;
    const __nv_bfloat16* ks = kv_split;
    const int* kps = direct_kps;
    if constexpr (L::kDirect) {
      // float32 k, v split as they are read; the previous step is consumed
      const int nvalid = T_len - k0;
      const size_t off = ((size_t(b) * T_len + k0) * KV + kvh) * HD;
      load_split_rows<HD>(kv_split, kPlaneK, k + off, k_row, kDqKeys, nvalid, tid, kDqThreads);
      load_split_rows<HD>(kv_split + P * kPlaneK, kPlaneK, v + off, k_row, kDqKeys, nvalid, tid,
                          kDqThreads);
      if (tid < kDqKeys) direct_kps[tid] = tid < nvalid ? kpos[k0 + tid] : 0;
      __syncthreads();  // this step's planes are written
    } else {
      if (nxt >= 0) load_tile(nxt, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // this step's tile landed
      unsigned char* base = ring + (it & 1) * L::kStage;
      ks = reinterpret_cast<const __nv_bfloat16*>(base);
      if constexpr (L::kRaw) {
        const float* raw = reinterpret_cast<const float*>(base);
        split_rows<HD>(kv_split, kPlaneK, raw, kDqKeys, tid, kDqThreads);
        split_rows<HD>(kv_split + P * kPlaneK, kPlaneK, raw + kDqKeys * HD, kDqKeys, tid,
                       kDqThreads);
        __syncthreads();
        ks = kv_split;
      }
      kps = reinterpret_cast<const int*>(base + L::kStage - kDqKeys * 4);
    }
    const __nv_bfloat16* vs = ks + P * kPlaneK;

    // s = q k^T and dp = do v^T: 16 rows x 32 slots per warp
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[j][c] = dp[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[P][4], da[kSplit][4];
#pragma unroll
      for (int p = 0; p < P; ++p) load_a(qa[p], qs + p * kPlaneQ, LD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int s = 0; s < kSplit; ++s)
        load_a(da[s], dos + s * kPlaneQ, LD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t kb[P][4], vb[P][4];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          load_b_nk(kb[p], ks + p * kPlaneK, LD, 16 * np, 16 * kk, lane);
          load_b_nk(vb[p], vs + p * kPlaneK, LD, 16 * np, 16 * kk, lane);
        }
        mma_terms<P, P>(sc[2 * np], qa, kb, 0);
        mma_terms<P, P>(sc[2 * np + 1], qa, kb, 1);
        mma_terms<kSplit, P>(dp[2 * np], da, vb, 0);
        mma_terms<kSplit, P>(dp[2 * np + 1], da, vb, 1);
      }
    }
    // ds, in place of s; C fragment c of tile j: row g + 8 (c >> 1), slot 8 j + 2 t + (c & 1)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j * 8 + 2 * t;
      const int2 kp = *reinterpret_cast<const int2*>(kps + col);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool hi = c >= 2;
        const bool ok = (hi ? live_hi : live_lo) && k0 + col + (c & 1) < T_len &&
                        allowed(hi ? qp_hi : qp_lo, (c & 1) ? kp.y : kp.x, causal, window);
        sc[j][c] = recompute(sc[j][c], dp[j][c], hi ? lse_hi : lse_lo, hi ? dd_hi : dd_lo, ok,
                             scale, softcap).ds;
      }
    }
    // dq += ds k
#pragma unroll
    for (int kq = 0; kq < 2; ++kq) {
      uint32_t sa[kSplit][4];
      split_a(sa, sc[2 * kq], sc[2 * kq + 1]);
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t kb[P][4];
#pragma unroll
        for (int p = 0; p < P; ++p) load_b_kn(kb[p], ks + p * kPlaneK, LD, 16 * kq, 16 * np, lane);
        mma_terms<kSplit, P>(acc[2 * np], sa, kb, 0);
        mma_terms<kSplit, P>(acc[2 * np + 1], sa, kb, 1);
      }
    }
    __syncthreads();  // this stage is consumed before the next step refills it
    cur = nxt;
  }
  cp_async_wait<0>();

  float* out = dq + q_off;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (live_lo)
      *reinterpret_cast<float2*>(out + r_lo * q_row + col) =
          make_float2(acc[j][0] * scale, acc[j][1] * scale);
    if (live_hi)
      *reinterpret_cast<float2*>(out + r_hi * q_row + col) =
          make_float2(acc[j][2] * scale, acc[j][3] * scale);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(KvLayout<T, HD>::kThreads, 1)
flash_attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const float* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ dd,
                               const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                               float* __restrict__ dk, float* __restrict__ dv, int S, int T_len,
                               int H, int KV, int causal, int window, float softcap,
                               float scale) {
  using L = KvLayout<T, HD>;
  constexpr int LD = L::LD, P = L::P, G = L::G;
  constexpr int kThreads = L::kThreads, kGT = L::kGroupThreads;
  constexpr int kCols = HD / L::kHalves;  // columns of dk and dv a warp sums
  constexpr int kPlaneK = kKvKeys * LD, kPlaneQ = kKvRows * LD;  // values per plane
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [P][64][LD]
  __nv_bfloat16* vs = ks + P * kPlaneK;                          // [P][64][LD]
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + L::kKv + G * L::kGroup);
  __shared__ int red[4];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int grp = tid / kGT, gtid = tid % kGT, wg = warp % kGroupWarps;
  const int c0 = L::kWide ? warp / kGroupWarps * kCols : 0;  // this warp's first column
  unsigned char* area = smem + L::kKv + grp * L::kGroup;  // this group's ring and planes
  // the split do (and float32 q) planes: after the ring, or in its place (kDirect)
  __nv_bfloat16* do_split =
      reinterpret_cast<__nv_bfloat16*>(area + (L::kDirect ? 0 : kStages * L::kStage));
  __nv_bfloat16* q_split = do_split + kSplit * kPlaneQ;  // float32 q only
  int* direct_stats = reinterpret_cast<int*>(area + L::kGroup - L::kStats);  // kDirect

  const int k0 = blockIdx.x * kKvKeys, kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / KV;
  const int keys = min(kKvKeys, T_len - k0);
  const int q_tiles = (S + kKvRows - 1) / kKvRows;
  const int entries = group * q_tiles;  // (query head of the group, query tile)
  const int words = (entries + 31) >> 5;
  const size_t q_row = size_t(H) * HD, k_row = size_t(KV) * HD;  // values between rows
  const size_t k_off = ((size_t(b) * T_len + k0) * KV + kvh) * HD;

  // k and v (as they are, or split), once per block
  if constexpr (L::kRaw) {
    load_split_rows<HD>(ks, kPlaneK, k + k_off, k_row, kKvKeys, keys, tid, kThreads);
    load_split_rows<HD>(vs, kPlaneK, v + k_off, k_row, kKvKeys, keys, tid, kThreads);
  } else {
    copy_rows<T, HD, LD>(ks, k + k_off, k_row, kKvKeys, keys, tid, kThreads);
    copy_rows<T, HD, LD>(vs, v + k_off, k_row, kKvKeys, keys, tid, kThreads);
    cp_async_commit();
  }

  // this thread's slots: g and g + 8 of its warp's 16
  const int* kpos = k_pos + size_t(b) * T_len + k0;
  const int s_lo = wg * 16 + g, s_hi = s_lo + 8;
  const bool live_lo = s_lo < keys, live_hi = s_hi < keys;
  const int kp_lo = live_lo ? kpos[s_lo] : -1, kp_hi = live_hi ? kpos[s_hi] : -1;

  // the block's written slots' positions: min and max
  int kmin = INT_MAX, kmax = INT_MIN;
  if (tid < keys && kpos[tid] >= 0) kmin = kmax = kpos[tid];
  if (warp < 2) {
    warp_min_max(kmin, kmax);
    if (lane == 0) {
      red[2 * warp] = kmin;
      red[2 * warp + 1] = kmax;
    }
  }
  for (int i = tid; i < words; i += kThreads) mask[i] = 0;
  __syncthreads();
  kmin = min(red[0], red[2]);
  kmax = max(red[1], red[3]);
  const bool any_key = kmin <= kmax;

  // live query tiles: a row that may attend a slot of the block, or a row
  // with p != 0 on masked slots (a pad row)
  for (int e = warp; e < entries; e += kThreads / 32) {
    const int gi = e / q_tiles, qt = e - gi * q_tiles;
    const int r = qt * kKvRows + lane;
    bool live = false;
    if (r < S) {
      const int qp = q_pos[size_t(b) * S + r];
      const float l = lse[(size_t(b) * H + kvh * group + gi) * S + r];
      live = (any_key && (!causal || qp >= kmin) && (window < 0 || (long long)qp - kmax < window)) ||
             expf(kNegInf - l) != 0.f;
    }
    if (__any_sync(0xffffffffu, live) && lane == 0) atomicOr(mask + (e >> 5), 1u << (e & 31));
  }
  if constexpr (!L::kRaw) cp_async_wait<0>();
  __syncthreads();

  auto load_entry = [&](int e, int st) {
    unsigned char* base = area + st * L::kStage;
    const int gi = e / q_tiles, qt = e - gi * q_tiles;
    const int hh = kvh * group + gi, r0 = qt * kKvRows, nvalid = S - r0;
    const size_t off = ((size_t(b) * S + r0) * H + hh) * HD;
    if constexpr (L::kRaw)
      copy_rows<T, HD, HD>(reinterpret_cast<T*>(base), q + off, q_row, kKvRows, nvalid, gtid,
                           kGT);
    else
      copy_rows<T, HD, LD>(reinterpret_cast<T*>(base), q + off, q_row, kKvRows, nvalid, gtid,
                           kGT);
    copy_rows<float, HD, HD>(reinterpret_cast<float*>(base + L::kQStage), dout + off, q_row,
                             kKvRows, nvalid, gtid, kGT);
    int* qps = reinterpret_cast<int*>(base + L::kQStage + kKvRows * HD * 4);
    if (gtid < 3 * kKvRows) {
      const int which = gtid / kKvRows, i = gtid % kKvRows;
      const bool ok = i < nvalid;
      const size_t row = ok ? i : 0;
      const size_t stat = (size_t(b) * H + hh) * S + r0 + row;
      if (which == 0)
        cp_async4(qps + i, q_pos + size_t(b) * S + r0 + row, ok);
      else
        cp_async4(qps + which * kKvRows + i, (which == 1 ? lse : dd) + stat, ok);
    }
  };

  float dk_acc[kCols / 8][4], dv_acc[kCols / 8][4];
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[j][c] = dv_acc[j][c] = 0.f;

  // the live tiles in turn: group 0 takes the first, group 1 the second, ...
  int cur = advance_live(mask, words, -1, grp + 1);
  if constexpr (!L::kDirect) {
    if (cur >= 0) load_entry(cur, 0);
    cp_async_commit();
  }
  for (int it = 0; cur >= 0; ++it) {
    const int nxt = advance_live(mask, words, cur, G);
    const __nv_bfloat16* qs = q_split;
    const int* qps = direct_stats;
    if constexpr (L::kDirect) {
      // float32 q, do split as they are read (one 16-byte chunk in flight:
      // four beside the 128 accumulators spill), and the rows' positions,
      // lse and dd; the previous step is consumed
      const int gi = cur / q_tiles, qt = cur - gi * q_tiles;
      const int hh = kvh * group + gi, r0 = qt * kKvRows, nvalid = S - r0;
      const size_t off = ((size_t(b) * S + r0) * H + hh) * HD;
      load_split_rows<HD, 2, 1>(q_split, kPlaneQ, q + off, q_row, kKvRows, nvalid, gtid, kGT);
      load_split_rows<HD, 2, 1>(do_split, kPlaneQ, dout + off, q_row, kKvRows, nvalid, gtid,
                                kGT);
      if (gtid < kKvRows) {
        const bool ok = gtid < nvalid;
        const size_t stat = (size_t(b) * H + hh) * S + r0 + gtid;
        direct_stats[gtid] = ok ? q_pos[size_t(b) * S + r0 + gtid] : 0;
        reinterpret_cast<float*>(direct_stats)[kKvRows + gtid] = ok ? lse[stat] : 0.f;
        reinterpret_cast<float*>(direct_stats)[2 * kKvRows + gtid] = ok ? dd[stat] : 0.f;
      }
      group_sync<kGT>(grp);  // this step's planes are written
    } else {
      if (nxt >= 0) load_entry(nxt, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      group_sync<kGT>(grp);  // this step's tile landed
      const unsigned char* base = area + (it & 1) * L::kStage;
      split_rows<HD>(do_split, kPlaneQ, reinterpret_cast<const float*>(base + L::kQStage),
                     kKvRows, gtid, kGT);
      qs = reinterpret_cast<const __nv_bfloat16*>(base);
      if constexpr (L::kRaw) {
        split_rows<HD>(q_split, kPlaneQ, reinterpret_cast<const float*>(base), kKvRows, gtid,
                       kGT);
        qs = q_split;
      }
      group_sync<kGT>(grp);
      qps = reinterpret_cast<const int*>(base + L::kQStage + kKvRows * HD * 4);
    }
    const float* lses = reinterpret_cast<const float*>(qps + kKvRows);
    const float* dds = lses + kKvRows;
    const int r0 = (cur % q_tiles) * kKvRows;

    // s^T = k q^T and dp^T = v do^T: 16 slots x 32 rows per warp
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[j][c] = dpt[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ka[P][4], va[P][4];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        load_a(ka[p], ks + p * kPlaneK, LD, wg * 16, kk * 16, lane);
        load_a(va[p], vs + p * kPlaneK, LD, wg * 16, kk * 16, lane);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t qb[P][4], db[kSplit][4];
#pragma unroll
        for (int p = 0; p < P; ++p) load_b_nk(qb[p], qs + p * kPlaneQ, LD, 16 * np, 16 * kk, lane);
#pragma unroll
        for (int s = 0; s < kSplit; ++s)
          load_b_nk(db[s], do_split + s * kPlaneQ, LD, 16 * np, 16 * kk, lane);
        mma_terms<P, P>(st[2 * np], ka, qb, 0);
        mma_terms<P, P>(st[2 * np + 1], ka, qb, 1);
        mma_terms<P, kSplit>(dpt[2 * np], va, db, 0);
        mma_terms<P, kSplit>(dpt[2 * np + 1], va, db, 1);
      }
    }
    // p and ds in place; C fragment c of tile j: slot g + 8 (c >> 1), row 8 j + 2 t + (c & 1)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i0 = j * 8 + 2 * t;
      const int2 qp = *reinterpret_cast<const int2*>(qps + i0);
      const float2 l2 = *reinterpret_cast<const float2*>(lses + i0);
      const float2 d2 = *reinterpret_cast<const float2*>(dds + i0);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool hi = c >= 2, odd = c & 1;
        const bool exists = (hi ? live_hi : live_lo) && r0 + i0 + odd < S;
        const bool ok = exists && allowed(odd ? qp.y : qp.x, hi ? kp_hi : kp_lo, causal, window);
        const Pair pr = recompute(st[j][c], dpt[j][c], odd ? l2.y : l2.x, odd ? d2.y : d2.x, ok,
                                  scale, softcap);
        st[j][c] = exists ? pr.p : 0.f;  // p is not masked (see the note)
        dpt[j][c] = pr.ds;
      }
    }
    // dv += p^T do, dk += ds^T q
#pragma unroll
    for (int kq = 0; kq < 2; ++kq) {
      uint32_t pa[kSplit][4], sa[kSplit][4];
      split_a(pa, st[2 * kq], st[2 * kq + 1]);
      split_a(sa, dpt[2 * kq], dpt[2 * kq + 1]);
#pragma unroll
      for (int np = 0; np < kCols / 16; ++np) {
        uint32_t db[kSplit][4], qb[P][4];
#pragma unroll
        for (int s = 0; s < kSplit; ++s)
          load_b_kn(db[s], do_split + s * kPlaneQ, LD, 16 * kq, c0 + 16 * np, lane);
#pragma unroll
        for (int p = 0; p < P; ++p)
          load_b_kn(qb[p], qs + p * kPlaneQ, LD, 16 * kq, c0 + 16 * np, lane);
        mma_terms<kSplit, kSplit>(dv_acc[2 * np], pa, db, 0);
        mma_terms<kSplit, kSplit>(dv_acc[2 * np + 1], pa, db, 1);
        mma_terms<kSplit, P>(dk_acc[2 * np], sa, qb, 0);
        mma_terms<kSplit, P>(dk_acc[2 * np + 1], sa, qb, 1);
      }
    }
    group_sync<kGT>(grp);  // this stage and the planes are consumed before they are refilled
    cur = nxt;
  }
  cp_async_wait<0>();

  if constexpr (G > 1) {
    // group 1's partials, through its own area, added by group 0 in that order
    __syncthreads();
    float* part = reinterpret_cast<float*>(smem + L::kKv + L::kGroup);
    constexpr int kRegs = kCols / 8 * 4;
    if (grp == 1) {
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          part[(j * 4 + c) * kGT + gtid] = dk_acc[j][c];
          part[(kRegs + j * 4 + c) * kGT + gtid] = dv_acc[j][c];
        }
    }
    __syncthreads();
    if (grp == 1) return;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dk_acc[j][c] += part[(j * 4 + c) * kGT + gtid];
        dv_acc[j][c] += part[(kRegs + j * 4 + c) * kGT + gtid];
      }
  }

  float* dko = dk + k_off;
  float* dvo = dv + k_off;
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) {
    const int col = c0 + j * 8 + 2 * t;
    if (live_lo) {
      *reinterpret_cast<float2*>(dko + s_lo * k_row + col) =
          make_float2(dk_acc[j][0] * scale, dk_acc[j][1] * scale);
      *reinterpret_cast<float2*>(dvo + s_lo * k_row + col) = make_float2(dv_acc[j][0], dv_acc[j][1]);
    }
    if (live_hi) {
      *reinterpret_cast<float2*>(dko + s_hi * k_row + col) =
          make_float2(dk_acc[j][2] * scale, dk_acc[j][3] * scale);
      *reinterpret_cast<float2*>(dvo + s_hi * k_row + col) = make_float2(dv_acc[j][2], dv_acc[j][3]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *dd, *q_pos, *k_pos;
  int B, S, T_len, H, KV, causal, window;
  float softcap, scale;
};

size_t mask_bytes(int entries) { return 4 * size_t((entries + 31) / 32); }

// The kernel's shared-memory attribute, set when a launch needs more than
// any launch before it on this device, not on every launch.
template <typename K>
cudaError_t reserve_smem(K kernel, size_t smem, size_t (&sized)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && smem <= sized[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err == cudaSuccess && dev < kMaxDevices) sized[dev] = smem;
  return err;
}

// One launch of either kernel: its grid, threads per block and dynamic
// shared memory.  The launches below use it, and flash_attention_bwd_plan
// exports it, so that kernels/flash_attention.py `launch_plan` can be held
// to it.
struct Plan {
  dim3 grid;
  int threads;
  size_t smem;
};

template <typename T, int HD>
cudaError_t plan_dq(int B, int S, int T_len, int H, int KV, Plan* p) {
  p->grid = dim3((S + kDqRows - 1) / kDqRows, H, B);
  p->threads = kDqThreads;
  p->smem = DqLayout<T, HD>::kFixed + mask_bytes((T_len + kDqKeys - 1) / kDqKeys);
  return cudaSuccess;
}

template <typename T, int HD>
cudaError_t plan_dkv(int B, int S, int T_len, int H, int KV, Plan* p) {
  p->grid = dim3((T_len + kKvKeys - 1) / kKvKeys, KV, B);
  p->threads = KvLayout<T, HD>::kThreads;
  p->smem = KvLayout<T, HD>::kFixed + mask_bytes((H / KV) * ((S + kKvRows - 1) / kKvRows));
  return cudaSuccess;
}

template <typename T, int HD>
cudaError_t launch_dq(const Args& a, void* dq, cudaStream_t stream) {
  Plan p;
  plan_dq<T, HD>(a.B, a.S, a.T_len, a.H, a.KV, &p);
  if (p.smem > size_t(kMaxSmem)) return cudaErrorInvalidValue;
  auto kernel = flash_attention_bwd_dq_kernel<T, HD>;
  static size_t sized[kMaxDevices] = {};
  cudaError_t err = reserve_smem(kernel, p.smem, sized);
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, p.threads, p.smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.dd), static_cast<const int*>(a.q_pos),
      static_cast<const int*>(a.k_pos), static_cast<float*>(dq), a.S, a.T_len, a.H, a.KV,
      a.causal, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv, cudaStream_t stream) {
  Plan p;
  plan_dkv<T, HD>(a.B, a.S, a.T_len, a.H, a.KV, &p);
  if (p.smem > size_t(kMaxSmem)) return cudaErrorInvalidValue;
  auto kernel = flash_attention_bwd_dkv_kernel<T, HD>;
  static size_t sized[kMaxDevices] = {};
  cudaError_t err = reserve_smem(kernel, p.smem, sized);
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, p.threads, p.smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.dd), static_cast<const int*>(a.q_pos),
      static_cast<const int*>(a.k_pos), static_cast<float*>(dk), static_cast<float*>(dv), a.S,
      a.T_len, a.H, a.KV, a.causal, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16
#define DISPATCH(FN, ...)                                                          \
  switch (hd * 2 + dtype) {                                                        \
    case 32: return FN<float, 16>(__VA_ARGS__);                                    \
    case 33: return FN<__nv_bfloat16, 16>(__VA_ARGS__);                            \
    case 64: return FN<float, 32>(__VA_ARGS__);                                    \
    case 65: return FN<__nv_bfloat16, 32>(__VA_ARGS__);                            \
    case 128: return FN<float, 64>(__VA_ARGS__);                                   \
    case 129: return FN<__nv_bfloat16, 64>(__VA_ARGS__);                           \
    case 256: return FN<float, 128>(__VA_ARGS__);                                  \
    case 257: return FN<__nv_bfloat16, 128>(__VA_ARGS__);                          \
    case 512: return FN<float, 256>(__VA_ARGS__);                                  \
    case 513: return FN<__nv_bfloat16, 256>(__VA_ARGS__);                          \
    default: return cudaErrorInvalidValue;                                         \
  }

cudaError_t dq_dispatch(int dtype, int hd, const Args& a, void* dq, cudaStream_t s) {
  DISPATCH(launch_dq, a, dq, s)
}

cudaError_t dkv_dispatch(int dtype, int hd, const Args& a, void* dk, void* dv, cudaStream_t s) {
  DISPATCH(launch_dkv, a, dk, dv, s)
}

cudaError_t plan_dispatch(int kernel, int dtype, int hd, int B, int S, int T_len, int H, int KV,
                          Plan* p) {
  if (kernel == 0) {
    DISPATCH(plan_dq, B, S, T_len, H, KV, p)
  }
  DISPATCH(plan_dkv, B, S, T_len, H, KV, p)
}

bool bad_args(int dtype, int B, int S, int T_len, int H, int KV) {
  return (dtype != 0 && dtype != 1) || B < 1 || S < 1 || T_len < 1 || KV < 1 || H < KV ||
         H % KV != 0 || H > 65535 || B > 65535;
}

}  // namespace

extern "C" int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse, const void* dd,
                                             const void* q_pos, const void* k_pos, void* dq,
                                             int dtype, int B, int S, int T_len, int H, int KV,
                                             int hd, int causal, int window, float softcap,
                                             float scale, int device, void* stream) {
  if (bad_args(dtype, B, S, T_len, H, KV)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Args a{q, k, v, dout, lse, dd, q_pos, k_pos, B, S, T_len, H, KV, causal, window,
               softcap, scale};
  return int(dq_dispatch(dtype, hd, a, dq, static_cast<cudaStream_t>(stream)));
}

extern "C" int flash_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse, const void* dd,
                                              const void* q_pos, const void* k_pos, void* dk,
                                              void* dv, int dtype, int B, int S, int T_len,
                                              int H, int KV, int hd, int causal, int window,
                                              float softcap, float scale, int device,
                                              void* stream) {
  if (bad_args(dtype, B, S, T_len, H, KV)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Args a{q, k, v, dout, lse, dd, q_pos, k_pos, B, S, T_len, H, KV, causal, window,
               softcap, scale};
  return int(dkv_dispatch(dtype, hd, a, dk, dv, static_cast<cudaStream_t>(stream)));
}

// The launch of the dq (kernel 0) or the dk/dv kernel (1) for these
// arguments: out = {grid x, y, z, threads, shared-memory bytes}.
extern "C" int flash_attention_bwd_plan(int kernel, int dtype, int B, int S, int T_len, int H,
                                        int KV, int hd, long long* out) {
  if (bad_args(dtype, B, S, T_len, H, KV) || (kernel != 0 && kernel != 1))
    return int(cudaErrorInvalidValue);
  Plan p;
  cudaError_t err = plan_dispatch(kernel, dtype, hd, B, S, T_len, H, KV, &p);
  if (err != cudaSuccess) return int(err);
  const long long plan[5] = {p.grid.x, p.grid.y, p.grid.z, p.threads, (long long)p.smem};
  for (int i = 0; i < 5; ++i) out[i] = plan[i];
  return 0;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
