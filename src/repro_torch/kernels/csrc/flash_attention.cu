// flash_attention.cu: online-softmax attention forward (prefill) and the
// one-token decode over the KV cache.
//
// Replaces: src/repro/kernels/flash_attention.py `_fwd_kernel` (pallas_call
// at :100, entry flash_attention at :261) and `_decode_kernel` (pallas_call
// at :360, entry flash_decode at :334).  The backward kernels of that file
// (`_dq_kernel`, `_dkv_kernel`) are in flash_attention_bwd.cu; the forward
// writes their residual lse = m + log(max(l, 1e-30)) (B, H, S) when the
// caller passes a buffer for it (training), as `_fwd` does.
//
// Both compute, per query row with position qp and key slot j with
// position kp[j]:  s = (q . k_j) * scale, s = tanh(s / softcap) * softcap
// when softcap != 0, s = NEG_INF where the slot is not allowed (kp < 0,
// causal and qp < kp, or a window and qp - kp >= window), then the
// softmax over the slots and o = sum_j p_j v_j, in float32, with q-head h
// reading KV head h / g (GQA by index, k/v never repeated in memory).
// NEG_INF is the reference's finite -2.3819763e38, never -inf: a row whose
// first key tile is fully masked gets p = exp(0) = 1 there, which the next
// allowed tile erases through corr = exp(NEG_INF - m) = 0, and a row with
// no allowed key at all (a left pad) ends as the finite uniform average of
// all T slots, with lse = NEG_INF + log T = NEG_INF, as in the reference
// (the backward's pad-row rule reads that lse).  Slots past T in a tile do
// not exist in the reference (its tiles divide T); here they carry -inf,
// which gives them p = 0 exactly, since every tile holds a real slot.
//
// The masked-block rule (the forward).  Take a row that has an allowed
// slot somewhere in T, and a key tile in which none of its slots is
// allowed.  After the row's first allowed slot, p = exp(NEG_INF - m)
// underflows to exactly 0, m' = m and corr = 1: (m, l, acc) stay
// bit-identical.  Before it, the tile leaves (NEG_INF, count, sum v), and
// the next tile with an allowed slot multiplies all three by corr =
// exp(NEG_INF - m') = 0; a skipped tile leaves (NEG_INF, 0, 0), also
// multiplied by 0, so the same (m, l, acc) come out (acc is finite, since
// NEG_INF and v are).  So a (query tile, key tile) pair is skipped when
// (a) no row of the tile may attend a slot of the key tile, judged from
// the tile's least and greatest position against each written slot, and
// (b) every row of the tile has an allowed slot in T.  A tile with a row
// that has none (a left pad) walks every key tile: its uniform average
// and its lse need every slot.  Each block decides both on the card from
// q_pos / k_pos at its start, in the same launch, into a bit mask of live
// key tiles; kernels/flash_attention.py `fwd_tile_plan` is the same rule
// in PyTorch (and `approx_tile_plan` calls it), and the tests run a plain
// online-softmax loop with those pairs left out, bit-identical to the
// plain version.  Given a counter (`skipped`, null on the serve and train
// paths), thread 0 of a block adds the number of key tiles its item skips.
//
// Forward, `flash_attention_kernel`: a work item is (batch, KV head,
// query-row tile) with the group's query heads (a chunk of them when g >
// 64): 64 row-heads, row-head i being query row i / G and head i % G of
// the item, so each staged K/V tile serves all G heads.  A group of four
// warps takes an item, each warp 16 row-heads: per live key tile of 64
// slots the warp computes its 16 x 64 scores on the tensor cores, takes
// the online softmax in the accumulator registers (a row's four lanes
// meet by shuffles), and feeds p, split, as the A operand of P.V: the C
// fragment of two 8-slot tiles is the A fragment of one 16-deep step.
// The items go longest first (the last query tiles, which causal rows
// make walk the most key tiles).  A block is one group, or two side by
// side (`fwd_groups`) when the items are more than one per SM but fit two
// per SM: block b then takes item b and item items - 1 - b, a long one
// and a short one, so that one wave holds the grid and every SM about the
// same work (S = T = 1024 at B = 1: 256 items in 128 blocks).
//
// Tensor cores with float32-accurate results (bf16_tiles.cuh).  Every
// product runs mma.sync.m16n8k16 bf16 with float32 accumulation:
//   - bf16 q, k, v (the main path) enter as they are: QK^T's products are
//     exact, summed in float32 on the tensor cores;
//   - p enters P.V as two bf16 terms (2 MMAs): |p - p1 - p2| <= 2^-16 p,
//     v exact, so each term p v is within 2^-16 of itself and o within
//     2^-16 of sum_j p_j |v_j| / l, which is |o| when the terms agree in
//     sign; where they do not, the terms' roundings have no common sign and
//     their sum grows as their square root.  Against rtol = atol = 2e-5
//     (1.3 * 2^-16 relative, plus the absolute part) that holds;
//   - float32 q, k, v enter as three bf16 terms each, and p too, with the
//     products A_i B_j for i + j < 3 (6 MMAs per product): each term
//     within about 3 * 2^-24 of itself.  Two terms would not do for QK^T:
//     an error e in s moves p by a factor exp(e), and e reaches 3 * 2^-16
//     * scale * sum_d |q_d k_d|, about 5e-5 at unit-variance q, k and hd =
//     128, over the limit.  The scale, softcap, masks, exp and the online
//     update run in float32 on the CUDA cores, as the reference's.
// k and v of bf16 inputs stream through a two-stage cp.async ring (the
// next live tile's copy in flight while this one computes), rows padded
// by 16 bytes so each ldmatrix spreads over the banks; float32 k and v are
// read and split into planes tile by tile (one stage: six planes of 64
// slots fill the shared memory).
//
// Head width 256 (gemma-7b, gemma2-9b).  A warp's 16 x 256 float32 output
// tile alone would be 128 registers a thread, with bf16 q's fragments 64
// more, and two items' planes need 338,976 bytes of shared memory.  So at
// HD > 128 (`FwdLayout::kWide`) a group is eight warps: warps w and w + 4
// take the same 16 row-heads, each computes the whole 16 x 64 score tile
// and its softmax (the same instructions on the same data: the same bits,
// so m and l agree) and then P.V for its half of the output columns; q's
// fragments are read from shared memory at each k-step, as float32's are;
// a block holds one item (169,488 bytes for bf16).  Float32 inputs walk
// key tiles of 32 (`kKeys`): three planes of q and of 64-slot k and v
// tiles need 304,400 bytes, of 32-slot tiles 202,896.  The QK^T of every
// row runs twice, which the tensor cores have room for (P.V, two terms,
// is the larger product); the tiles, masks and rule are the same.
//
// Decode, `flash_decode_kernel` (flash-decoding in one launch): T is cut
// into chunks (`decode_split`, so that B x KV x chunks fills four blocks
// per SM, at most 32 chunks); block (KV head, chunk, b) takes the group's
// g <= 16 query heads over its chunk.  They share qp and kp, so a chunk
// with no allowed slot reads no K/V and writes only a flag (l = 0), and
// its block counts one in `skipped` when given a counter.  A live chunk streams its K/V in
// tiles of 32 slots through a two-stage cp.async ring of 16-byte copies,
// scores (row, slot) pairs with float32 FMAs from shared memory, takes
// the softmax a warp per row, and writes a partial (m, l, acc) per row.
// The block that counts last for its (b, KV head) (split_k.cuh: every
// thread's partials fenced, a barrier, then the count; the counter back
// to 0 at the end, so a later launch or a CUDA graph replay finds it
// zeroed) adds the partials in chunk order 0, 1, 2, ...: M = max m_c, L =
// sum l_c exp(m_c - M), o = sum acc_c exp(m_c - M) / max(L, 1e-30); a
// row with no allowed slot in any chunk gets the uniform average of all T
// slots, computed by that block, which is the reference's result there.
// No float atomics: two launches on the same inputs give the same bits.
// Given an lse buffer, that block also writes each row's M + log(max(L,
// 1e-30)) over the slots it was given (NEG_INF where none is allowed), so
// that ranks holding a sequence shard each of the cache can combine
// their (o, lse) over the model group (models/attention.py).
//
// What bounds each on the H100.  The forward: per allowed (query head,
// slot) pair, QK^T (2 hd FLOPs) and P.V as two bf16 terms (4 hd) on the
// bf16 tensor cores, 6.4 us at S = T = 1024 (8.40M pairs) at 989 TFLOP/s,
// against 16.8 MB of inputs and outputs moved once (5.0 us at 3.35 TB/s):
// close, products ahead.  At the serve shapes it is a few MFLOP and the
// launch and one tile's latency set its time.  What holds it well above
// that (PERF.md): a warp walks its key tiles alone on its scheduler, and
// each tile is a chain of dependent steps (QK^T, max, exp, sum, P.V) with
// little to overlap; removing any one of the products, the masks or the
// exp from the loop saved at most a fifth, and a second copy of the score
// loop (unmasked tiles) or of the item (two groups taking turns) cost
// more than it saved.  The decode moves the cache once: 66.9 MB over 4,096
// slots at B = 4, 20 us at 3.35 TB/s, against 0.27 GFLOP of float32 FMAs
// (4 us at 67 TFLOP/s): bytes bound it, so it runs on the CUDA cores.
// What keeps it from the bound at 4,096 slots is a fixed cost of round
// trips to memory one after another: the chunk's scan, its first tile,
// the count and the last block's combine.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_tiles.cuh"
#include "split_k.cuh"

namespace {

constexpr float kNegInf = -2.3819763e38f;
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;
constexpr int kPlan = 8;  // flash_attention_plan's outputs
// forward
constexpr int kFwdRH = 64;       // row-heads per item: four warps of 16
constexpr int kFwdKeys = 64;     // key slots per tile (float32 at HD > 128: half)
constexpr int kFwdThreads = 128;  // a group of four warps: one item (eight at HD > 128)
constexpr int kFwdStages = 2;    // cp.async ring depth (bf16 inputs)
constexpr int kFwdSplit = 3;     // bf16 terms of float32 q, k, v and of their p
constexpr int kPTerms = 2;       // bf16 terms of p against bf16 v
// decode
constexpr int kDecTile = 32;     // key slots per staged tile (a lane each in the softmax)
constexpr int kDecStages = 2;    // cp.async ring depth
constexpr int kDecThreads = 128;
constexpr int kMaxG = 16;        // query heads per KV head
constexpr int kDecStep = 16;     // chunks are whole multiples of this many slots
constexpr int kDecPerSm = 4;     // the split aims at this many blocks per SM
constexpr int kDecMaxChunks = 32;  // chunks per (b, KV head): their (m, l) fit the ring
static_assert(kDecTile == 32, "the decode's softmax takes a slot per lane");

__device__ __forceinline__ float minus_inf() { return __uint_as_float(0xff800000u); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float score(float dot, float scale, float softcap) {
  float s = dot * scale;
  if (softcap != 0.f) s = tanhf(s / softcap) * softcap;
  return s;
}

// ------------------------------------------------------------- forward
// bf16 planes of q, k and v, terms of p, and the term budget of a product
template <typename T>
struct FwdTerms;
// and the most groups of a block: two items side by side for bf16 inputs
// (one for float32, whose planes fill the shared memory)
template <>
struct FwdTerms<__nv_bfloat16> {
  static constexpr int kPlanes = 1, kP = kPTerms, kN = kPTerms, kGroups = 2;
};
template <>
struct FwdTerms<float> {
  static constexpr int kPlanes = kFwdSplit, kP = kFwdSplit, kN = kFwdSplit, kGroups = 1;
};

// Groups per block: 2 (where the type and width allow) when the items are more than
// one per SM but fit two per SM, so that one wave holds them and each SM a
// long item and a short one; else 1 (one item per block: alone on an SM
// for the least latency, or many waves that the card's scheduler evens).
// (Two groups taking turns at one item's key tiles ran slower on the H100
// at S = T = 1024 and at the train shape: each group stages q and the
// mask, and the two add their partials at the end.)
// Shared memory, in bytes, and the group's shape; kept in step with
// kernels/flash_attention.py `smem_bytes` and `launch_plan`.  A plane is
// one bf16 term of a tile, rows of HD + 8 values.  At HD > 128 (kWide)
// two warps share each 16 row-heads, a block holds one item, and float32
// inputs walk key tiles of 32 (see the note at the top).
template <typename T, int HD>
struct FwdLayout {
  static constexpr int LD = HD + 8;
  static constexpr int P = FwdTerms<T>::kPlanes;
  static constexpr bool kRaw = P > 1;  // float32 k, v: read and split tile by tile
  static constexpr bool kWide = HD > 128;
  static constexpr int kHalves = kWide ? 2 : 1;  // warps per 16 row-heads (output column halves)
  static constexpr int kThreads = kFwdThreads * kHalves;  // a group: one item
  static constexpr int kGroups = kWide ? 1 : FwdTerms<T>::kGroups;
  static constexpr int kKeys = kWide && kRaw ? kFwdKeys / 2 : kFwdKeys;  // slots per key tile
  static constexpr int kPlaneQ = kFwdRH * LD, kPlaneK = kKeys * LD;  // values
  static constexpr int kQ = 2 * P * kPlaneQ;
  static constexpr int kStage = 2 * 2 * P * kPlaneK + kKeys * 4;  // k, v planes; positions
  static constexpr int kStages = kRaw ? 1 : kFwdStages;
  static constexpr int kFixed = kQ + kStages * kStage;
};

template <typename T, int HD>
int fwd_groups(long long items, int sms) {
  return FwdLayout<T, HD>::kGroups > 1 && items > sms && items <= 2LL * sms ? 2 : 1;
}

// the named barrier of one group of NT threads (barrier 0 is __syncthreads)
template <int NT>
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "n"(NT) : "memory");
}

// the live-tile bit mask, in whole 16-byte units (so the next group's area stays aligned)
__host__ __device__ constexpr size_t mask_bytes(int tiles) { return 16 * size_t((tiles + 127) / 128); }

// One launch's work items: (batch, KV head, head chunk, query-row tile).
struct FwdGeometry {
  int B, S, T, H, KV, g;
  int heads;   // G: query heads per item (of the KV head's g)
  int rows;    // query rows per item
  int chunks;  // head chunks per KV head
  int tiles;   // query-row tiles
  int ktiles;  // key tiles
  long long items;
};

__host__ __device__ FwdGeometry fwd_geometry(int B, int S, int T, int H, int KV, int keys) {
  FwdGeometry e;
  e.B = B, e.S = S, e.T = T, e.H = H, e.KV = KV, e.g = H / KV;
  e.heads = e.g < kFwdRH ? e.g : kFwdRH;
  e.rows = kFwdRH / e.heads;
  e.chunks = (e.g + e.heads - 1) / e.heads;
  e.tiles = (S + e.rows - 1) / e.rows;
  e.ktiles = (T + keys - 1) / keys;
  e.items = (long long)B * KV * e.chunks * e.tiles;
  return e;
}

struct FwdItem {
  int b, kvh, h0, q0;  // h0: the item's first head within the group
};

// item `idx`: the last query tiles first
__device__ FwdItem fwd_item(const FwdGeometry& e, long long idx) {
  const long long rest = (long long)e.B * e.KV * e.chunks;
  FwdItem it;
  it.q0 = (e.tiles - 1 - int(idx / rest)) * e.rows;
  int r = int(idx % rest);
  it.h0 = (r % e.chunks) * e.heads;
  r /= e.chunks;
  it.kvh = r % e.KV;
  it.b = r / e.KV;
  return it;
}

// A row's allowed slot positions, lo <= kp <= hi (written, causal, window)
struct Bounds {
  int lo, hi;
};

__device__ __forceinline__ Bounds bounds_of(int qp, int causal, int window) {
  long long lo = window >= 0 ? (long long)qp - window + 1 : 0;
  if (lo < 0) lo = 0;
  return {int(lo), causal ? qp : INT_MAX};
}

// The scores of one key tile: scale, softcap (kSoftcap), and the masks; C
// fragment c of tile j: row-head gq + 8 (c >> 1), slot 8 j + 2 t4 + (c & 1).
// Slots past T (the last tile only) get -inf, masked ones NEG_INF.  (A
// second copy without the masks, for the tiles a warp's rows may attend
// whole, ran slower on the H100: the loop's code grew past what its cache
// held.)
template <int KEYS, bool kSoftcap>
__device__ __forceinline__ void tile_scores(float (&sc)[KEYS / 8][4], const int* kps, int k0,
                                            int T, int t4, Bounds b_lo, Bounds b_hi,
                                            float softcap, float scale, float& mx_lo,
                                            float& mx_hi) {
  const bool ragged = k0 + KEYS > T;
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
    const int col = j * 8 + 2 * t4;
    const int2 kp = *reinterpret_cast<const int2*>(kps + col);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool hi = c >= 2, odd = c & 1;
      float x = sc[j][c] * scale;
      if constexpr (kSoftcap) x = tanhf(x / softcap) * softcap;
      const int y = odd ? kp.y : kp.x;
      const Bounds bd = hi ? b_hi : b_lo;
      if (y < bd.lo || y > bd.hi) x = kNegInf;
      if (ragged && k0 + col + odd >= T) x = minus_inf();  // not a slot (see the note)
      sc[j][c] = x;
      if (hi)
        mx_hi = fmaxf(mx_hi, x);
      else
        mx_lo = fmaxf(mx_lo, x);
    }
  }
}

template <typename T, int HD, bool kSoftcap>
__global__ void __launch_bounds__(FwdLayout<T, HD>::kGroups * FwdLayout<T, HD>::kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ q_pos,
                       const int* __restrict__ k_pos, float* __restrict__ out,
                       float* __restrict__ lse, int* __restrict__ skipped, FwdGeometry e,
                       int causal, int window, float softcap, float scale) {
  using L = FwdLayout<T, HD>;
  constexpr int LD = L::LD, P = L::P, PT = FwdTerms<T>::kP, N = FwdTerms<T>::kN;
  // threads of a group, slots of a key tile, output columns of a warp
  constexpr int NT = L::kThreads, KEYS = L::kKeys, HW = HD / L::kHalves;
  extern __shared__ __align__(16) unsigned char smem_all[];
  __shared__ int red_all[L::kGroups][4];

  // group grp of block b takes item b (grp 0) or items - 1 - b (grp 1, in
  // a launch of two groups a block): the items go longest first, so each
  // block holds a long one and a short one
  const int grp = threadIdx.x / NT;
  const long long idx = grp == 0 ? blockIdx.x : e.items - 1 - blockIdx.x;
  if (grp > 0 && idx <= blockIdx.x) return;  // an odd count: the middle item has one group
  const int words = (e.ktiles + 31) >> 5;
  unsigned char* smem = smem_all + grp * (L::kFixed + mask_bytes(e.ktiles));
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [P][64][LD]
  unsigned char* ring = smem + L::kQ;                           // kStages x (k, v, slots)
  uint32_t* mask = reinterpret_cast<uint32_t*>(ring + L::kStages * L::kStage);
  int* red = red_all[grp];  // least, greatest row position; every row has a slot; least slot

  const int tid = threadIdx.x % NT, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  // this warp's 16 row-heads (rw) and its first output column (c0: two
  // warps share the rows at HD > 128, each taking HW columns)
  const int rw = warp % (kFwdRH / 16), c0 = warp / (kFwdRH / 16) * HW;
  const FwdItem it = fwd_item(e, idx);
  const size_t k_row = size_t(e.KV) * HD;  // values between slots
  const int* qpos = q_pos + size_t(it.b) * e.S;
  const int* kpos = k_pos + size_t(it.b) * e.T;

  // row-head i: query row q0 + i / G, head h0 + i % G of the group
  auto rh_valid = [&](int i) {
    return i < e.rows * e.heads && it.q0 + i / e.heads < e.S && it.h0 + i % e.heads < e.g;
  };
  auto rh_head = [&](int i) { return it.kvh * e.g + it.h0 + i % e.heads; };
  auto rh_off = [&](int i) {  // of q and out (B, S, H, HD)
    return ((size_t(it.b) * e.S + it.q0 + i / e.heads) * e.H + rh_head(i)) * HD;
  };

  // q, once: as it is (bf16) or as P planes (float32); pad row-heads zero
  if constexpr (L::kRaw) {
    constexpr int C4 = HD / 4;
    for (int c = tid; c < kFwdRH * C4; c += NT) {
      const int i = c / C4, col = (c % C4) * 4;
      const float4 x = rh_valid(i)
                           ? __ldg(reinterpret_cast<const float4*>(q + rh_off(i) + col))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      store_split<LD, P>(qs, L::kPlaneQ, i, col, x);
    }
  } else {
    constexpr int C8 = HD / 8;
    for (int c = tid; c < kFwdRH * C8; c += NT) {
      const int i = c / C8, col = (c % C8) * 8;
      const bool ok = rh_valid(i);
      cp_async16(qs + i * LD + col, ok ? q + rh_off(i) + col : q, ok);
    }
    cp_async_commit();
  }

  // the rule: the tile's least and greatest position; the key tiles some
  // row may attend (a warp per tile) and the least written slot; whether
  // every row has an allowed slot in T: with no window, causal rows have
  // one when the least written slot is at or before the least row position
  // (bidirectional rows when any slot is written), and with a window a warp
  // per row looks for one, stopping at the first
  if (tid == 0) {
    red[0] = INT_MAX;
    red[1] = INT_MIN;
    red[2] = 1;
    red[3] = INT_MAX;
  }
  for (int i = tid; i < words; i += NT) mask[i] = 0;
  group_sync<NT>(grp);
  {
    int mn = INT_MAX, mx = INT_MIN;
    for (int r = tid; r < e.rows && it.q0 + r < e.S; r += NT) {
      const int qp = qpos[it.q0 + r];
      mn = min(mn, qp);
      mx = max(mx, qp);
    }
    warp_min_max(mn, mx);
    if (lane == 0) {
      atomicMin(red, mn);
      atomicMax(red + 1, mx);
    }
  }
  group_sync<NT>(grp);
  const int qmin = red[0], qmax = red[1];
  int kmin = INT_MAX;
  for (int kt = warp; kt < e.ktiles; kt += NT / 32) {
    bool may = false;
    for (int j = lane; j < KEYS; j += 32) {
      const int key = kt * KEYS + j;
      const int kp = key < e.T ? kpos[key] : -1;
      if (kp >= 0) kmin = min(kmin, kp);
      may |= kp >= 0 && (!causal || kp <= qmax) && (window < 0 || (long long)qmin - kp < window);
    }
    if (__any_sync(0xffffffffu, may) && lane == 0) atomicOr(mask + (kt >> 5), 1u << (kt & 31));
  }
  {
    int unused = INT_MIN;
    warp_min_max(kmin, unused);
    if (lane == 0) atomicMin(red + 3, kmin);
  }
  if (window >= 0) {
    for (int r = warp; r < e.rows && it.q0 + r < e.S; r += NT / 32) {
      const int qp = qpos[it.q0 + r];
      bool any = false;
      for (int j0 = 0; j0 < e.T && !any; j0 += 32) {
        const int j = j0 + lane;
        any = __any_sync(0xffffffffu, j < e.T && allowed(qp, kpos[j], causal, window));
      }
      if (lane == 0 && !any) red[2] = 0;
    }
  }
  group_sync<NT>(grp);
  const bool every = window >= 0 ? red[2] != 0 : causal ? qmin >= red[3] : red[3] != INT_MAX;
  if (!every) {  // a row with no allowed slot: every key tile, for its uniform average
    for (int w = tid; w < words; w += NT)
      mask[w] = w < (e.ktiles >> 5) ? ~0u : (1u << (e.ktiles & 31)) - 1u;
  }
  if constexpr (!L::kRaw) cp_async_wait<0>();
  group_sync<NT>(grp);
  if (skipped != nullptr && tid == 0) {
    int live = 0;
    for (int w = 0; w < words; ++w) live += __popc(mask[w]);
    atomicAdd(skipped, e.ktiles - live);
  }

  // this thread's row-heads: gq and gq + 8 of its warp's 16
  const int r_lo = rw * 16 + gq, r_hi = r_lo + 8;
  const bool v_lo = rh_valid(r_lo), v_hi = rh_valid(r_hi);
  const int qp_lo = v_lo ? qpos[it.q0 + r_lo / e.heads] : 0;
  const int qp_hi = v_hi ? qpos[it.q0 + r_hi / e.heads] : 0;
  const Bounds b_lo = bounds_of(qp_lo, causal, window), b_hi = bounds_of(qp_hi, causal, window);
  // bf16 q's A fragments stay in registers for the whole walk at HD <=
  // 128 (float32's three planes, and bf16's at HD > 128, are read from
  // shared memory at each tile)
  constexpr bool kQReg = P == 1 && !L::kWide;
  constexpr int QR = kQReg ? HD / 16 : 1;
  uint32_t qreg[QR][1][4];
  if constexpr (kQReg) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) load_a(qreg[kk][0], qs, LD, rw * 16, kk * 16, lane);
  }

  auto load_tile = [&](int kt, int st) {
    unsigned char* base = ring + st * L::kStage;
    const int k0 = kt * KEYS, nvalid = e.T - k0;
    const size_t off = ((size_t(it.b) * e.T + k0) * e.KV + it.kvh) * HD;
    __nv_bfloat16* planes = reinterpret_cast<__nv_bfloat16*>(base);
    int* kps = reinterpret_cast<int*>(base + L::kStage - KEYS * 4);
    if constexpr (L::kRaw) {
      load_split_rows<HD, P>(planes, L::kPlaneK, k + off, k_row, KEYS, nvalid, tid, NT);
      load_split_rows<HD, P>(planes + P * L::kPlaneK, L::kPlaneK, v + off, k_row, KEYS, nvalid,
                             tid, NT);
      if (tid < KEYS) kps[tid] = tid < nvalid ? kpos[k0 + tid] : -1;
    } else {
      copy_rows<T, HD, LD>(reinterpret_cast<T*>(planes), k + off, k_row, KEYS, nvalid, tid, NT);
      copy_rows<T, HD, LD>(reinterpret_cast<T*>(planes + L::kPlaneK), v + off, k_row, KEYS,
                           nvalid, tid, NT);
      if (tid < KEYS) cp_async4(kps + tid, kpos + (tid < nvalid ? k0 + tid : 0), tid < nvalid);
    }
  };

  float acc[HW / 8][4];
#pragma unroll
  for (int j = 0; j < HW / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;

  int cur = next_live(mask, words, 0);
  if constexpr (!L::kRaw) {
    if (cur >= 0) load_tile(cur, 0);
    cp_async_commit();
  }
  for (int iter = 0; cur >= 0; ++iter) {
    const int nxt = next_live(mask, words, cur + 1);
    int st = 0;
    if constexpr (L::kRaw) {
      load_tile(cur, 0);
      group_sync<NT>(grp);
    } else {
      if (nxt >= 0) load_tile(nxt, (iter + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      group_sync<NT>(grp);  // this step's tile landed
      st = iter & 1;
    }
    const unsigned char* base = ring + st * L::kStage;
    const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(base);
    const __nv_bfloat16* vs = ks + P * L::kPlaneK;
    const int* kps = reinterpret_cast<const int*>(base + L::kStage - KEYS * 4);
    const int k0 = cur * KEYS;

    // s = q k^T: 16 row-heads x KEYS slots per warp
    float sc[KEYS / 8][4];
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[P][4];  // q's planes, when not held in registers
      if constexpr (!kQReg) {
#pragma unroll
        for (int p = 0; p < P; ++p) load_a(qa[p], qs + p * L::kPlaneQ, LD, rw * 16, kk * 16, lane);
      }
#pragma unroll
      for (int np = 0; np < KEYS / 16; ++np) {
        uint32_t kb[P][4];
#pragma unroll
        for (int p = 0; p < P; ++p) load_b_nk(kb[p], ks + p * L::kPlaneK, LD, 16 * np, 16 * kk, lane);
        if constexpr (kQReg) {
          mma_terms<P, P, N>(sc[2 * np], qreg[kk], kb, 0);
          mma_terms<P, P, N>(sc[2 * np + 1], qreg[kk], kb, 1);
        } else {
          mma_terms<P, P, N>(sc[2 * np], qa, kb, 0);
          mma_terms<P, P, N>(sc[2 * np + 1], qa, kb, 1);
        }
      }
    }
    // scores and masks
    float mx_lo = minus_inf(), mx_hi = minus_inf();
    tile_scores<KEYS, kSoftcap>(sc, kps, k0, e.T, t4, b_lo, b_hi, softcap, scale, mx_lo, mx_hi);
    // the online softmax: a row's four lanes share its max and sum
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool hi = c >= 2;
        const float p = expf(sc[j][c] - (hi ? mn_hi : mn_lo));
        sc[j][c] = p;
        if (hi)
          sum_hi += p;
        else
          sum_lo += p;
      }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, o);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, o);
    }
    const float corr_lo = expf(m_lo - mn_lo), corr_hi = expf(m_hi - mn_hi);
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int j = 0; j < HW / 8; ++j) {
      acc[j][0] *= corr_lo;
      acc[j][1] *= corr_lo;
      acc[j][2] *= corr_hi;
      acc[j][3] *= corr_hi;
    }
    // acc += p v over this warp's columns, p as PT bf16 terms
#pragma unroll
    for (int kq = 0; kq < KEYS / 16; ++kq) {
      uint32_t pa[PT][4];
      split_a(pa, sc[2 * kq], sc[2 * kq + 1]);
#pragma unroll
      for (int np = 0; np < HW / 16; ++np) {
        uint32_t vb[P][4];
#pragma unroll
        for (int p = 0; p < P; ++p)
          load_b_kn(vb[p], vs + p * L::kPlaneK, LD, 16 * kq, c0 + 16 * np, lane);
        mma_terms<PT, P, N>(acc[2 * np], pa, vb, 0);
        mma_terms<PT, P, N>(acc[2 * np + 1], pa, vb, 1);
      }
    }
    group_sync<NT>(grp);  // this stage is consumed before it is refilled
    cur = nxt;
  }
  if constexpr (!L::kRaw) cp_async_wait<0>();

  // o = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30)) when asked (a
  // row with no allowed slot: m = NEG_INF, l = T, so lse rounds to NEG_INF)
  const float lf_lo = fmaxf(l_lo, 1e-30f), lf_hi = fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int j = 0; j < HW / 8; ++j) {
    const int col = c0 + j * 8 + 2 * t4;
    if (v_lo)
      *reinterpret_cast<float2*>(out + rh_off(r_lo) + col) =
          make_float2(acc[j][0] / lf_lo, acc[j][1] / lf_lo);
    if (v_hi)
      *reinterpret_cast<float2*>(out + rh_off(r_hi) + col) =
          make_float2(acc[j][2] / lf_hi, acc[j][3] / lf_hi);
  }
  if (lse != nullptr && t4 == 0 && c0 == 0) {
    if (v_lo)
      lse[(size_t(it.b) * e.H + rh_head(r_lo)) * e.S + it.q0 + r_lo / e.heads] = m_lo + logf(lf_lo);
    if (v_hi)
      lse[(size_t(it.b) * e.H + rh_head(r_hi)) * e.S + it.q0 + r_hi / e.heads] = m_hi + logf(lf_hi);
  }
}

// -------------------------------------------------------------- decode
// Shared memory, in bytes; kept in step with kernels/flash_attention.py
// `smem_bytes`: q, the ring, the scores and three stats per row, for the g
// rows of the group (so a small group leaves room for more blocks per SM).
// K and V rows are padded by 16 bytes, so the 16-byte reads of eight
// neighbouring slots fall in distinct banks.
template <typename T, int HD>
struct DecLayout {
  static constexpr int LD = HD + 16 / int(sizeof(T));
  static constexpr int kTile = kDecTile * LD * int(sizeof(T));
  static constexpr int kStage = 2 * kTile + kDecTile * 4;  // k, v, slot positions
  static constexpr int kRing = kDecStages * kStage;
  static __host__ __device__ constexpr int q_bytes(int g) { return (g * HD * 4 + 15) / 16 * 16; }
  static __host__ __device__ constexpr int bytes(int g) {
    return q_bytes(g) + kRing + g * kDecTile * 4 + 3 * g * 4;
  }
};

// T cut into `chunks` of `chunk` slots (a multiple of kDecStep, the last
// one possibly shorter, none empty), as many as give about kDecPerSm
// blocks per SM over the B x KV (batch, KV head) pairs, at most
// kDecMaxChunks
struct DecSplit {
  int chunks, chunk;
};

DecSplit decode_split(int B, int T_len, int KV, int sms) {
  long long want = (long long)kDecPerSm * sms / ((long long)B * KV);
  if (want < 1) want = 1;
  if (want > kDecMaxChunks) want = kDecMaxChunks;
  const long long most = (T_len + kDecStep - 1) / kDecStep;
  const int n = int(want < most ? want : most);
  int chunk = (T_len + n - 1) / n;
  chunk = (chunk + kDecStep - 1) / kDecStep * kDecStep;
  return {(T_len + chunk - 1) / chunk, chunk};
}

// a float32 q row against one staged k row
// a float32 q row against one staged k row: four FMA chains (d mod 4),
// added in a fixed order at the end
template <int HD>
__device__ __forceinline__ float dot_row(const float* qr, const __nv_bfloat16* kr) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < HD; c += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(kr + c);
    const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float4 qa = *reinterpret_cast<const float4*>(qr + c);
    const float4 qb = *reinterpret_cast<const float4*>(qr + c + 4);
    const float2 x0 = __bfloat1622float2(k2[0]), x1 = __bfloat1622float2(k2[1]);
    const float2 x2 = __bfloat1622float2(k2[2]), x3 = __bfloat1622float2(k2[3]);
    d[0] = fmaf(qa.x, x0.x, d[0]);
    d[1] = fmaf(qa.y, x0.y, d[1]);
    d[2] = fmaf(qa.z, x1.x, d[2]);
    d[3] = fmaf(qa.w, x1.y, d[3]);
    d[0] = fmaf(qb.x, x2.x, d[0]);
    d[1] = fmaf(qb.y, x2.y, d[1]);
    d[2] = fmaf(qb.z, x3.x, d[2]);
    d[3] = fmaf(qb.w, x3.y, d[3]);
  }
  return (d[0] + d[1]) + (d[2] + d[3]);
}

template <int HD>
__device__ __forceinline__ float dot_row(const float* qr, const float* kr) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < HD; c += 4) {
    const float4 kx = *reinterpret_cast<const float4*>(kr + c);
    const float4 qx = *reinterpret_cast<const float4*>(qr + c);
    d[0] = fmaf(qx.x, kx.x, d[0]);
    d[1] = fmaf(qx.y, kx.y, d[1]);
    d[2] = fmaf(qx.z, kx.z, d[2]);
    d[3] = fmaf(qx.w, kx.w, d[3]);
  }
  return (d[0] + d[1]) + (d[2] + d[3]);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                    float* __restrict__ out, float* __restrict__ lse, float* __restrict__ ws,
                    int* __restrict__ counters, int* __restrict__ skipped, int T_len, int H,
                    int KV, int chunk, int window, float softcap, float scale) {
  using L = DecLayout<T, HD>;
  constexpr int LD = L::LD;
  constexpr int NO = kMaxG * HD / kDecThreads;  // outputs (row, column) a thread may own
  constexpr int REC = HD + 2;                   // a partial: acc[HD], m, l
  static_assert(2 * kDecMaxChunks * kMaxG * 4 <= L::kRing, "the combine's (m, l) fit the ring");
  // the KV heads of a chunk run side by side: their slots share cache rows in memory
  const int kvh = blockIdx.x, c = blockIdx.y, b = blockIdx.z, chunks = gridDim.y;
  const int g = H / KV;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);     // [g][HD]
  unsigned char* ring = smem + L::q_bytes(g);     // kDecStages x (k, v, slots)
  float* ps = reinterpret_cast<float*>(ring + L::kRing);  // [g][kDecTile]
  float* ms = ps + g * kDecTile;  // [g] running max
  float* ls = ms + g;             // [g] running sum
  float* cs = ls + g;             // [g] this tile's correction

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qp = q_pos[b];
  const int c0 = c * chunk, c1 = min(T_len, c0 + chunk);
  const int* kpos = k_pos + size_t(b) * T_len;
  const size_t k_row = size_t(KV) * HD;
  const int pair = b * KV + kvh;
  float* part = ws + (size_t(pair) * chunks + c) * g * REC;

  // the g rows share qp: whether the chunk has an allowed slot
  bool may = false;
  for (int j = c0 + tid; j < c1; j += kDecThreads) may |= allowed(qp, kpos[j], 1, window);
  if (!__syncthreads_or(may)) {
    if (skipped != nullptr && tid == 0) atomicAdd(skipped, 1);
    for (int r = tid; r < g; r += kDecThreads) part[r * REC + HD + 1] = 0.f;  // the flag: l = 0
  } else {
    auto load_tile = [&](int i, int st) {
      unsigned char* base = ring + st * L::kStage;
      const int k0 = c0 + i * kDecTile, nvalid = min(kDecTile, c1 - k0);
      const size_t off = ((size_t(b) * T_len + k0) * KV + kvh) * HD;
      copy_rows<T, HD, LD>(reinterpret_cast<T*>(base), k + off, k_row, kDecTile, nvalid, tid,
                           kDecThreads);
      copy_rows<T, HD, LD>(reinterpret_cast<T*>(base + L::kTile), v + off, k_row, kDecTile,
                           nvalid, tid, kDecThreads);
      int* kps = reinterpret_cast<int*>(base + 2 * L::kTile);
      if (tid < kDecTile) cp_async4(kps + tid, kpos + (tid < nvalid ? k0 + tid : 0), tid < nvalid);
    };
    const int ntiles = (c1 - c0 + kDecTile - 1) / kDecTile;
    load_tile(0, 0);
    cp_async_commit();
    for (int i = tid; i < g * HD; i += kDecThreads)
      qs[i] = to_f32(q[(size_t(b) * H + kvh * g) * HD + i]);
    if (tid < g) {
      ms[tid] = kNegInf;
      ls[tid] = 0.f;
    }
    // output o of this thread: row (tid + o * 128) / HD, column (tid + o * 128) % HD
    float acc[NO];
#pragma unroll
    for (int o = 0; o < NO; ++o) acc[o] = 0.f;

    for (int t = 0; t < ntiles; ++t) {
      if (t + 1 < ntiles) load_tile(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // this step's tile landed (and q, the stats, at t = 0)
      const unsigned char* base = ring + (t & 1) * L::kStage;
      const T* ks = reinterpret_cast<const T*>(base);
      const T* vs = reinterpret_cast<const T*>(base + L::kTile);
      const int* kps = reinterpret_cast<const int*>(base + 2 * L::kTile);
      const int nvalid = min(kDecTile, c1 - (c0 + t * kDecTile));

      // scores: (row, slot) pairs; slots past the chunk do not exist here
      for (int i = tid; i < g * kDecTile; i += kDecThreads) {
        const int r = i / kDecTile, j = i % kDecTile;
        float x = score(dot_row<HD>(qs + r * HD, ks + j * LD), scale, softcap);
        if (!allowed(qp, kps[j], 1, window)) x = kNegInf;
        if (j >= nvalid) x = minus_inf();
        ps[i] = x;
      }
      __syncthreads();
      // the online softmax: a warp per row, a lane per slot
      for (int r = warp; r < g; r += kDecThreads / 32) {
        const float x = ps[r * kDecTile + lane];
        float mx = x;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = ms[r], m_new = fmaxf(m_old, mx);
        const float p = expf(x - m_new);
        ps[r * kDecTile + lane] = p;
        float sum = p;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          cs[r] = corr;
          ls[r] = ls[r] * corr + sum;
          ms[r] = m_new;
        }
      }
      __syncthreads();
      // acc = acc * corr + p v, for the (row, column) outputs this thread owns
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        const int i = tid + o * kDecThreads, r = i / HD, col = i % HD;
        if (r < g) {  // warp-uniform
          float a = acc[o] * cs[r];
#pragma unroll 8
          for (int j = 0; j < kDecTile; ++j)
            a = fmaf(ps[r * kDecTile + j], to_f32(vs[j * LD + col]), a);
          acc[o] = a;
        }
      }
      __syncthreads();  // this stage and the scores are consumed before they are refilled
    }
    cp_async_wait<0>();
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      const int i = tid + o * kDecThreads, r = i / HD;
      if (r < g) part[r * REC + i % HD] = acc[o];
    }
    for (int r = tid; r < g; r += kDecThreads) {
      part[r * REC + HD] = ms[r];
      part[r * REC + HD + 1] = ls[r];
    }
  }
  if (chunks > 1) {
    if (!split_k_last(counters, pair, chunks)) return;
  } else {
    __syncthreads();  // one chunk: its partial, this block's own, is out
  }

  // the last block of (b, KV head): the partials of chunks 0, 1, 2, ... in
  // order.  First every chunk's (m, l) at once into the ring (free now),
  // then a thread per row its weights exp(m_c - M) (0 for a chunk with no
  // allowed slot, whose acc was never written) and L, then each output
  // sum_c acc_c w_c, eight chunks' loads in flight at a time.
  const float* parts = ws + size_t(pair) * chunks * g * REC;
  float* wts = reinterpret_cast<float*>(ring);  // [chunks][g]: m, then the weight
  float* lsum = wts + chunks * g;               // [chunks][g]: l
  for (int i = tid; i < chunks * g; i += kDecThreads) {
    const float* rec = parts + size_t(i) * REC;
    const float l = __ldcg(rec + HD + 1);
    wts[i] = l > 0.f ? __ldcg(rec + HD) : minus_inf();  // m, or -inf: no allowed slot
    lsum[i] = l;
  }
  __syncthreads();
  if (tid < g) {
    float m_all = minus_inf();
    for (int cc = 0; cc < chunks; ++cc) m_all = fmaxf(m_all, wts[cc * g + tid]);
    float l_all = 0.f;
    for (int cc = 0; cc < chunks; ++cc) {
      const float m = wts[cc * g + tid];
      const float w = m == minus_inf() ? 0.f : expf(m - m_all);
      if (w != 0.f) l_all = fmaf(lsum[cc * g + tid], w, l_all);
      wts[cc * g + tid] = w;
    }
    ls[tid] = l_all;
    ms[tid] = m_all;  // -inf: no chunk of the row had an allowed slot
    if (lse != nullptr)
      lse[size_t(b) * H + kvh * g + tid] =
          m_all == minus_inf() ? kNegInf : m_all + logf(fmaxf(l_all, 1e-30f));
  }
  __syncthreads();
  for (int i = tid; i < g * HD; i += kDecThreads) {
    const int r = i / HD, d = i % HD;
    float o;
    if (ms[r] != minus_inf()) {
      float a = 0.f;
      for (int c0 = 0; c0 < chunks; c0 += 8) {
        float x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int cc = c0 + u;
          x[u] = cc < chunks && wts[cc * g + r] != 0.f
                     ? __ldcg(parts + (size_t(cc) * g + r) * REC + d) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int cc = c0 + u;
          if (cc < chunks && wts[cc * g + r] != 0.f) a = fmaf(x[u], wts[cc * g + r], a);
        }
      }
      o = a / fmaxf(ls[r], 1e-30f);
    } else {
      // no allowed slot in T: the uniform average of every slot, the reference's result
      float s = 0.f;
      for (int j = 0; j < T_len; ++j) s += to_f32(v[((size_t(b) * T_len + j) * KV + kvh) * HD + d]);
      o = s / float(T_len);
    }
    out[(size_t(b) * H + kvh * g + r) * HD + d] = o;
  }
  if (chunks > 1) split_k_release(counters, pair);
}

// -------------------------------------------------------------- launch
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

// One launch of either kernel: its grid, threads per block, dynamic shared
// memory, and each block's work: the forward's query rows, query heads
// and key slots per tile; the decode's query heads and slots per chunk.
// The launches below use it, and flash_attention_plan exports it, so that
// kernels/flash_attention.py `launch_plan` can be held to it.
struct Plan {
  dim3 grid;
  int threads;
  size_t smem;
  int rows, heads, keys;
};

struct Args {
  const void *q, *k, *v, *q_pos, *k_pos;
  void *out, *lse, *ws, *counters, *skipped;
  long long ws_floats;
  int B, S, T_len, H, KV, causal, window, sms;
  float softcap, scale;
};

template <typename T, int HD>
cudaError_t plan_fwd(const Args& a, Plan* p) {
  using L = FwdLayout<T, HD>;
  const FwdGeometry e = fwd_geometry(a.B, a.S, a.T_len, a.H, a.KV, L::kKeys);
  if (e.items > INT_MAX || a.sms < 1) return cudaErrorInvalidValue;
  const int G = fwd_groups<T, HD>(e.items, a.sms);
  p->grid = dim3(unsigned((e.items + G - 1) / G), 1, 1);
  p->threads = G * L::kThreads;
  p->smem = G * (L::kFixed + mask_bytes(e.ktiles));
  p->rows = e.rows;
  p->heads = e.heads;
  p->keys = L::kKeys;
  return p->smem <= size_t(kMaxSmem) ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int HD>
cudaError_t plan_decode(const Args& a, Plan* p) {
  if (a.sms < 1 || a.H / a.KV > kMaxG) return cudaErrorInvalidValue;
  const DecSplit d = decode_split(a.B, a.T_len, a.KV, a.sms);
  p->grid = dim3(a.KV, d.chunks, a.B);
  p->threads = kDecThreads;
  p->smem = DecLayout<T, HD>::bytes(a.H / a.KV);
  p->rows = 1;
  p->heads = a.H / a.KV;
  p->keys = d.chunk;
  return cudaSuccess;
}

template <typename T, int HD>
cudaError_t launch_fwd(const Args& a, cudaStream_t stream) {
  Plan p;
  cudaError_t err = plan_fwd<T, HD>(a, &p);
  if (err != cudaSuccess) return err;
  auto kernel = a.softcap != 0.f ? flash_attention_kernel<T, HD, true>
                                 : flash_attention_kernel<T, HD, false>;
  static size_t sized[2][kMaxDevices] = {};
  err = reserve_smem(kernel, p.smem, sized[a.softcap != 0.f]);
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, p.threads, p.smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int*>(a.q_pos), static_cast<const int*>(a.k_pos),
      static_cast<float*>(a.out), static_cast<float*>(a.lse), static_cast<int*>(a.skipped),
      fwd_geometry(a.B, a.S, a.T_len, a.H, a.KV, FwdLayout<T, HD>::kKeys), a.causal, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_decode(const Args& a, cudaStream_t stream) {
  Plan p;
  cudaError_t err = plan_decode<T, HD>(a, &p);
  if (err != cudaSuccess) return err;
  // the partials: one (acc[HD], m, l) per (b, KV head, chunk, row)
  const long long need = (long long)a.B * a.KV * p.grid.y * p.heads * (HD + 2);
  if (a.ws == nullptr || a.counters == nullptr || a.ws_floats < need) return cudaErrorInvalidValue;
  auto kernel = flash_decode_kernel<T, HD>;
  static size_t sized[kMaxDevices] = {};
  err = reserve_smem(kernel, p.smem, sized);
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, p.threads, p.smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int*>(a.q_pos), static_cast<const int*>(a.k_pos),
      static_cast<float*>(a.out), static_cast<float*>(a.lse), static_cast<float*>(a.ws),
      static_cast<int*>(a.counters), static_cast<int*>(a.skipped), a.T_len, a.H, a.KV, p.keys,
      a.window, a.softcap, a.scale);
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

cudaError_t fwd_dispatch(int dtype, int hd, const Args& a, cudaStream_t s) {
  DISPATCH(launch_fwd, a, s)
}

cudaError_t decode_dispatch(int dtype, int hd, const Args& a, cudaStream_t s) {
  DISPATCH(launch_decode, a, s)
}

cudaError_t plan_dispatch(int kernel, int dtype, int hd, const Args& a, Plan* p) {
  if (kernel == 0) {
    DISPATCH(plan_fwd, a, p)
  }
  DISPATCH(plan_decode, a, p)
}

bool bad_args(int dtype, int B, int S, int T_len, int H, int KV) {
  return (dtype != 0 && dtype != 1) || B < 1 || S < 1 || T_len < 1 || KV < 1 || H < KV ||
         H % KV != 0 || KV > 65535 || B > 65535;
}

}  // namespace

// q (B, S, H, hd), k/v (B, T, KV, hd) float32 or bf16 (dtype 0 or 1),
// 16-byte aligned; positions int32 (B, S), (B, T); out f32 (B, S, H, hd);
// lse f32 (B, H, S) or null; skipped: null, or an int32 to which the
// kernel adds the (work item, key tile) pairs it skips; window -1 for
// none; sms: the card's SMs, which the grid's shape follows.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* q_pos, const void* k_pos, void* out,
                                      void* lse, void* skipped, int dtype, int B, int S,
                                      int T_len, int H, int KV, int hd, int causal, int window,
                                      float softcap, float scale, int sms, int device,
                                      void* stream) {
  if (bad_args(dtype, B, S, T_len, H, KV)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Args a{q, k, v, q_pos, k_pos, out, lse, nullptr, nullptr, skipped, 0, B, S, T_len, H,
               KV, causal, window, sms, softcap, scale};
  return int(fwd_dispatch(dtype, hd, a, static_cast<cudaStream_t>(stream)));
}

// q (B, H, hd), k/v (B, T, KV, hd), q_pos (B,), k_pos (B, T); out f32 (B,
// H, hd); lse f32 (B, H) or null; ws: ws_floats float32 for the chunks'
// partials; counters: B x KV
// zeroed int32 (split_k.cuh); skipped: null, or an int32 to which the
// kernel adds the (b, KV head, chunk) triples it skips; sms: the SMs the
// split fills.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* q_pos, const void* k_pos, void* out, void* lse,
                                   void* ws, long long ws_floats, void* counters, void* skipped,
                                   int dtype, int B, int T_len, int H, int KV, int hd,
                                   int window, float softcap, float scale, int sms, int device,
                                   void* stream) {
  if (bad_args(dtype, B, 1, T_len, H, KV)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Args a{q, k, v, q_pos, k_pos, out, lse, ws, counters, skipped, ws_floats, B, 1,
               T_len, H, KV, 1, window, sms, softcap, scale};
  return int(decode_dispatch(dtype, hd, a, static_cast<cudaStream_t>(stream)));
}

// The launch of the forward (kernel 0) or the decode (1) for these
// arguments: out = {grid x, y, z, threads, shared-memory bytes, query rows
// per item, query heads per item or block, key slots per tile or chunk}.
extern "C" int flash_attention_plan(int kernel, int dtype, int B, int S, int T_len, int H,
                                    int KV, int hd, int sms, long long* out) {
  if (bad_args(dtype, B, S, T_len, H, KV) || (kernel != 0 && kernel != 1))
    return int(cudaErrorInvalidValue);
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, 0, B, S, T_len, H, KV, 1, -1, sms, 0.f, 1.f};
  Plan p;
  cudaError_t err = plan_dispatch(kernel, dtype, hd, a, &p);
  if (err != cudaSuccess) return int(err);
  const long long plan[kPlan] = {p.grid.x, p.grid.y, p.grid.z, p.threads, (long long)p.smem,
                                 p.rows, p.heads, p.keys};
  for (int i = 0; i < kPlan; ++i) out[i] = plan[i];
  return 0;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
