// approx_attention.cu: flash attention with the approximate multiplier in
// the QK and AV contractions, modes `bitexact` and `lowrank`.
//
// Replaces: src/repro/kernels/approx_attention.py `_bitexact_kernel` (:184)
// and `_lowrank_kernel` (:171), one pallas_call at :314 (entry
// approx_flash_attention at :333); the shared step is `_online_update`
// (:77) with the tiles `_bitexact_tile` (:119) and `_lowrank_tile` (:99).
//
// Per (batch, head, query row) and key block of bk slots, in order:
//   s    = s_int * (qk_scale * scale); tanh softcap; NEG_INF where masked
//   m'   = max(m, max_j s);  p = exp(s - m');  corr = exp(m - m')
//   l'   = l * corr + sum_j p;  p_int = rint(p * (2^n - 1))
//   acc' = acc * corr + av_int(p_int) * pv_scale
// and at the end o = acc / max(l, 1e-30) and, when the caller asks for it
// (training), lse = m + log(max(l, 1e-30)), the residual on which the
// exact backward of csrc/flash_attention_bwd.cu runs.  bitexact: s_int =
// sum_d LUT[|q|, |k|] sq sk and av_int = sum_j LUT[p_int, |v|] sv, both
// integers (products < 2^16, at most 128 terms: exact in int32 and in the
// reference's float32).  lowrank: s_int = qi . ki + sum_d,r sq U[|q|, r]
// sk V[|k|, r] and av_int = p_int . vi + sum_j,r U[p_int, r] sv V[|v|, r],
// the exact integer products plus the rank-r SVD correction, as
// lowrank_matmul.cu computes its GEMM.
//
// The function.  The key block bk is the caller's: p_int is taken against
// the running max of the blocks seen so far, so another bk gives other
// integers, and no launch splits T or merges partial softmaxes.  The
// blocks are walked in order and the last one is padded past T with
// masked, zero slots, as the reference pads it.  NEG_INF is the
// reference's finite -2.3819763e38, never -inf: a fully masked block gets
// p = exp(0) = 1 and is erased by the next allowed block through corr =
// exp(NEG_INF - m) = 0; a row with no allowed slot (a left pad) ends as a
// finite uniform average over every padded slot.  The elementwise float
// steps use __fmul_rn / __fadd_rn / __fdiv_rn, so nvcc fuses none of them
// into an FMA the reference does not compute; rintf rounds half to even,
// as jnp.round and torch.round do.
//
// The masked-block rule.  Every table has LUT[0, .] = LUT[., 0] = 0 and
// U[0] = V[0] = 0 (tests/test_torch_approx_attention_plan.py checks each).
// A block in which no row of a query tile may attend any slot leaves that
// tile's (m, l, acc) as they were, for every row that has an allowed slot
// somewhere: after the row's first allowed slot p = exp(NEG_INF - m) = 0,
// so p_int = 0, the block adds exactly 0 and corr = 1; before it, the
// next allowed block erases the block through corr = 0.  So a (tile,
// block) pair is skipped when (a) no row of the tile may attend a slot of
// the block, judged from the tile's least and greatest position against
// each written slot, and (b) every row of the tile has an allowed slot in
// T; a tile with a row that has none (a left pad) walks every block.  The
// kernel decides both on the card from q_pos / k_pos in the same launch;
// kernels/approx_attention.py `approx_tile_plan` is the same rule in
// PyTorch, and the tests run the plain version with those pairs left out.
// Given a counter (`skipped`, null on the serve and train paths), thread 0
// of a block adds one to it for each (work item, key block) pair the block
// skips, so a caller can hold the count on the card against the plan's.
//
// Work items.  A persistent grid of min(items, SMs) blocks; an item is
// (batch, KV head, query-row tile) with the g = H / KV query heads of the
// group (chunks of them when g is large), so that they share each staged
// key block: RH row-heads, row-head i being row i / G and head i % G of
// the item.  Items go longest first (the last query tiles: causal rows
// walk more blocks) and are dealt to the blocks in snake order, item b
// and 2 grid - 1 - b to block b, and so on: a static assignment, so two
// launches on the same inputs give the same bits.  `make_plan` (and the
// exported approx_attention_plan) gives RH, the grid and the shared memory.
//
// bitexact: a lookup-bound kernel, fed.  512 threads; the uint16 table is
// copied into shared memory once per block (128 KiB at n = 8), so one
// block per SM.  q is held as one word per (d, row-head): its table row's
// byte offset and its sign in the top byte; a key block's k (then v) as
// one 16-bit value per element, 2 |k| + 2048 sk (the byte offset in a
// table row, the sign by an arithmetic shift), staged 64 slots at a time.
// QK: a thread owns 4 row-heads by one or two slots (lanes across slots,
// so the warp's 32 lookups fall in one table row, and q is a broadcast);
// AV: TM row-heads by HD / 32 columns (lanes across columns, p_int a
// broadcast).  The scores go to shared memory, a warp per row-head takes
// the softmax and writes p_int's table-row offset over its score.  RH is
// 16 TM (32 TM at HD 16): the host picks TM = 4, 2 or 1, the largest whose
// block fits the shared memory (at HD 256 and n = 8 TM = 4 needs 263,696
// bytes, so TM <= 2 there) and that still gives every SM an item.  Bound on
// the H100: 2 lookups per needed (query head, slot) pair and d at the
// shared-memory rate.
//
// lowrank: both contractions as lowrank_matmul tiles (lowrank_tiles.cuh).
// 256 threads, RH = 32 (two m16 tiles), the whole key block (up to 128
// slots) staged at once.  The exact parts run on int8 planes, mma.sync
// m16n8k32.s8: QK with q (row-heads) as A and k (slots) as B over d, AV
// with p_int (two unsigned planes) as A and v^T as B over the slots.  The
// corrections run on split TF32, mma.sync m16n8k8, from (hi, lo) pairs of
// U and V in shared memory (32 KiB at n = 8, r = 8): QK over (d, r) with
// U[|q|] sq as A and V[|k|] sk as B, AV over (slot, r) with U[p_int] as A
// and V[|v|] sv as B.  A fresh accumulator takes kFlush = 16 elements and
// is then added (round to nearest) to the float32 sum, as in
// lowrank_matmul.cu; s_int and av_int are float(exact) + correction, as
// the reference adds its two float32 products.  A warp owns one m16 tile
// by four n8 tiles (32 slots in QK, 32 columns in AV), MMA column g of
// n-tile j being slot or column 4g + j of the warp's 32.  The kernel reads
// magnitudes and signs, two bytes per element, and builds the planes and
// table entries in shared memory; no r-wide embedding reaches HBM.  Bound
// on the H100: per needed pair, the exact products (2 hd) as int8 tensor-
// core products, 4 each, and the corrections' 2 hd r as split TF32, 3
// each, plus r lookups for U[p_int].  At HD 256 AV has eight column groups
// of 32 for the four warp groups: each warp takes two (`kColGroups`), and
// the tables fit beside the key block up to rank 8 (226,448 bytes at n =
// 8; rank 24 would need 292,240, and the launch refuses it: the key block
// is part of the function and is not shrunk to make room).

#include <cstdint>
#include <cuda_runtime.h>

#include "lowrank_tiles.cuh"

namespace {

constexpr float kNegInf = -2.3819763e38f;
constexpr int kMaxBK = 128;      // largest key block
constexpr int kSST = kMaxBK;     // floats per row of the scores
constexpr int kMaxSmem = 232448;
constexpr int kBitexactThreads = 512;
constexpr int kChunk = 64;       // bitexact: key slots staged at a time
constexpr int kLowrankThreads = 256;
constexpr int kLowrankRH = 32;   // lowrank: row-heads per item, two m16 tiles
constexpr int kFlush = 16;       // lowrank: elements per tensor-core partial of a correction
constexpr int kPlan = 7;         // approx_attention_plan's outputs

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// ------------------------------------------------------------ geometry
// One launch's work items: (batch, KV head, head chunk, query-row tile).
struct Geometry {
  int B, S, T, H, KV, g;
  int rh;      // row-heads per item
  int heads;   // G: query heads per item (of the KV head's g)
  int rows;    // R: query rows per item
  int chunks;  // head chunks per KV head
  int tiles;   // query-row tiles
  long long items;
  int* skipped = nullptr;  // null, or a count of the (item, key block) pairs skipped
};

__host__ __device__ Geometry geometry(int B, int S, int T, int H, int KV, int rh) {
  Geometry e;
  e.B = B, e.S = S, e.T = T, e.H = H, e.KV = KV, e.g = H / KV, e.rh = rh;
  e.heads = imin(e.g, rh);
  e.rows = rh / e.heads;
  e.chunks = (e.g + e.heads - 1) / e.heads;
  e.tiles = (S + e.rows - 1) / e.rows;
  e.items = (long long)B * KV * e.chunks * e.tiles;
  return e;
}

struct Item {
  int b, kvh, h0, q0;  // h0: the item's first head within the group
};

// item `idx`: the last query tiles first
__device__ Item item_at(const Geometry& e, int idx) {
  const int rest = e.B * e.KV * e.chunks;
  Item it;
  it.q0 = (e.tiles - 1 - idx / rest) * e.rows;
  int r = idx % rest;
  it.h0 = (r % e.chunks) * e.heads;
  r /= e.chunks;
  it.kvh = r % e.KV;
  it.b = r / e.KV;
  return it;
}

// the item a block takes in `round`: snake order over the grid
__device__ __forceinline__ long long item_index(int round, int grid) {
  const int blk = blockIdx.x;
  return (long long)round * grid + ((round & 1) ? grid - 1 - blk : blk);
}

// row-head i of an item: query row, head (global), whether it exists
struct RowHead {
  int row, h;
  bool valid;
};

__device__ __forceinline__ RowHead row_head(const Geometry& e, const Item& it, int i) {
  const int head = it.h0 + i % e.heads;
  RowHead r;
  r.row = it.q0 + i / e.heads;
  r.h = it.kvh * e.g + head;
  r.valid = i < e.rows * e.heads && r.row < e.S && head < e.g;
  return r;
}

__device__ __forceinline__ bool allowed(int qp, int kp, int causal, int window) {
  if (kp < 0) return false;
  if (causal && qp < kp) return false;
  if (window >= 0 && qp - kp >= window) return false;
  return true;
}

// The score of one (row, slot) from its integer-valued s_int.
__device__ __forceinline__ float approx_score(float s_int, float qk, float softcap, int qp,
                                              int kp, int causal, int window) {
  float s = __fmul_rn(s_int, qk);
  if (softcap != 0.f) s = __fmul_rn(tanhf(__fdiv_rn(s, softcap)), softcap);
  return allowed(qp, kp, causal, window) ? s : kNegInf;
}

// Per-item state in shared memory, after the kernel's tiles.
struct Stats {
  float* m;   // [RH] running max
  float* l;   // [RH] running sum
  float* c;   // [RH] this block's correction
  int* qpos;  // [RH] the row-head's position
  int* kpos;  // [kMaxBK] this block's slot positions (-1: unwritten or past T)
  int* misc;  // [4] the tile's least and greatest position; whether every row has a slot

  __device__ Stats(unsigned char* base, int rh) {
    m = reinterpret_cast<float*>(base);
    l = m + rh;
    c = l + rh;
    qpos = reinterpret_cast<int*>(c + rh);
    kpos = qpos + rh;
    misc = kpos + kMaxBK;
  }
};

__host__ __device__ constexpr size_t stats_bytes(int rh) { return 4 * (4 * size_t(rh) + kMaxBK + 4); }

// The item's rows: their positions, the tile's least and greatest, and
// whether every row of the tile has an allowed slot somewhere in T (rule
// (b)); ends with a barrier.  Rows past S and pad row-heads are left out.
template <int NT>
__device__ void item_rows(const Geometry& e, const Item& it, Stats st, const int* q_pos,
                          const int* k_pos, int causal, int window) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < e.rh; i += NT) {
    const RowHead r = row_head(e, it, i);
    st.qpos[i] = r.valid ? q_pos[size_t(it.b) * e.S + r.row] : 0;
    st.m[i] = kNegInf;
    st.l[i] = 0.f;
  }
  if (tid == 0) {
    st.misc[0] = 0x7fffffff;
    st.misc[1] = -0x7fffffff - 1;
    st.misc[2] = 1;
  }
  __syncthreads();
  const int* kp = k_pos + size_t(it.b) * e.T;
  for (int r = warp; r < e.rows; r += NT / 32) {
    const int row = it.q0 + r;
    if (row >= e.S) continue;  // warp-uniform
    const int qp = q_pos[size_t(it.b) * e.S + row];
    bool any = false;
    for (int j0 = 0; j0 < e.T && !any; j0 += 32) {
      const int j = j0 + lane;
      any = __any_sync(0xffffffffu, j < e.T && allowed(qp, kp[j], causal, window));
    }
    if (lane == 0) {
      atomicMin(st.misc + 0, qp);
      atomicMax(st.misc + 1, qp);
      if (!any) st.misc[2] = 0;
    }
  }
  __syncthreads();
}

// Whether the item computes key block k0 (the masked-block rule), with
// the block's slot positions into st.kpos; a barrier, taken by every
// thread of the block, so the answer is the block's.
template <int NT>
__device__ bool block_live(const Geometry& e, const Item& it, Stats st, const int* k_pos, int k0,
                           int bk, int causal, int window) {
  const int qmin = st.misc[0], qmax = st.misc[1], every = st.misc[2];
  bool may = false;
  for (int j = threadIdx.x; j < bk; j += NT) {
    const int key = k0 + j;
    const int kp = key < e.T ? k_pos[size_t(it.b) * e.T + key] : -1;
    st.kpos[j] = kp;
    may |= kp >= 0 && (!causal || kp <= qmax) && (window < 0 || qmin - kp < window);
  }
  const bool live = __syncthreads_or(may) || !every;
  if (!live && e.skipped != nullptr && threadIdx.x == 0) atomicAdd(e.skipped, 1);
  return live;
}

// The online-softmax step over one key block whose scores are in s
// ([rh][kSST]); `store(row, j, p_int)` writes p_int.  Call between two
// __syncthreads().
template <int NT, typename Store>
__device__ void softmax_step(Stats st, const float* s, int rh, int bk, int qmax, Store store) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rh; r += NT / 32) {
    const float* row = s + r * kSST;
    float mx = kNegInf;
    for (int j = lane; j < bk; j += 32) mx = fmaxf(mx, row[j]);
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_old = st.m[r];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int j = lane; j < bk; j += 32) {
      const float p = expf(row[j] - m_new);
      sum += p;
      store(r, j, int(rintf(__fmul_rn(p, float(qmax)))));
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    __syncwarp();
    if (lane == 0) {
      const float corr = expf(m_old - m_new);
      st.c[r] = corr;
      st.l[r] = __fadd_rn(__fmul_rn(st.l[r], corr), sum);
      st.m[r] = m_new;
    }
  }
}

// o = acc / max(l, 1e-30) for one output; lse = m + log(max(l, 1e-30))
// (B, H, S), the exact flash backward's residual, when the caller passes
// a buffer for it (serving passes none).
__device__ __forceinline__ void write_lse(const Geometry& e, const Item& it, Stats st,
                                          float* lse, int nt) {
  if (lse == nullptr) return;
  for (int i = threadIdx.x; i < e.rh; i += nt) {
    const RowHead r = row_head(e, it, i);
    if (r.valid)
      lse[(size_t(it.b) * e.H + r.h) * e.S + r.row] =
          __fadd_rn(st.m[i], logf(fmaxf(st.l[i], 1e-30f)));
  }
}

// 16 bytes of magnitudes and 16 of signs at `off`, or zeros
__device__ __forceinline__ void load16(const uint8_t* mag, const int8_t* sgn, size_t off,
                                       bool live, uint4& m, uint4& s) {
  if (live) {
    m = __ldg(reinterpret_cast<const uint4*>(mag + off));
    s = __ldg(reinterpret_cast<const uint4*>(sgn + off));
  } else {
    m = s = make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

// ------------------------------------------------------------- bitexact
__host__ __device__ constexpr size_t lut_bytes(int n) { return align16(size_t(2) << (2 * n)); }

__host__ __device__ constexpr int bitexact_rh(int hd, int tm) { return 16 * tm * (32 / imin(32, hd)); }

__host__ __device__ constexpr size_t bitexact_smem(int n, int hd, int rh) {
  return lut_bytes(n) + size_t(4) * hd * rh + size_t(2) * kChunk * hd + size_t(4) * rh * kSST +
         align16(stats_bytes(rh));
}

// a k or v element as one 16-bit value: 2 |x| (its byte offset in a table
// row) + 2048 sign; v & 0x7ff and v >> 11 take them apart
__device__ __forceinline__ int16_t kv_word(uint32_t mag, uint32_t sgn, int e, int qmax) {
  const int m = min(int((mag >> (8 * e)) & 0xffu), qmax);
  const int s = int(int8_t(sgn >> (8 * e)));
  return int16_t(2 * m + 2048 * s);
}

__device__ __forceinline__ int lut_at(const unsigned char* smem, int off) {
  return *reinterpret_cast<const uint16_t*>(smem + off);
}

// QK over one chunk of cw slots: a warp's unit is 4 * (32 / W) row-heads
// by W * TN slots, lanes across the slots; the scores to s[row][c0 + j].
template <int HD, int RH, int W, int TN>
__device__ void bitexact_qk(const unsigned char* smem, const int* qw, const int16_t* kw,
                            float* s, Stats st, int c0, int cw, float qk, float softcap,
                            int causal, int window) {
  constexpr int RG = 32 / W, UNIT = 4 * RG, NW = kBitexactThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int jl = lane % W;
  for (int u = warp; u < RH / UNIT; u += NW) {
    const int r0 = u * UNIT + (lane / W) * 4;
    int acc[4][TN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < TN; ++t) acc[i][t] = 0;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const int4 qv = *reinterpret_cast<const int4*>(qw + d * RH + r0);
      const int q4[4] = {qv.x, qv.y, qv.z, qv.w};
      int boff[TN], sb[TN];
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const int v = kw[d * kChunk + jl + W * t];
        boff[t] = v & 0x7ff;
        sb[t] = v >> 11;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int off = q4[i] & 0xffffff, sa = q4[i] >> 24;
#pragma unroll
        for (int t = 0; t < TN; ++t) acc[i][t] += (sa * sb[t]) * lut_at(smem, off + boff[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      const int j = jl + W * t;
      if (j >= cw) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[(r0 + i) * kSST + c0 + j] = approx_score(float(acc[i][t]), qk, softcap,
                                                   st.qpos[r0 + i], st.kpos[c0 + j], causal,
                                                   window);
    }
  }
}

template <int HD, int TM>
__global__ void __launch_bounds__(kBitexactThreads, 1)
approx_attention_bitexact_kernel(const uint8_t* __restrict__ mq, const int8_t* __restrict__ sq,
                                 const uint8_t* __restrict__ mk, const int8_t* __restrict__ sk,
                                 const uint8_t* __restrict__ mv, const int8_t* __restrict__ sv,
                                 const uint16_t* __restrict__ lut, const int* __restrict__ q_pos,
                                 const int* __restrict__ k_pos, const float* __restrict__ scales,
                                 float* __restrict__ out, float* __restrict__ lse, Geometry e,
                                 int n, int bk, int causal, int window, float softcap,
                                 float scale) {
  constexpr int NT = kBitexactThreads, WC = HD < 32 ? HD : 32, RG = 32 / WC, TN = HD / WC;
  constexpr int RH = 16 * RG * TM;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int side = 1 << n, qmax = side - 1;
  int* qw = reinterpret_cast<int*>(smem + lut_bytes(n));             // [HD][RH]
  int16_t* kv = reinterpret_cast<int16_t*>(qw + HD * RH);            // k [HD][kChunk], v [kChunk][HD]
  float* s = reinterpret_cast<float*>(kv + kChunk * HD);             // [RH][kSST]
  Stats st(reinterpret_cast<unsigned char*>(s + RH * kSST), RH);

  {  // the table, once: 2^(2n) uint16 as 32-bit words (the count is even)
    const uint32_t* src = reinterpret_cast<const uint32_t*>(lut);
    uint32_t* dst = reinterpret_cast<uint32_t*>(smem);
    for (int i = tid; i < side * side / 2; i += NT) dst[i] = __ldg(src + i);
  }
  const float qk = __fmul_rn(scales[0], scale), pv = scales[1];
  // AV: this thread's row-heads r0 .. r0 + TM - 1 and columns cl + WC t
  const int cl = lane % WC, r0 = (warp * RG + lane / WC) * TM;

  for (int round = 0;; ++round) {
    const long long idx = item_index(round, gridDim.x);
    if (idx >= e.items) break;
    const Item it = item_at(e, int(idx));
    __syncthreads();  // the previous item's outputs are written
    // q as words [d][row-head]: its table row's byte offset, the sign on top
    for (int i = tid; i < RH * HD; i += NT) {
      const int r = i % RH, d = i / RH;
      const RowHead rw = row_head(e, it, r);
      int w = 0;
      if (rw.valid) {
        const size_t off = ((size_t(it.b) * e.S + rw.row) * e.H + rw.h) * HD + d;
        const int sg = sq[off];
        w = (((2 * min(int(mq[off]), qmax)) << n) & 0xffffff) | int(uint32_t(sg) << 24);
      }
      qw[d * RH + r] = w;
    }
    item_rows<NT>(e, it, st, q_pos, k_pos, causal, window);
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int t = 0; t < TN; ++t) acc[i][t] = 0.f;

    for (int k0 = 0; k0 < e.T; k0 += bk) {
      if (!block_live<NT>(e, it, st, k_pos, k0, bk, causal, window)) continue;
      for (int c0 = 0; c0 < bk; c0 += kChunk) {
        const int cw = imin(kChunk, bk - c0);
        __syncthreads();  // the previous chunk's k words are consumed
        // k words [d][slot], 16 d of one slot per thread; zeros past cw and T
        for (int i = tid; i < kChunk * HD / 16; i += NT) {
          const int j = i % kChunk, d0 = (i / kChunk) * 16, key = k0 + c0 + j;
          uint4 m4, s4;
          load16(mk, sk, ((size_t(it.b) * e.T + key) * e.KV + it.kvh) * HD + d0,
                 j < cw && key < e.T, m4, s4);
#pragma unroll
          for (int x = 0; x < 16; ++x)
            kv[(d0 + x) * kChunk + j] = kv_word(word_of(m4, x >> 2), word_of(s4, x >> 2), x & 3, qmax);
        }
        __syncthreads();
        if (cw > 32)
          bitexact_qk<HD, RH, 32, 2>(smem, qw, kv, s, st, c0, cw, qk, softcap, causal, window);
        else if (cw > 16)
          bitexact_qk<HD, RH, 32, 1>(smem, qw, kv, s, st, c0, cw, qk, softcap, causal, window);
        else
          bitexact_qk<HD, RH, 16, 1>(smem, qw, kv, s, st, c0, cw, qk, softcap, causal, window);
      }
      __syncthreads();
      // p_int's table-row byte offset over its score
      int* pw = reinterpret_cast<int*>(s);
      softmax_step<NT>(st, s, RH, bk, qmax,
                       [&](int r, int j, int p) { pw[r * kSST + j] = (2 * p) << n; });
      int av[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int t = 0; t < TN; ++t) av[i][t] = 0;
      for (int c0 = 0; c0 < bk; c0 += kChunk) {
        const int cw = imin(kChunk, bk - c0);
        __syncthreads();  // the softmax is done; the previous chunk's v words are consumed
        // v words [slot][column], 16 columns of one slot per thread
        for (int i = tid; i < kChunk * HD / 16; i += NT) {
          const int j = i / (HD / 16), c16 = (i % (HD / 16)) * 16, key = k0 + c0 + j;
          uint4 m4, s4;
          load16(mv, sv, ((size_t(it.b) * e.T + key) * e.KV + it.kvh) * HD + c16,
                 j < cw && key < e.T, m4, s4);
          uint32_t w[8];  // two columns' values a word
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const uint32_t mw = word_of(m4, x >> 1), sw = word_of(s4, x >> 1);
            w[x] = uint16_t(kv_word(mw, sw, 2 * (x & 1), qmax)) |
                   uint32_t(uint16_t(kv_word(mw, sw, 2 * (x & 1) + 1, qmax))) << 16;
          }
          uint4* dst = reinterpret_cast<uint4*>(kv + j * HD + c16);
          dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
          dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
        }
        __syncthreads();
#pragma unroll 2
        for (int j = 0; j < cw; ++j) {
          int voff[TN], sgn[TN];
#pragma unroll
          for (int t = 0; t < TN; ++t) {
            const int v = kv[j * HD + cl + WC * t];
            voff[t] = v & 0x7ff;
            sgn[t] = v >> 11;
          }
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const int po = pw[(r0 + i) * kSST + c0 + j];
#pragma unroll
            for (int t = 0; t < TN; ++t) av[i][t] += sgn[t] * lut_at(smem, po + voff[t]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float corr = st.c[r0 + i];
#pragma unroll
        for (int t = 0; t < TN; ++t)
          acc[i][t] = __fadd_rn(__fmul_rn(acc[i][t], corr), __fmul_rn(float(av[i][t]), pv));
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const RowHead rw = row_head(e, it, r0 + i);
      if (!rw.valid) continue;
      const float l = fmaxf(st.l[r0 + i], 1e-30f);
      float* o = out + ((size_t(it.b) * e.S + rw.row) * e.H + rw.h) * HD;
#pragma unroll
      for (int t = 0; t < TN; ++t) o[cl + WC * t] = __fdiv_rn(acc[i][t], l);
    }
    write_lse(e, it, st, lse, NT);
  }
}

// -------------------------------------------------------------- lowrank
template <int HD>
struct LowrankLayout {
  static constexpr int HDP = HD < 32 ? 32 : HD;  // d padded to whole k32 steps
  static constexpr int QROW = HDP + 32;          // bytes per q plane row [row-head][d]
  static constexpr int KROW = HDP + 8;           // bytes per k plane row [slot][d]
  static constexpr int KENT = kMaxBK + 4;        // entries per k entry row [d][slot]
  static constexpr int VROW = kMaxBK + 8;        // bytes per v^T plane row [column][slot]
  static constexpr int VENT = HDP + 4;           // entries per v entry row [slot][column]
  static constexpr int PROW = kMaxBK + 32;       // bytes per p_int row [row-head][slot]
  static constexpr size_t kq = align16(size_t(2) * kLowrankRH * QROW + size_t(2) * HD * kLowrankRH);
  static constexpr size_t kk = size_t(2) * kMaxBK * KROW + size_t(2) * HD * KENT;
  static constexpr size_t kv = size_t(2) * HDP * VROW + size_t(2) * kMaxBK * VENT;
  static constexpr size_t kkv = align16(kk > kv ? kk : kv);
  static constexpr size_t kRest = kq + kkv + size_t(4) * kLowrankRH * kSST +
                                  size_t(kLowrankRH) * PROW + align16(stats_bytes(kLowrankRH));
};

__host__ __device__ constexpr size_t lowrank_tables(int n, int rank) {
  return size_t(16) * ((1 << n) + 1) * ((rank + 7) & ~7);
}

template <int HD>
constexpr size_t lowrank_smem(int n, int rank) {
  return lowrank_tables(n, rank) + LowrankLayout<HD>::kRest;
}

// row-head r's place in an entry row: rows g and g + 8 of an m16 tile side by side
__device__ __forceinline__ int entry_pos(int r) { return (r & ~15) + (r & 7) * 2 + ((r >> 3) & 1); }

// One k32 step of an exact part for four n8 tiles: A and B as their s*h
// and s*l int8 planes, a*b = 16384 hh + 128 (hl + lh) + ll.
__device__ __forceinline__ void exact_step(int (&iacc)[4][4], const uint32_t (&xa)[2][4],
                                           const uint32_t (&wb)[2][4][2]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int hh[4] = {0, 0, 0, 0}, mid[4] = {0, 0, 0, 0}, ll[4] = {0, 0, 0, 0};
    mma_s8(hh, xa[0], wb[0][j]);
    mma_s8(mid, xa[0], wb[1][j]);
    mma_s8(mid, xa[1], wb[0][j]);
    mma_s8(ll, xa[1], wb[1][j]);
#pragma unroll
    for (int c = 0; c < 4; ++c) iacc[j][c] += 16384 * hh[c] + 128 * mid[c] + ll[c];
  }
}

// One k8 step of a correction for four n8 tiles: A rows g and g + 8 as
// (hi, lo) gathers x0, x1, B as wv; lo*hi, hi*lo, then hi*hi.
__device__ __forceinline__ void correction_step(float (&part)[4][4], const uint4& x0,
                                                const uint4& x1, const uint4 (&wv)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_tf32(part[j], x0.z, x1.z, x0.w, x1.w, wv[j].x, wv[j].y);
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_tf32(part[j], x0.x, x1.x, x0.y, x1.y, wv[j].z, wv[j].w);
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_tf32(part[j], x0.x, x1.x, x0.y, x1.y, wv[j].x, wv[j].y);
}

// the fresh accumulator into the float32 sum (round to nearest), zeroed
__device__ __forceinline__ void flush(float (&sum)[4][4], float (&part)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      sum[j][c] = __fadd_rn(sum[j][c], part[j][c]);
      part[j][c] = 0.f;
    }
}

// zeroed accumulators of an exact part and a correction
__device__ __forceinline__ void zero(int (&iacc)[4][4], float (&sum)[4][4], float (&part)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) iacc[j][c] = 0, sum[j][c] = part[j][c] = 0.f;
}

template <int HD>
__global__ void __launch_bounds__(kLowrankThreads, 1)
approx_attention_lowrank_kernel(const uint8_t* __restrict__ mq, const int8_t* __restrict__ sq,
                                const uint8_t* __restrict__ mk, const int8_t* __restrict__ sk,
                                const uint8_t* __restrict__ mv, const int8_t* __restrict__ sv,
                                const float* __restrict__ tables, const int* __restrict__ q_pos,
                                const int* __restrict__ k_pos, const float* __restrict__ scales,
                                float* __restrict__ out, float* __restrict__ lse, Geometry e,
                                int n, int bk, int causal, int window, float softcap,
                                float scale, int rank) {
  using L = LowrankLayout<HD>;
  constexpr int NT = kLowrankThreads, RH = kLowrankRH, HDP = L::HDP;
  // AV's column groups of 32 per warp: grp, grp + 4, ... (two at HD 256)
  constexpr int kColGroups = (HDP + 4 * 32 - 1) / (4 * 32);
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int side = 1 << n, qmax = side - 1, r8 = (rank + 7) & ~7, row_f = 2 * r8;
  const uint32_t qmax4 = 0x01010101u * uint32_t(qmax);
  float* utab = reinterpret_cast<float*>(smem);  // [side + 1][row_f], row `side` zero
  float* vtab = utab + (side + 1) * row_f;
  unsigned char* base = smem + lowrank_tables(n, rank);
  uint8_t* qpl = base;                                                   // [2][RH][QROW]
  uint16_t* qent = reinterpret_cast<uint16_t*>(qpl + 2 * RH * L::QROW);  // [HD][RH]
  unsigned char* kvb = base + L::kq;
  uint8_t* kpl = kvb;                                                    // [2][kMaxBK][KROW]
  uint16_t* kent = reinterpret_cast<uint16_t*>(kpl + 2 * kMaxBK * L::KROW);  // [HD][KENT]
  uint8_t* vpl = kvb;                                                    // [2][HDP][VROW]
  uint16_t* vent = reinterpret_cast<uint16_t*>(vpl + 2 * HDP * L::VROW);  // [kMaxBK][VENT]
  float* s = reinterpret_cast<float*>(kvb + L::kkv);                     // [RH][kSST]
  uint8_t* pb = reinterpret_cast<uint8_t*>(s + RH * kSST);               // [RH][PROW]
  Stats st(pb + RH * L::PROW, RH);

  fill_tables<NT>(utab, vtab, tables, tables + side * rank, side, rank, r8, tid);
  const float qk = __fmul_rn(scales[0], scale), pv = scales[1];
  const int mt = warp & 1, grp = warp >> 1;  // this warp's m16 tile and group of four n8 tiles
  const int m0 = 16 * mt;

  for (int round = 0;; ++round) {
    const long long idx = item_index(round, gridDim.x);
    if (idx >= e.items) break;
    const Item it = item_at(e, int(idx));
    __syncthreads();  // the previous item's outputs are written
    // q: planes [row-head][d] and table entries [d][row-head], 16 d per thread
    for (int i = tid; i < RH * (HDP / 16); i += NT) {
      const int r = i % RH, d0 = (i / RH) * 16;
      const RowHead rw = row_head(e, it, r);
      uint4 m4, s4;
      load16(mq, sq, ((size_t(it.b) * e.S + rw.row) * e.H + rw.h) * HD + d0,
             rw.valid && d0 < HD, m4, s4);
      uint32_t h[4], l[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) split_planes(word_of(m4, w), word_of(s4, w), qmax4, h[w], l[w]);
      *reinterpret_cast<uint4*>(qpl + r * L::QROW + d0) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(qpl + (RH + r) * L::QROW + d0) = make_uint4(l[0], l[1], l[2], l[3]);
      if (d0 < HD) {
#pragma unroll
        for (int x = 0; x < 16; ++x)
          qent[(d0 + x) * RH + entry_pos(r)] =
              uint16_t(table_entry(word_of(m4, x >> 2), word_of(s4, x >> 2), x & 3, qmax));
      }
    }
    item_rows<NT>(e, it, st, q_pos, k_pos, causal, window);
    // AV: m16 tile mt by the four n8 tiles of each of this warp's column groups
    float acc[kColGroups][4][4];
#pragma unroll
    for (int cg = 0; cg < kColGroups; ++cg)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[cg][j][c] = 0.f;

    for (int k0 = 0; k0 < e.T; k0 += bk) {
      if (!block_live<NT>(e, it, st, k_pos, k0, bk, causal, window)) continue;
      const int ks = (bk + 31) & ~31;  // slots staged: whole k32 steps
      // k: planes [slot][d] and entries [d][slot], 4 slots by 4 d per
      // thread (8 threads across d, 4 across slot quads in a warp)
      {
        constexpr int DQ = HDP / 4, PER = 32 * (DQ / 8);
        for (int i = tid; i < (ks / 4) * DQ; i += NT) {
          const int jq = 4 * (i / PER) + (i % 32) / 8, dq = 8 * ((i % PER) / 32) + i % 8;
          const int d0 = 4 * dq;
          uint32_t mw[4], sw[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int j = 4 * jq + x, key = k0 + j;
            const bool live = j < bk && key < e.T && d0 < HD;
            const size_t off = ((size_t(it.b) * e.T + key) * e.KV + it.kvh) * HD + d0;
            mw[x] = live ? __ldg(reinterpret_cast<const uint32_t*>(mk + off)) : 0u;
            sw[x] = live ? __ldg(reinterpret_cast<const uint32_t*>(sk + off)) : 0u;
            uint32_t h, l;
            split_planes(mw[x], sw[x], qmax4, h, l);
            *reinterpret_cast<uint32_t*>(kpl + j * L::KROW + d0) = h;
            *reinterpret_cast<uint32_t*>(kpl + (kMaxBK + j) * L::KROW + d0) = l;
          }
          if (d0 < HD) {
#pragma unroll
            for (int y = 0; y < 4; ++y) {
              uint32_t en[4];
#pragma unroll
              for (int x = 0; x < 4; ++x) en[x] = table_entry(mw[x], sw[x], y, qmax);
              *reinterpret_cast<uint2*>(kent + (d0 + y) * L::KENT + 4 * jq) =
                  make_uint2(en[0] | en[1] << 16, en[2] | en[3] << 16);
            }
          }
        }
      }
      __syncthreads();
      // QK: warp (mt, grp) takes slots 32 grp .. 32 grp + 31, slot 32 grp + 4 g + j
      // being MMA column g of n-tile j
      if (32 * grp < ks) {
        int iacc[4][4];
        float sum[4][4], part[4][4];
        zero(iacc, sum, part);
        const int n0 = 32 * grp;
#pragma unroll
        for (int k32 = 0; k32 < HDP; k32 += 32) {
          uint32_t xa[2][4], wb[2][4][2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int off = (m0 + 8 * h + g) * L::QROW + k32 + 8 * t;
            const uint2 hv = *reinterpret_cast<const uint2*>(qpl + off);
            const uint2 lv = *reinterpret_cast<const uint2*>(qpl + RH * L::QROW + off);
            xa[0][h] = hv.x, xa[0][2 + h] = hv.y, xa[1][h] = lv.x, xa[1][2 + h] = lv.y;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int off = (n0 + 4 * g + j) * L::KROW + k32 + 8 * t;
            const uint2 hv = *reinterpret_cast<const uint2*>(kpl + off);
            const uint2 lv = *reinterpret_cast<const uint2*>(kpl + kMaxBK * L::KROW + off);
            wb[0][j][0] = hv.x, wb[0][j][1] = hv.y, wb[1][j][0] = lv.x, wb[1][j][1] = lv.y;
          }
          exact_step(iacc, xa, wb);
        }
#pragma unroll 2
        for (int d = 0; d < HD; ++d) {
          const uint32_t qe = *reinterpret_cast<const uint32_t*>(qent + d * RH + m0 + 2 * g);
          const uint2 ke = *reinterpret_cast<const uint2*>(kent + d * L::KENT + n0 + 4 * g);
          const uint32_t kes[4] = {ke.x & 0xffffu, ke.x >> 16, ke.y & 0xffffu, ke.y >> 16};
          for (int q = 0; q < r8 / 8; ++q) {
            const int off = q * 16 + 4 * t;
            const uint4 x0 = gather(utab, row_f, qe & 0xffffu, off);
            const uint4 x1 = gather(utab, row_f, qe >> 16, off);
            uint4 wv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) wv[j] = gather(vtab, row_f, kes[j], off);
            correction_step(part, x0, x1, wv);
          }
          if ((d + 1) % kFlush == 0 || d + 1 == HD) flush(sum, part);
        }
        // C fragment c of n-tile j: row-head m0 + g + 8 (c >> 1), slot n0 + 4 (2t + (c & 1)) + j
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int r = m0 + g + 8 * (c >> 1), slot = n0 + 4 * (2 * t + (c & 1)) + j;
            if (slot < bk)
              s[r * kSST + slot] =
                  approx_score(__fadd_rn(__int2float_rn(iacc[j][c]), sum[j][c]), qk, softcap,
                               st.qpos[r], st.kpos[slot], causal, window);
          }
      }
      __syncthreads();
      // the softmax: p_int as bytes [row-head][slot], zeros past bk
      softmax_step<NT>(st, s, RH, bk, qmax,
                       [&](int r, int j, int p) { pb[r * L::PROW + j] = uint8_t(p); });
      for (int i = tid; i < RH * (ks - bk); i += NT)
        pb[(i / (ks - bk)) * L::PROW + bk + i % (ks - bk)] = 0;
      // v (over k, which QK has consumed): planes [column][slot] and
      // entries [slot][column], 4 slots by 4 columns per thread
      {
        constexpr int CQ = HDP / 4, PER = 32 * (CQ / 8);
        for (int i = tid; i < (ks / 4) * CQ; i += NT) {
          const int jq = 4 * (i / PER) + (i % 32) / 8, cq = 8 * ((i % PER) / 32) + i % 8;
          const int c0 = 4 * cq;
          uint32_t mw[4], sw[4], h[4], l[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int j = 4 * jq + x, key = k0 + j;
            const bool live = j < bk && key < e.T && c0 < HD;
            const size_t off = ((size_t(it.b) * e.T + key) * e.KV + it.kvh) * HD + c0;
            mw[x] = live ? __ldg(reinterpret_cast<const uint32_t*>(mv + off)) : 0u;
            sw[x] = live ? __ldg(reinterpret_cast<const uint32_t*>(sv + off)) : 0u;
            split_planes(mw[x], sw[x], qmax4, h[x], l[x]);
            *reinterpret_cast<uint2*>(vent + j * L::VENT + c0) =
                make_uint2(table_entry(mw[x], sw[x], 0, qmax) | table_entry(mw[x], sw[x], 1, qmax) << 16,
                           table_entry(mw[x], sw[x], 2, qmax) | table_entry(mw[x], sw[x], 3, qmax) << 16);
          }
          transpose4(h);
          transpose4(l);
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            *reinterpret_cast<uint32_t*>(vpl + (c0 + y) * L::VROW + 4 * jq) = h[y];
            *reinterpret_cast<uint32_t*>(vpl + (HDP + c0 + y) * L::VROW + 4 * jq) = l[y];
          }
        }
      }
      __syncthreads();
      // AV: warp (mt, grp) takes columns 32 cgi .. 32 cgi + 31 of each of
      // its column groups cgi = grp + 4 cg, column 32 cgi + 4 g + j being
      // MMA column g of n-tile j
#pragma unroll
      for (int cg = 0; cg < kColGroups; ++cg) {
        const int n0 = 32 * (grp + 4 * cg);
        if (n0 >= HDP) continue;  // warp-uniform
        int iacc[4][4];
        float sum[4][4], part[4][4];
        zero(iacc, sum, part);
        for (int k32 = 0; k32 < ks; k32 += 32) {
          uint32_t xa[2][4], wb[2][4][2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint2 pv2 = *reinterpret_cast<const uint2*>(pb + (m0 + 8 * h + g) * L::PROW +
                                                              k32 + 8 * t);
            xa[0][h] = (pv2.x >> 7) & 0x01010101u, xa[0][2 + h] = (pv2.y >> 7) & 0x01010101u;
            xa[1][h] = pv2.x & 0x7f7f7f7fu, xa[1][2 + h] = pv2.y & 0x7f7f7f7fu;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int off = (n0 + 4 * g + j) * L::VROW + k32 + 8 * t;
            const uint2 hv = *reinterpret_cast<const uint2*>(vpl + off);
            const uint2 lv = *reinterpret_cast<const uint2*>(vpl + HDP * L::VROW + off);
            wb[0][j][0] = hv.x, wb[0][j][1] = hv.y, wb[1][j][0] = lv.x, wb[1][j][1] = lv.y;
          }
          exact_step(iacc, xa, wb);
        }
#pragma unroll 2
        for (int j0 = 0; j0 < bk; ++j0) {
          const uint32_t p0 = pb[(m0 + g) * L::PROW + j0], p1 = pb[(m0 + g + 8) * L::PROW + j0];
          const uint2 ve = *reinterpret_cast<const uint2*>(vent + j0 * L::VENT + n0 + 4 * g);
          const uint32_t ves[4] = {ve.x & 0xffffu, ve.x >> 16, ve.y & 0xffffu, ve.y >> 16};
          for (int q = 0; q < r8 / 8; ++q) {
            const int off = q * 16 + 4 * t;
            const uint4 x0 = *reinterpret_cast<const uint4*>(utab + p0 * row_f + off);
            const uint4 x1 = *reinterpret_cast<const uint4*>(utab + p1 * row_f + off);
            uint4 wv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) wv[j] = gather(vtab, row_f, ves[j], off);
            correction_step(part, x0, x1, wv);
          }
          if ((j0 + 1) % kFlush == 0 || j0 + 1 == bk) flush(sum, part);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float corr = st.c[m0 + g + 8 * (c >> 1)];
            const float av = __fadd_rn(__int2float_rn(iacc[j][c]), sum[j][c]);
            acc[cg][j][c] = __fadd_rn(__fmul_rn(acc[cg][j][c], corr), __fmul_rn(av, pv));
          }
      }
    }
    __syncthreads();
#pragma unroll
    for (int cg = 0; cg < kColGroups; ++cg) {
      const int n0 = 32 * (grp + 4 * cg);
      if (n0 >= HDP) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = m0 + g + 8 * (c >> 1), col = n0 + 4 * (2 * t + (c & 1)) + j;
          const RowHead rw = row_head(e, it, r);
          if (rw.valid && col < HD)
            out[((size_t(it.b) * e.S + rw.row) * e.H + rw.h) * HD + col] =
                __fdiv_rn(acc[cg][j][c], fmaxf(st.l[r], 1e-30f));
        }
    }
    write_lse(e, it, st, lse, NT);
  }
}

// -------------------------------------------------------------- launch
struct Plan {
  int grid, threads, tm;
  size_t smem;
  Geometry e;
};

size_t lowrank_smem_of(int hd, int n, int rank) {
  switch (hd) {
    case 16: return lowrank_smem<16>(n, rank);
    case 32: return lowrank_smem<32>(n, rank);
    case 64: return lowrank_smem<64>(n, rank);
    case 128: return lowrank_smem<128>(n, rank);
    case 256: return lowrank_smem<256>(n, rank);
    default: return 0;
  }
}

// mode 0 bitexact, 1 lowrank
bool make_plan(int mode, int B, int S, int T, int H, int KV, int hd, int n, int rank, int sms,
               Plan* p) {
  if (B < 1 || S < 1 || T < 1 || KV < 1 || H < KV || H % KV != 0 || n < 1 || n > 8 || sms < 1 ||
      (hd != 16 && hd != 32 && hd != 64 && hd != 128 && hd != 256) ||
      (mode == 1 && (rank < 1 || rank > 64)))
    return false;
  if (mode == 0) {
    // TM = 4, 2, 1: the largest whose block fits the shared memory and that
    // gives every SM an item, else the smallest that fits
    p->threads = kBitexactThreads;
    p->tm = 0;
    for (int tm = 4; tm >= 1; tm /= 2) {
      if (bitexact_smem(n, hd, bitexact_rh(hd, tm)) > size_t(kMaxSmem)) continue;
      p->tm = tm;
      p->e = geometry(B, S, T, H, KV, bitexact_rh(hd, tm));
      if (p->e.items >= sms) break;
    }
    if (p->tm == 0) return false;
    p->smem = bitexact_smem(n, hd, p->e.rh);
  } else {
    p->threads = kLowrankThreads;
    p->tm = 0;
    p->e = geometry(B, S, T, H, KV, kLowrankRH);
    p->smem = lowrank_smem_of(hd, n, rank);
  }
  if (p->e.items > 0x7fffffffLL || p->smem > size_t(kMaxSmem)) return false;
  p->grid = int(p->e.items < sms ? p->e.items : sms);
  return true;
}

template <typename Kernel>
cudaError_t prepare_launch(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

template <int HD, int TM>
cudaError_t launch_bitexact(const Plan& p, const void* const* ops, const void* lut,
                            const void* qp, const void* kp, const void* scales, void* out,
                            void* lse, int n, int bk, int causal, int window, float softcap,
                            float scale, cudaStream_t stream) {
  auto kernel = approx_attention_bitexact_kernel<HD, TM>;
  cudaError_t err = prepare_launch(kernel, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, p.threads, p.smem, stream>>>(
      static_cast<const uint8_t*>(ops[0]), static_cast<const int8_t*>(ops[1]),
      static_cast<const uint8_t*>(ops[2]), static_cast<const int8_t*>(ops[3]),
      static_cast<const uint8_t*>(ops[4]), static_cast<const int8_t*>(ops[5]),
      static_cast<const uint16_t*>(lut), static_cast<const int*>(qp),
      static_cast<const int*>(kp), static_cast<const float*>(scales), static_cast<float*>(out),
      static_cast<float*>(lse), p.e, n, bk, causal, window, softcap, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bitexact_tm(const Plan& p, const void* const* ops, const void* lut,
                               const void* qp, const void* kp, const void* scales, void* out,
                               void* lse, int n, int bk, int causal, int window, float softcap,
                               float scale, cudaStream_t s) {
  if (p.tm == 4)
    return launch_bitexact<HD, 4>(p, ops, lut, qp, kp, scales, out, lse, n, bk, causal, window, softcap, scale, s);
  if (p.tm == 2)
    return launch_bitexact<HD, 2>(p, ops, lut, qp, kp, scales, out, lse, n, bk, causal, window, softcap, scale, s);
  return launch_bitexact<HD, 1>(p, ops, lut, qp, kp, scales, out, lse, n, bk, causal, window, softcap, scale, s);
}

template <int HD>
cudaError_t launch_lowrank(const Plan& p, const void* const* ops, const void* tables,
                           const void* qp, const void* kp, const void* scales, void* out,
                           void* lse, int n, int bk, int causal, int window, float softcap,
                           float scale, int rank, cudaStream_t stream) {
  auto kernel = approx_attention_lowrank_kernel<HD>;
  cudaError_t err = prepare_launch(kernel, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, p.threads, p.smem, stream>>>(
      static_cast<const uint8_t*>(ops[0]), static_cast<const int8_t*>(ops[1]),
      static_cast<const uint8_t*>(ops[2]), static_cast<const int8_t*>(ops[3]),
      static_cast<const uint8_t*>(ops[4]), static_cast<const int8_t*>(ops[5]),
      static_cast<const float*>(tables), static_cast<const int*>(qp),
      static_cast<const int*>(kp), static_cast<const float*>(scales), static_cast<float*>(out),
      static_cast<float*>(lse), p.e, n, bk, causal, window, softcap, scale, rank);
  return cudaGetLastError();
}

}  // namespace

#define DISPATCH_HD(FN, ...)                    \
  switch (hd) {                                 \
    case 16: return int(FN<16>(__VA_ARGS__));   \
    case 32: return int(FN<32>(__VA_ARGS__));   \
    case 64: return int(FN<64>(__VA_ARGS__));   \
    case 128: return int(FN<128>(__VA_ARGS__)); \
    case 256: return int(FN<256>(__VA_ARGS__)); \
    default: return int(cudaErrorInvalidValue); \
  }

// The six operands are magnitudes (uint8) and signs (int8) of q (B, S, H,
// hd), k and v (B, T, KV, hd), 16-byte aligned; positions int32 (B, S),
// (B, T); scales [qk_scale, pv_scale]; out f32 (B, S, H, hd); lse f32 (B,
// H, S) or null; skipped: null, or an int32 to which the kernel adds one
// per (item, key block) pair it skips; window -1 for none; sms: the
// grid's cap.  bitexact's
// table is the uint16 product table (2^n, 2^n); lowrank's is U then V,
// float32 (2, 2^n, rank).
extern "C" int approx_attention_bitexact_launch(
    const void* mq, const void* sq, const void* mk, const void* sk, const void* mv,
    const void* sv, const void* lut, const void* q_pos, const void* k_pos, const void* scales,
    void* out, void* lse, void* skipped, int B, int S, int T, int H, int KV, int hd, int n, int bk,
    int causal, int window, float softcap, float scale, int sms, int device, void* stream) {
  Plan p;
  if (bk < 1 || bk > kMaxBK || !make_plan(0, B, S, T, H, KV, hd, n, 0, sms, &p))
    return int(cudaErrorInvalidValue);
  p.e.skipped = static_cast<int*>(skipped);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const void* ops[6] = {mq, sq, mk, sk, mv, sv};
  const auto s = static_cast<cudaStream_t>(stream);
  DISPATCH_HD(launch_bitexact_tm, p, ops, lut, q_pos, k_pos, scales, out, lse, n, bk, causal,
              window, softcap, scale, s)
}

extern "C" int approx_attention_lowrank_launch(
    const void* mq, const void* sq, const void* mk, const void* sk, const void* mv,
    const void* sv, const void* tables, const void* q_pos, const void* k_pos,
    const void* scales, void* out, void* lse, void* skipped, int B, int S, int T, int H, int KV,
    int hd, int n, int bk, int causal, int window, float softcap, float scale, int rank, int sms,
    int device, void* stream) {
  Plan p;
  if (bk < 1 || bk > kMaxBK || !make_plan(1, B, S, T, H, KV, hd, n, rank, sms, &p))
    return int(cudaErrorInvalidValue);
  p.e.skipped = static_cast<int*>(skipped);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const void* ops[6] = {mq, sq, mk, sk, mv, sv};
  const auto s = static_cast<cudaStream_t>(stream);
  DISPATCH_HD(launch_lowrank, p, ops, tables, q_pos, k_pos, scales, out, lse, n, bk, causal,
              window, softcap, scale, rank, s)
}

// The launch the entry point of `mode` (0 bitexact, 1 lowrank) makes for
// these arguments: out = {grid x, y, z, threads, shared-memory bytes,
// query rows per item, query heads per item}.
extern "C" int approx_attention_plan(int mode, int B, int S, int T, int H, int KV, int hd, int n,
                                     int rank, int sms, long long* out) {
  Plan p;
  if ((mode != 0 && mode != 1) || !make_plan(mode, B, S, T, H, KV, hd, n, rank, sms, &p))
    return int(cudaErrorInvalidValue);
  const long long plan[kPlan] = {p.grid, 1, 1, p.threads, (long long)p.smem, p.e.rows, p.e.heads};
  for (int i = 0; i < kPlan; ++i) out[i] = plan[i];
  return 0;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
