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
// exact backward of csrc/flash_attention_bwd.cu runs.  bitexact: s_int = sum_d
// LUT[|q|, |k|] sq sk and av_int = sum_j LUT[p_int, |v|] sv, both integers
// (products < 2^16, at most 128 terms: exact in int32 and in the
// reference's float32).  lowrank: s_int = qi . ki + ueq . vek and av_int =
// p_int . vi + U[p_int] . vev, float32 sums over the operands that the
// host prepares as the reference's `_prepare` does.
//
// The key block bk is the caller's: p_int is taken against the running
// max of the blocks seen so far, so another bk gives other integers.  The
// blocks are walked in order and the last one is padded past T with
// masked, zero slots, as the reference pads it.  NEG_INF is the
// reference's finite -2.3819763e38, never -inf: a fully masked block gets
// p = exp(0) = 1 and is erased by the next allowed block through corr =
// exp(NEG_INF - m) = 0; a row with no allowed slot (a left pad) ends as a
// finite uniform average instead of NaN, which would otherwise reach the
// per-tensor calibration of the next approximate GEMM.  The elementwise
// float steps use __fmul_rn / __fadd_rn / __fdiv_rn, so nvcc fuses none of
// them into an FMA the reference does not compute; rintf rounds half to
// even, as jnp.round and torch.round do.
//
// Design.  One block per (16 query rows, head, batch), 128 threads.
// bitexact keeps the whole product table in shared memory as uint16 (128
// KiB at n = 8; the reference's float32 table, 256 KiB, is over the 227
// KiB a block may use), the q tile's magnitudes and signs as bytes, and
// one key block's (staged for QK, then restaged with v for AV).  lowrank
// keeps U (2^n, r) in shared memory for the in-kernel U[p_int] gather, the
// q tile's qi and ueq rows, and stages k/v operands 16 slots at a time
// (vev in the reference's (r, hd) C-flattened layout).  Scores go to
// shared memory; each warp takes the softmax of whole rows; each thread
// owns fixed (row, column) outputs of the AV contraction.  Byte and float
// rows are padded so the slots a warp reads sit in distinct banks.
//
// Bound on the H100.  bitexact is 2*B*H*S*T*hd table lookups from shared
// memory, random in the table, so the lookup rate bounds it; lowrank is
// 2*B*H*S*T*hd*(r+1) float32 FLOPs on the CUDA cores plus B*H*S*T*r
// lookups.  Neither uses tensor cores, and this first kernel computes
// every key block, causally masked or not.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -2.3819763e38f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 16;      // query rows per block
constexpr int kMaxBK = 128;  // largest key block
constexpr int kKC = 16;      // lowrank: key slots staged per chunk

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

// Row statistics and quantized probabilities in shared memory.
struct Stats {
  float* s;  // [kBQ][kMaxBK] scores
  int* p;    // [kBQ][kMaxBK] p_int
  float* m;  // [kBQ] running max
  float* l;  // [kBQ] running sum
  float* c;  // [kBQ] this block's correction

  __device__ Stats(unsigned char* base) {
    s = reinterpret_cast<float*>(base);
    p = reinterpret_cast<int*>(s + kBQ * kMaxBK);
    m = reinterpret_cast<float*>(p + kBQ * kMaxBK);
    l = m + kBQ;
    c = l + kBQ;
  }
};

constexpr size_t stats_bytes() { return 4 * (2 * kBQ * kMaxBK + 3 * kBQ + kMaxBK); }

__device__ void init_stats(Stats st) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    st.m[r] = kNegInf;
    st.l[r] = 0.f;
  }
}

// The online-softmax step over one key block whose scores are in st.s;
// call between two __syncthreads().
__device__ void softmax_step(Stats st, int bk, float qmax) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kBQ; r += kWarps) {
    float mx = kNegInf;
    for (int j = lane; j < bk; j += 32) mx = fmaxf(mx, st.s[r * kMaxBK + j]);
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_old = st.m[r];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int j = lane; j < bk; j += 32) {
      const float p = expf(st.s[r * kMaxBK + j] - m_new);
      sum += p;
      st.p[r * kMaxBK + j] = int(rintf(__fmul_rn(p, qmax)));
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      const float corr = expf(m_old - m_new);
      st.c[r] = corr;
      st.l[r] = __fadd_rn(__fmul_rn(st.l[r], corr), sum);
      st.m[r] = m_new;
    }
  }
}

__device__ __forceinline__ int row_pos(const int* q_pos, int b, int S, int qr) {
  return qr < S ? q_pos[size_t(b) * S + qr] : 0;
}

__device__ __forceinline__ int slot_pos(const int* k_pos, int b, int T, int key) {
  return key < T ? k_pos[size_t(b) * T + key] : -1;
}

// lse = m + log(max(l, 1e-30)) (B, H, S), the exact flash backward's
// residual, when the caller passes a buffer for it; serving passes none.
__device__ void write_lse(Stats st, float* lse, int b, int h, int H, int S, int q0) {
  if (lse == nullptr) return;
  for (int r = threadIdx.x; r < kBQ; r += kThreads)
    if (q0 + r < S)
      lse[(size_t(b) * H + h) * S + q0 + r] = __fadd_rn(st.m[r], logf(fmaxf(st.l[r], 1e-30f)));
}

// ------------------------------------------------------------- bitexact
template <int HD>
constexpr size_t bitexact_tiles_bytes() {
  return 2 * size_t(kBQ) * (HD + 4) + 2 * size_t(kMaxBK) * (HD + 4);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
approx_attention_bitexact_kernel(const uint8_t* __restrict__ mq, const int8_t* __restrict__ sq,
                                 const uint8_t* __restrict__ mk, const int8_t* __restrict__ sk,
                                 const uint8_t* __restrict__ mv, const int8_t* __restrict__ sv,
                                 const uint16_t* __restrict__ lut,
                                 const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                                 const float* __restrict__ scales, float* __restrict__ out,
                                 float* __restrict__ lse, int S, int T, int H, int KV, int n,
                                 int bk, int causal,
                                 int window, float softcap, float scale) {
  constexpr int LD = HD + 4;  // byte rows, padded: slot j starts in bank j * (HD/4 + 1)
  constexpr int NO = kBQ * HD / kThreads;  // outputs per thread
  extern __shared__ __align__(16) unsigned char smem[];
  const int side = 1 << n, qmax = side - 1;
  uint16_t* table = reinterpret_cast<uint16_t*>(smem);
  uint8_t* qm = smem + size_t(2) * side * side;  // [kBQ][LD]
  int8_t* qs = reinterpret_cast<int8_t*>(qm + kBQ * LD);
  uint8_t* km = reinterpret_cast<uint8_t*>(qs + kBQ * LD);  // [kMaxBK][LD]: k, then v
  int8_t* ks = reinterpret_cast<int8_t*>(km + kMaxBK * LD);
  Stats st(reinterpret_cast<unsigned char*>(ks + kMaxBK * LD));

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const uint32_t* lut_words = reinterpret_cast<const uint32_t*>(lut);
  uint32_t* table_words = reinterpret_cast<uint32_t*>(table);
  for (int i = threadIdx.x; i < side * side / 2; i += kThreads) table_words[i] = lut_words[i];
  for (int i = threadIdx.x; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, qr = q0 + r;
    int mag = 0, sg = 0;
    if (qr < S) {
      const size_t off = ((size_t(b) * S + qr) * H + h) * HD + d;
      mag = min(int(mq[off]), qmax);
      sg = sq[off];
    }
    qm[r * LD + d] = uint8_t(mag);
    qs[r * LD + d] = int8_t(sg);
  }
  init_stats(st);
  const float qk = __fmul_rn(scales[0], scale), pv = scales[1];
  float acc[NO];
#pragma unroll
  for (int o = 0; o < NO; ++o) acc[o] = 0.f;

  auto stage = [&](const uint8_t* mag_src, const int8_t* sign_src, int k0) {
    for (int i = threadIdx.x; i < bk * HD; i += kThreads) {
      const int j = i / HD, d = i % HD, key = k0 + j;
      int mag = 0, sg = 0;  // pad slots: magnitude 0, sign 0
      if (key < T) {
        const size_t off = ((size_t(b) * T + key) * KV + kvh) * HD + d;
        mag = min(int(mag_src[off]), qmax);
        sg = sign_src[off];
      }
      km[j * LD + d] = uint8_t(mag);
      ks[j * LD + d] = int8_t(sg);
    }
  };

  for (int k0 = 0; k0 < T; k0 += bk) {
    __syncthreads();  // the table and q are in; the previous block is consumed
    stage(mk, sk, k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kBQ * bk; i += kThreads) {
      const int r = i / bk, j = i % bk;
      int s_int = 0;
#pragma unroll 8
      for (int d = 0; d < HD; ++d)
        s_int += int(table[(int(qm[r * LD + d]) << n) | km[j * LD + d]]) *
                 (qs[r * LD + d] * ks[j * LD + d]);
      st.s[r * kMaxBK + j] = approx_score(float(s_int), qk, softcap,
                                          row_pos(q_pos, b, S, q0 + r),
                                          slot_pos(k_pos, b, T, k0 + j), causal, window);
    }
    __syncthreads();
    softmax_step(st, bk, float(qmax));
    stage(mv, sv, k0);
    __syncthreads();
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      const int i = threadIdx.x + o * kThreads;
      const int r = i / HD, c = i % HD;
      int av = 0;
      for (int j = 0; j < bk; ++j)
        av += int(table[(st.p[r * kMaxBK + j] << n) | km[j * LD + c]]) * ks[j * LD + c];
      acc[o] = __fadd_rn(__fmul_rn(acc[o], st.c[r]), __fmul_rn(float(av), pv));
    }
  }
  __syncthreads();
#pragma unroll
  for (int o = 0; o < NO; ++o) {
    const int i = threadIdx.x + o * kThreads;
    const int r = i / HD, c = i % HD, qr = q0 + r;
    if (qr < S)
      out[((size_t(b) * S + qr) * H + h) * HD + c] = __fdiv_rn(acc[o], fmaxf(st.l[r], 1e-30f));
  }
  write_lse(st, lse, b, h, H, S, q0);
}

// -------------------------------------------------------------- lowrank
__host__ __device__ constexpr size_t lowrank_tiles_bytes(int hd, int side, int rank) {
  return 4 * (size_t(side) * rank + size_t(kBQ) * (hd + 1) + size_t(kBQ) * (hd * rank + 1) +
              size_t(kKC) * (hd + 1) + size_t(kKC) * (hd * rank + 1));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
approx_attention_lowrank_kernel(const float* __restrict__ qi, const float* __restrict__ ki,
                                const float* __restrict__ vi, const float* __restrict__ ueq,
                                const float* __restrict__ vek, const float* __restrict__ vev,
                                const float* __restrict__ ut, const int* __restrict__ q_pos,
                                const int* __restrict__ k_pos, const float* __restrict__ scales,
                                float* __restrict__ out, float* __restrict__ lse, int S, int T,
                                int H, int KV, int n, int bk, int causal, int window,
                                float softcap, float scale, int rank) {
  constexpr int LD = HD + 1;
  constexpr int NO = kBQ * HD / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const int side = 1 << n;
  const int W = HD * rank, LW = W + 1;
  float* utab = reinterpret_cast<float*>(smem);  // [side][rank]
  float* qis = utab + side * rank;                // [kBQ][LD]
  float* ues = qis + kBQ * LD;                    // [kBQ][LW]
  float* kis = ues + kBQ * LW;                    // [kKC][LD]: ki, then vi
  float* kes = kis + kKC * LD;                    // [kKC][LW]: vek, then vev
  Stats st(reinterpret_cast<unsigned char*>(kes + kKC * LW));

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  for (int i = threadIdx.x; i < side * rank; i += kThreads) utab[i] = ut[i];
  for (int i = threadIdx.x; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, qr = q0 + r;
    qis[r * LD + d] = qr < S ? qi[((size_t(b) * S + qr) * H + h) * HD + d] : 0.f;
  }
  for (int i = threadIdx.x; i < kBQ * W; i += kThreads) {
    const int r = i / W, e = i % W, qr = q0 + r;
    ues[r * LW + e] = qr < S ? ueq[((size_t(b) * S + qr) * H + h) * W + e] : 0.f;
  }
  init_stats(st);
  const float qk = __fmul_rn(scales[0], scale), pv = scales[1];
  float acc[NO];
#pragma unroll
  for (int o = 0; o < NO; ++o) acc[o] = 0.f;

  // slots [k0 + c0, k0 + c0 + kKC) of x (width HD) and e (width W) into kis / kes
  auto stage = [&](const float* x, const float* e, int k0, int c0) {
    for (int i = threadIdx.x; i < kKC * HD; i += kThreads) {
      const int jj = i / HD, d = i % HD, key = k0 + c0 + jj;
      const bool live = c0 + jj < bk && key < T;
      kis[jj * LD + d] = live ? x[((size_t(b) * T + key) * KV + kvh) * HD + d] : 0.f;
    }
    for (int i = threadIdx.x; i < kKC * W; i += kThreads) {
      const int jj = i / W, w = i % W, key = k0 + c0 + jj;
      const bool live = c0 + jj < bk && key < T;
      kes[jj * LW + w] = live ? e[((size_t(b) * T + key) * KV + kvh) * W + w] : 0.f;
    }
  };

  for (int k0 = 0; k0 < T; k0 += bk) {
    for (int c0 = 0; c0 < bk; c0 += kKC) {
      __syncthreads();
      stage(ki, vek, k0, c0);
      __syncthreads();
      for (int i = threadIdx.x; i < kBQ * kKC; i += kThreads) {
        const int r = i / kKC, jj = i % kKC, j = c0 + jj;
        if (j >= bk) continue;
        float s1 = 0.f, s2 = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) s1 += qis[r * LD + d] * kis[jj * LD + d];
        for (int w = 0; w < W; ++w) s2 += ues[r * LW + w] * kes[jj * LW + w];
        st.s[r * kMaxBK + j] = approx_score(__fadd_rn(s1, s2), qk, softcap,
                                            row_pos(q_pos, b, S, q0 + r),
                                            slot_pos(k_pos, b, T, k0 + j), causal, window);
      }
    }
    __syncthreads();
    softmax_step(st, bk, float(side - 1));
    float av1[NO], av2[NO];
#pragma unroll
    for (int o = 0; o < NO; ++o) av1[o] = av2[o] = 0.f;
    for (int c0 = 0; c0 < bk; c0 += kKC) {
      __syncthreads();  // the softmax is done; the previous chunk is consumed
      stage(vi, vev, k0, c0);
      __syncthreads();
      const int nj = min(kKC, bk - c0);
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        const int i = threadIdx.x + o * kThreads;
        const int r = i / HD, c = i % HD;
        for (int jj = 0; jj < nj; ++jj) {
          const int p = st.p[r * kMaxBK + c0 + jj];
          av1[o] += float(p) * kis[jj * LD + c];  // integers: exact in any order
          for (int rr = 0; rr < rank; ++rr) av2[o] += utab[p * rank + rr] * kes[jj * LW + rr * HD + c];
        }
      }
    }
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      const int r = (threadIdx.x + o * kThreads) / HD;
      acc[o] = __fadd_rn(__fmul_rn(acc[o], st.c[r]), __fmul_rn(__fadd_rn(av1[o], av2[o]), pv));
    }
  }
  __syncthreads();
#pragma unroll
  for (int o = 0; o < NO; ++o) {
    const int i = threadIdx.x + o * kThreads;
    const int r = i / HD, c = i % HD, qr = q0 + r;
    if (qr < S)
      out[((size_t(b) * S + qr) * H + h) * HD + c] = __fdiv_rn(acc[o], fmaxf(st.l[r], 1e-30f));
  }
  write_lse(st, lse, b, h, H, S, q0);
}

template <typename Kernel>
cudaError_t prepare_launch(Kernel kernel, size_t smem) {
  if (smem > 232448) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

template <int HD>
cudaError_t launch_bitexact(const void* const* ops, const void* lut, const void* qp,
                            const void* kp, const void* scales, void* out, void* lse, int B,
                            int S, int T,
                            int H, int KV, int n, int bk, int causal, int window, float softcap,
                            float scale, cudaStream_t stream) {
  const size_t smem = size_t(2) * (size_t(1) << (2 * n)) + bitexact_tiles_bytes<HD>() + stats_bytes();
  auto kernel = approx_attention_bitexact_kernel<HD>;
  cudaError_t err = prepare_launch(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(ops[0]), static_cast<const int8_t*>(ops[1]),
      static_cast<const uint8_t*>(ops[2]), static_cast<const int8_t*>(ops[3]),
      static_cast<const uint8_t*>(ops[4]), static_cast<const int8_t*>(ops[5]),
      static_cast<const uint16_t*>(lut), static_cast<const int*>(qp),
      static_cast<const int*>(kp), static_cast<const float*>(scales), static_cast<float*>(out),
      static_cast<float*>(lse), S, T, H, KV, n, bk, causal, window, softcap, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_lowrank(const void* const* ops, const void* ut, const void* qp,
                           const void* kp, const void* scales, void* out, void* lse, int B,
                           int S, int T,
                           int H, int KV, int n, int bk, int causal, int window, float softcap,
                           float scale, int rank, cudaStream_t stream) {
  const size_t smem = lowrank_tiles_bytes(HD, 1 << n, rank) + stats_bytes();
  auto kernel = approx_attention_lowrank_kernel<HD>;
  cudaError_t err = prepare_launch(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(ops[0]), static_cast<const float*>(ops[1]),
      static_cast<const float*>(ops[2]), static_cast<const float*>(ops[3]),
      static_cast<const float*>(ops[4]), static_cast<const float*>(ops[5]),
      static_cast<const float*>(ut), static_cast<const int*>(qp), static_cast<const int*>(kp),
      static_cast<const float*>(scales), static_cast<float*>(out), static_cast<float*>(lse), S,
      T, H, KV, n, bk, causal, window, softcap, scale, rank);
  return cudaGetLastError();
}

bool bad_shape(int B, int S, int T, int H, int KV, int n, int bk) {
  return B < 1 || S < 1 || T < 1 || KV < 1 || H < KV || H % KV != 0 || H > 65535 ||
         B > 65535 || n < 1 || n > 8 || bk < 1 || bk > kMaxBK;
}

}  // namespace

#define DISPATCH_HD(FN, ...)                    \
  switch (hd) {                                 \
    case 16: return int(FN<16>(__VA_ARGS__));   \
    case 32: return int(FN<32>(__VA_ARGS__));   \
    case 64: return int(FN<64>(__VA_ARGS__));   \
    case 128: return int(FN<128>(__VA_ARGS__)); \
    default: return int(cudaErrorInvalidValue); \
  }

extern "C" int approx_attention_bitexact_launch(
    const void* mq, const void* sq, const void* mk, const void* sk, const void* mv,
    const void* sv, const void* lut, const void* q_pos, const void* k_pos, const void* scales,
    void* out, void* lse, int B, int S, int T, int H, int KV, int hd, int n, int bk, int causal,
    int window, float softcap, float scale, int device, void* stream) {
  if (bad_shape(B, S, T, H, KV, n, bk)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const void* ops[6] = {mq, sq, mk, sk, mv, sv};
  const auto s = static_cast<cudaStream_t>(stream);
  DISPATCH_HD(launch_bitexact, ops, lut, q_pos, k_pos, scales, out, lse, B, S, T, H, KV, n, bk,
              causal, window, softcap, scale, s)
}

extern "C" int approx_attention_lowrank_launch(
    const void* qi, const void* ki, const void* vi, const void* ueq, const void* vek,
    const void* vev, const void* ut, const void* q_pos, const void* k_pos, const void* scales,
    void* out, void* lse, int B, int S, int T, int H, int KV, int hd, int n, int bk, int causal,
    int window, float softcap, float scale, int rank, int device, void* stream) {
  if (bad_shape(B, S, T, H, KV, n, bk) || rank < 1) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const void* ops[6] = {qi, ki, vi, ueq, vek, vev};
  const auto s = static_cast<cudaStream_t>(stream);
  DISPATCH_HD(launch_lowrank, ops, ut, q_pos, k_pos, scales, out, lse, B, S, T, H, KV, n, bk,
              causal, window, softcap, scale, rank, s)
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
