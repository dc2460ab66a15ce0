// flash_attention.cu: online-softmax attention forward (prefill) and the
// one-token decode over the KV cache.
//
// Replaces: src/repro/kernels/flash_attention.py `_fwd_kernel` (pallas_call
// at :100, entry flash_attention at :261) and `_decode_kernel` (pallas_call
// at :360, entry flash_decode at :334).  The backward kernels of that file
// (`_dq_kernel`, `_dkv_kernel`) are in flash_attention_bwd.cu; the prefill
// kernel writes their residual lse = m + log(max(l, 1e-30)) (B, H, S) when
// the caller passes a buffer for it (training), as `_fwd` does.
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
// all T slots, as in the reference.  Slots past T in the last tile do not
// exist in the reference (its tiles divide T); here they carry -inf, which
// gives them p = 0 exactly, since every tile holds at least one real slot.
//
// Prefill, `flash_attention_kernel`: one block per (q-tile of 32 rows,
// head, batch) walks the key tiles of 32 slots in order, each staged in
// shared memory as float32 from bf16 or f32.  Thread (row = tid/4, lane =
// tid%4) owns 8 scores of its row (slots lane + 4i) and 1/4 of its output
// columns (lane + 4i); row max and sum are two shuffles among the row's 4
// lanes.  Rows are padded to HD+1 floats in shared memory, so the 8 rows
// and 4 slots a warp reads sit in distinct banks.
//
// Decode, `flash_decode_kernel`: one block per (KV head, batch); the g
// query heads of the group are the rows and share each staged K/V tile of
// 64 slots.  Scores are one (row, slot) pair per thread step, each warp
// takes the softmax of whole rows, and each thread owns fixed (row,
// column) outputs.
//
// Bound on the H100.  Prefill at the serve shapes is tiny (a few MFLOP);
// at S = T = 1024 it does 4*B*H*S*T*hd float32 FLOPs on the CUDA cores
// (no tensor cores: the reference computes in float32), all key tiles
// including the causally masked ones, since skipping them would change the
// pad rows' uniform average.  Decode moves the cache once: the bytes bound
// it, and with B*KV blocks (32 at qwen3's serve batch) and no split of T
// across blocks this first kernel cannot reach that bound.  Splitting T
// (flash-decoding) and tensor-core tiles are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -2.3819763e38f;
constexpr int kThreads = 128;
constexpr int kBQ = 32;  // prefill: query rows per block
constexpr int kBK = 32;  // prefill: key slots per tile
constexpr int kDecBK = 64;  // decode: key slots per tile
constexpr int kMaxG = 16;   // decode: query heads per KV head

__device__ __forceinline__ float minus_inf() { return __uint_as_float(0xff800000u); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float score(float dot, float scale, float softcap) {
  float s = dot * scale;
  if (softcap != 0.f) s = tanhf(s / softcap) * softcap;
  return s;
}

__device__ __forceinline__ bool allowed(int qp, int kp, int causal, int window) {
  if (kp < 0) return false;
  if (causal && qp < kp) return false;
  if (window >= 0 && qp - kp >= window) return false;
  return true;
}

size_t prefill_smem(int hd) {
  return 4 * (size_t(kBQ) * (hd + 1) + size_t(kBK) * (hd + 1) + size_t(kBK) * hd +
              size_t(kBQ) * (kBK + 1) + kBK);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ q_pos,
                       const int* __restrict__ k_pos, float* __restrict__ out,
                       float* __restrict__ lse, int S, int T_len, int H, int KV, int causal,
                       int window, float softcap, float scale) {
  constexpr int LD = HD + 1;
  constexpr int NC = HD / 4;  // output columns per thread
  extern __shared__ __align__(16) float fsmem[];
  float* qs = fsmem;               // [kBQ][LD]
  float* ks = qs + kBQ * LD;       // [kBK][LD]
  float* vs = ks + kBK * LD;       // [kBK][HD]
  float* ps = vs + kBK * HD;       // [kBQ][kBK + 1]
  int* kps = reinterpret_cast<int*>(ps + kBQ * (kBK + 1));  // [kBK]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int row = threadIdx.x / 4, lane = threadIdx.x % 4;
  const int qrow = q0 + row;

  for (int i = threadIdx.x; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, qr = q0 + r;
    qs[r * LD + d] = qr < S ? to_f32(q[((size_t(b) * S + qr) * H + h) * HD + d]) : 0.f;
  }
  const int qp = qrow < S ? q_pos[size_t(b) * S + qrow] : 0;

  float m = kNegInf, l = 0.f;
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < T_len; k0 += kBK) {
    __syncthreads();  // Q is in; the previous tile is consumed
    for (int i = threadIdx.x; i < kBK * HD; i += kThreads) {
      const int j = i / HD, d = i % HD, key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < T_len) {
        const size_t off = ((size_t(b) * T_len + key) * KV + kvh) * HD + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[j * LD + d] = kx;
      vs[j * HD + d] = vx;
    }
    for (int j = threadIdx.x; j < kBK; j += kThreads)
      kps[j] = k0 + j < T_len ? k_pos[size_t(b) * T_len + k0 + j] : -1;
    __syncthreads();

    float s[kBK / 4];
    float mx = minus_inf();
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) {
      const int j = lane + 4 * i;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot += qs[row * LD + d] * ks[j * LD + d];
      float x = score(dot, scale, softcap);
      if (!allowed(qp, kps[j], causal, window)) x = kNegInf;
      if (k0 + j >= T_len) x = minus_inf();  // not a slot (see the note)
      s[i] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) {
      const float p = expf(s[i] - m_new);
      ps[row * (kBK + 1) + lane + 4 * i] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float corr = expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();  // the row's 4 lanes share one warp
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] *= corr;
    for (int j = 0; j < kBK; ++j) {
      const float p = ps[row * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] += p * vs[j * HD + lane + 4 * c];
    }
  }
  if (qrow < S) {
    const float l_fin = fmaxf(l, 1e-30f);
    float* o = out + ((size_t(b) * S + qrow) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[lane + 4 * c] = acc[c] / l_fin;
    // the backward's residual, when asked for: a row with no allowed slot
    // has m = NEG_INF and l = T, so lse = NEG_INF + log T rounds to NEG_INF
    if (lse != nullptr && lane == 0) lse[(size_t(b) * H + h) * S + qrow] = m + logf(l_fin);
  }
}

size_t decode_smem(int hd) {
  return 4 * (size_t(kMaxG) * hd + size_t(kDecBK) * (hd + 1) + size_t(kDecBK) * hd +
              size_t(kMaxG) * kDecBK + 3 * kMaxG + kDecBK);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                    float* __restrict__ out, int T_len, int H, int KV, int window,
                    float softcap, float scale) {
  constexpr int LD = HD + 1;
  constexpr int NO = (kMaxG * HD + kThreads - 1) / kThreads;  // outputs per thread
  extern __shared__ __align__(16) float fsmem[];
  float* qs = fsmem;                 // [g][HD]
  float* ks = qs + kMaxG * HD;       // [kDecBK][LD]
  float* vs = ks + kDecBK * LD;      // [kDecBK][HD]
  float* ps = vs + kDecBK * HD;      // [g][kDecBK]
  float* ms = ps + kMaxG * kDecBK;   // [g] running max
  float* ls = ms + kMaxG;            // [g] running sum
  float* cs = ls + kMaxG;            // [g] this tile's correction
  int* kps = reinterpret_cast<int*>(cs + kMaxG);  // [kDecBK]

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int g = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qp = q_pos[b];

  for (int i = threadIdx.x; i < g * HD; i += kThreads)
    qs[i] = to_f32(q[(size_t(b) * H + kvh * g) * HD + i]);
  for (int r = threadIdx.x; r < g; r += kThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.f;
  }
  float acc[NO];
#pragma unroll
  for (int o = 0; o < NO; ++o) acc[o] = 0.f;

  for (int k0 = 0; k0 < T_len; k0 += kDecBK) {
    __syncthreads();
    for (int i = threadIdx.x; i < kDecBK * HD; i += kThreads) {
      const int j = i / HD, d = i % HD, key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < T_len) {
        const size_t off = ((size_t(b) * T_len + key) * KV + kvh) * HD + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[j * LD + d] = kx;
      vs[j * HD + d] = vx;
    }
    for (int j = threadIdx.x; j < kDecBK; j += kThreads)
      kps[j] = k0 + j < T_len ? k_pos[size_t(b) * T_len + k0 + j] : -1;
    __syncthreads();
    for (int i = threadIdx.x; i < g * kDecBK; i += kThreads) {
      const int r = i / kDecBK, j = i % kDecBK;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot += qs[r * HD + d] * ks[j * LD + d];
      float x = score(dot, scale, softcap);
      if (!allowed(qp, kps[j], 1, window)) x = kNegInf;
      if (k0 + j >= T_len) x = minus_inf();
      ps[i] = x;
    }
    __syncthreads();
    for (int r = warp; r < g; r += kThreads / 32) {
      float mx = minus_inf();
      for (int j = lane; j < kDecBK; j += 32) mx = fmaxf(mx, ps[r * kDecBK + j]);
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < kDecBK; j += 32) {
        const float p = expf(ps[r * kDecBK + j] - m_new);
        ps[r * kDecBK + j] = p;
        sum += p;
      }
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        cs[r] = corr;
        ls[r] = ls[r] * corr + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      const int i = threadIdx.x + o * kThreads;
      const int r = i / HD, c = i % HD;
      if (r < g) {
        float a = acc[o] * cs[r];
        for (int j = 0; j < kDecBK; ++j) a += ps[r * kDecBK + j] * vs[j * HD + c];
        acc[o] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int o = 0; o < NO; ++o) {
    const int i = threadIdx.x + o * kThreads;
    const int r = i / HD, c = i % HD;
    if (r < g) out[(size_t(b) * H + kvh * g + r) * HD + c] = acc[o] / fmaxf(ls[r], 1e-30f);
  }
}

template <typename T, int HD>
cudaError_t launch_prefill(const void* q, const void* k, const void* v, const void* qp,
                           const void* kp, void* out, void* lse, int B, int S, int T_len, int H,
                           int KV,
                           int causal, int window, float softcap, float scale,
                           cudaStream_t stream) {
  const size_t smem = prefill_smem(HD);
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(qp), static_cast<const int*>(kp), static_cast<float*>(out),
      static_cast<float*>(lse), S, T_len, H, KV, causal, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const void* qp,
                          const void* kp, void* out, int B, int T_len, int H, int KV,
                          int window, float softcap, float scale, cudaStream_t stream) {
  const size_t smem = decode_smem(HD);
  auto kernel = flash_decode_kernel<T, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(KV, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(qp), static_cast<const int*>(kp), static_cast<float*>(out), T_len,
      H, KV, window, softcap, scale);
  return cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16
#define DISPATCH_HD(FN, T, ...)                                      \
  switch (hd) {                                                      \
    case 16: return FN<T, 16>(__VA_ARGS__);                          \
    case 32: return FN<T, 32>(__VA_ARGS__);                          \
    case 64: return FN<T, 64>(__VA_ARGS__);                          \
    case 128: return FN<T, 128>(__VA_ARGS__);                        \
    default: return cudaErrorInvalidValue;                           \
  }

cudaError_t prefill(int dtype, int hd, const void* q, const void* k, const void* v,
                    const void* qp, const void* kp, void* out, void* lse, int B, int S,
                    int T_len, int H, int KV, int causal, int window, float softcap, float scale,
                    cudaStream_t s) {
  if (dtype == 0) {
    DISPATCH_HD(launch_prefill, float, q, k, v, qp, kp, out, lse, B, S, T_len, H, KV, causal,
                window, softcap, scale, s)
  }
  DISPATCH_HD(launch_prefill, __nv_bfloat16, q, k, v, qp, kp, out, lse, B, S, T_len, H, KV,
              causal, window, softcap, scale, s)
}

cudaError_t decode(int dtype, int hd, const void* q, const void* k, const void* v,
                   const void* qp, const void* kp, void* out, int B, int T_len, int H, int KV,
                   int window, float softcap, float scale, cudaStream_t s) {
  if (dtype == 0) {
    DISPATCH_HD(launch_decode, float, q, k, v, qp, kp, out, B, T_len, H, KV, window, softcap,
                scale, s)
  }
  DISPATCH_HD(launch_decode, __nv_bfloat16, q, k, v, qp, kp, out, B, T_len, H, KV, window,
              softcap, scale, s)
}

bool bad_heads(int H, int KV) { return KV < 1 || H < KV || H % KV != 0; }

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* q_pos, const void* k_pos, void* out,
                                      void* lse, int dtype, int B, int S, int T_len, int H,
                                      int KV, int hd,
                                      int causal, int window, float softcap, float scale,
                                      int device, void* stream) {
  if ((dtype != 0 && dtype != 1) || B < 1 || S < 1 || T_len < 1 || bad_heads(H, KV) ||
      H > 65535 || B > 65535)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  return int(prefill(dtype, hd, q, k, v, q_pos, k_pos, out, lse, B, S, T_len, H, KV, causal,
                     window, softcap, scale, static_cast<cudaStream_t>(stream)));
}

extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* q_pos, const void* k_pos, void* out, int dtype,
                                   int B, int T_len, int H, int KV, int hd, int window,
                                   float softcap, float scale, int device, void* stream) {
  if ((dtype != 0 && dtype != 1) || B < 1 || T_len < 1 || bad_heads(H, KV) ||
      H / KV > kMaxG || B > 65535)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  return int(decode(dtype, hd, q, k, v, q_pos, k_pos, out, B, T_len, H, KV, window, softcap,
                    scale, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
