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
// Design.  A simple kernel, right first: float32 FMAs on the CUDA cores from
// shared memory, no tensor cores, every tile computed (the causally masked
// ones too).  128 threads; tiles of 32 query rows by 32 key slots staged as
// float32 rows padded to HD+1 floats, so the rows and slots a warp reads
// sit in distinct banks.
//   dq: one block per (q-tile, head, batch) walks every key tile of its KV
//       head.  Thread (row = tid/4, lane = tid%4) computes 8 (row, slot)
//       pairs (slots lane + 4i) and owns dq's columns lane + 4c of its row.
//   dk/dv: one block per (k-tile, KV head, batch) walks the group's g query
//       heads and every query tile: the TPU grid's sequential (g, q-block)
//       axes become a loop inside the block, so no two blocks write one
//       output and no atomics are needed.  Thread (slot = tid/4, lane)
//       computes 8 (row, slot) pairs (rows lane + 4i) and owns dk's and dv's
//       columns lane + 4c of its slot.
// Both write float32; the cast to the input dtype happens outside, as at
// :253.
//
// Bound on the H100.  7*hd FMAs per allowed (query head, slot) pair, 3*hd in
// dq (two recomputed dots and ds.k) and 4*hd in dk/dv (the same two dots,
// p.do and ds.q), on the float32 CUDA cores: at the train shape (B = 8,
// S = T = 128, causal, 16 query and 8 KV heads of 128) 1.9 GFLOP against
// some 33 MB of operands, so operations, not bytes, bound it.  Tensor
// cores (wgmma on bf16 tiles), skipping fully masked tiles and splitting
// the long walks are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -2.3819763e38f;
constexpr int kThreads = 128;
constexpr int kBQ = 32;  // query rows per tile
constexpr int kBK = 32;  // key slots per tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ bool allowed(int qp, int kp, int causal, int window) {
  if (kp < 0) return false;
  if (causal && qp < kp) return false;
  if (window >= 0 && qp - kp >= window) return false;
  return true;
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

size_t dq_smem(int hd) {
  return 4 * (4 * size_t(kBQ) * (hd + 1) + size_t(kBQ) * (kBK + 1) + kBK);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ dd,
                              const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                              float* __restrict__ dq, int S, int T_len, int H, int KV,
                              int causal, int window, float softcap, float scale) {
  constexpr int LD = HD + 1;
  constexpr int NC = HD / 4;  // dq columns per thread
  extern __shared__ __align__(16) float fsmem[];
  float* qs = fsmem;              // [kBQ][LD]
  float* dos = qs + kBQ * LD;     // [kBQ][LD]
  float* ks = dos + kBQ * LD;     // [kBK][LD]
  float* vs = ks + kBK * LD;      // [kBK][LD]
  float* dss = vs + kBK * LD;     // [kBQ][kBK + 1]
  int* kps = reinterpret_cast<int*>(dss + kBQ * (kBK + 1));  // [kBK]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int row = threadIdx.x / 4, lane = threadIdx.x % 4;
  const int qrow = q0 + row;
  const bool live = qrow < S;

  for (int i = threadIdx.x; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, qr = q0 + r;
    const size_t off = ((size_t(b) * S + qr) * H + h) * HD + d;
    qs[r * LD + d] = qr < S ? to_f32(q[off]) : 0.f;
    dos[r * LD + d] = qr < S ? dout[off] : 0.f;
  }
  const size_t stat = (size_t(b) * H + h) * S + qrow;
  const int qp = live ? q_pos[size_t(b) * S + qrow] : 0;
  const float row_lse = live ? lse[stat] : 0.f;
  const float row_dd = live ? dd[stat] : 0.f;

  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < T_len; k0 += kBK) {
    __syncthreads();  // q and do are in; the previous tile is consumed
    for (int i = threadIdx.x; i < kBK * HD; i += kThreads) {
      const int j = i / HD, d = i % HD, key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < T_len) {
        const size_t off = ((size_t(b) * T_len + key) * KV + kvh) * HD + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[j * LD + d] = kx;
      vs[j * LD + d] = vx;
    }
    for (int j = threadIdx.x; j < kBK; j += kThreads)
      kps[j] = k0 + j < T_len ? k_pos[size_t(b) * T_len + k0 + j] : -1;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) {
      const int j = lane + 4 * i;
      float dot = 0.f, dpv = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        dot += qs[row * LD + d] * ks[j * LD + d];
        dpv += dos[row * LD + d] * vs[j * LD + d];
      }
      const bool ok = live && k0 + j < T_len && allowed(qp, kps[j], causal, window);
      dss[row * (kBK + 1) + j] = recompute(dot, dpv, row_lse, row_dd, ok, scale, softcap).ds;
    }
    __syncwarp();  // the row's 4 lanes share one warp
    for (int j = 0; j < kBK; ++j) {
      const float ds = dss[row * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] += ds * ks[j * LD + lane + 4 * c];
    }
  }
  if (live) {
    float* o = dq + ((size_t(b) * S + qrow) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[lane + 4 * c] = acc[c] * scale;
  }
}

size_t dkv_smem(int hd) {
  return 4 * (4 * size_t(kBK) * (hd + 1) + 2 * size_t(kBK) * (kBQ + 1) + 3 * kBQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const float* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ dd,
                               const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                               float* __restrict__ dk, float* __restrict__ dv, int S, int T_len,
                               int H, int KV, int causal, int window, float softcap,
                               float scale) {
  constexpr int LD = HD + 1;
  constexpr int NC = HD / 4;  // dk and dv columns per thread
  constexpr int LP = kBQ + 1;
  extern __shared__ __align__(16) float fsmem[];
  float* ks = fsmem;              // [kBK][LD]
  float* vs = ks + kBK * LD;      // [kBK][LD]
  float* qs = vs + kBK * LD;      // [kBQ][LD]
  float* dos = qs + kBQ * LD;     // [kBQ][LD]
  float* ps = dos + kBQ * LD;     // [kBK][LP]: p, slot-major
  float* dss = ps + kBK * LP;     // [kBK][LP]: ds, slot-major
  float* lses = dss + kBK * LP;   // [kBQ]
  float* dds = lses + kBQ;        // [kBQ]
  int* qps = reinterpret_cast<int*>(dds + kBQ);  // [kBQ]

  const int k0 = blockIdx.x * kBK, kvh = blockIdx.y, b = blockIdx.z;
  const int g = H / KV;
  const int slot = threadIdx.x / 4, lane = threadIdx.x % 4;
  const int key = k0 + slot;
  const bool live = key < T_len;

  for (int i = threadIdx.x; i < kBK * HD; i += kThreads) {
    const int j = i / HD, d = i % HD, kk = k0 + j;
    float kx = 0.f, vx = 0.f;
    if (kk < T_len) {
      const size_t off = ((size_t(b) * T_len + kk) * KV + kvh) * HD + d;
      kx = to_f32(k[off]);
      vx = to_f32(v[off]);
    }
    ks[j * LD + d] = kx;
    vs[j * LD + d] = vx;
  }
  const int kp = live ? k_pos[size_t(b) * T_len + key] : -1;

  float dk_acc[NC], dv_acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  for (int gi = 0; gi < g; ++gi) {
    const int h = kvh * g + gi;
    for (int q0 = 0; q0 < S; q0 += kBQ) {
      __syncthreads();  // k and v are in; the previous tile is consumed
      for (int i = threadIdx.x; i < kBQ * HD; i += kThreads) {
        const int r = i / HD, d = i % HD, qr = q0 + r;
        const size_t off = ((size_t(b) * S + qr) * H + h) * HD + d;
        qs[r * LD + d] = qr < S ? to_f32(q[off]) : 0.f;
        dos[r * LD + d] = qr < S ? dout[off] : 0.f;
      }
      for (int r = threadIdx.x; r < kBQ; r += kThreads) {
        const int qr = q0 + r;
        const size_t stat = (size_t(b) * H + h) * S + qr;
        qps[r] = qr < S ? q_pos[size_t(b) * S + qr] : 0;
        lses[r] = qr < S ? lse[stat] : 0.f;
        dds[r] = qr < S ? dd[stat] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < kBQ / 4; ++i) {
        const int r = lane + 4 * i;
        float dot = 0.f, dpv = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
          dot += qs[r * LD + d] * ks[slot * LD + d];
          dpv += dos[r * LD + d] * vs[slot * LD + d];
        }
        const bool exists = live && q0 + r < S;
        const bool ok = exists && allowed(qps[r], kp, causal, window);
        const Pair pr = recompute(dot, dpv, lses[r], dds[r], ok, scale, softcap);
        ps[slot * LP + r] = exists ? pr.p : 0.f;  // p is not masked (see the note)
        dss[slot * LP + r] = pr.ds;
      }
      __syncwarp();  // the slot's 4 lanes share one warp
      for (int r = 0; r < kBQ; ++r) {
        const float p = ps[slot * LP + r], ds = dss[slot * LP + r];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv_acc[c] += p * dos[r * LD + lane + 4 * c];
          dk_acc[c] += ds * qs[r * LD + lane + 4 * c];
        }
      }
    }
  }
  if (live) {
    const size_t off = ((size_t(b) * T_len + key) * KV + kvh) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[off + lane + 4 * c] = dk_acc[c] * scale;
      dv[off + lane + 4 * c] = dv_acc[c];
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *dd, *q_pos, *k_pos;
  int B, S, T_len, H, KV, causal, window;
  float softcap, scale;
};

template <typename T, int HD>
cudaError_t launch_dq(const Args& a, void* dq, cudaStream_t stream) {
  const size_t smem = dq_smem(HD);
  auto kernel = flash_attention_bwd_dq_kernel<T, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.dd), static_cast<const int*>(a.q_pos),
      static_cast<const int*>(a.k_pos), static_cast<float*>(dq), a.S, a.T_len, a.H, a.KV,
      a.causal, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv, cudaStream_t stream) {
  const size_t smem = dkv_smem(HD);
  auto kernel = flash_attention_bwd_dkv_kernel<T, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T_len + kBK - 1) / kBK, a.KV, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(
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
    default: return cudaErrorInvalidValue;                                         \
  }

cudaError_t dq_dispatch(int dtype, int hd, const Args& a, void* dq, cudaStream_t s) {
  DISPATCH(launch_dq, a, dq, s)
}

cudaError_t dkv_dispatch(int dtype, int hd, const Args& a, void* dk, void* dv, cudaStream_t s) {
  DISPATCH(launch_dkv, a, dk, dv, s)
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

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
