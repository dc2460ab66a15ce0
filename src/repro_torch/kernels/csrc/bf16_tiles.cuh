// bf16_tiles.cuh: the bf16 tensor-core pieces shared by flash_attention.cu
// (the forward) and flash_attention_bwd.cu (the backward pair).
//
// Products run mma.sync.m16n8k16 bf16 with float32 accumulation, on tiles
// ("planes") of bf16 values in shared memory whose rows are padded by 16
// bytes (LD = HD + 8 values), so the eight rows an ldmatrix reads fall in
// eight distinct bank groups.  A bf16 operand is one plane, exact; a
// float32 operand x is N planes, x1 = bf16(x), x2 = bf16(x - x1), ...,
// each term's rounding 2^-8 of what is left, so N terms leave at most
// 2^-8N of |x| (2^-16 for two, 2^-24 for three).  mma_terms runs the
// products A_i B_j with i + j < N, the small terms first: the dropped
// ones are at most about 2^-8N of the product each.  cp.async copies 16
// (or 4) bytes, filling zeros where the source is not valid.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of the 16 x 16 block at (row0, col0) of a plane (rows of ld values)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* plane, int ld,
                                       int row0, int col0, int lane) {
  ldsm_x4(a, plane + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8);
}

// B fragments {b0, b1} of two 8-wide n-tiles (n0.., n0 + 8..), 16 deep from
// k0, of a plane whose rows are n (k contiguous)
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const __nv_bfloat16* plane, int ld,
                                          int n0, int k0, int lane) {
  ldsm_x4(b, plane + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// the same of a plane whose rows are k (n contiguous)
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const __nv_bfloat16* plane, int ld,
                                          int k0, int n0, int lane) {
  ldsm_x4_t(b, plane + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
}

// d += sum of A_i B_j over the terms i + j < N (a one-plane operand is
// exact), the small terms first; h picks the n-tile of the B fragments
template <int PA, int PB, int N = 2>
__device__ __forceinline__ void mma_terms(float (&d)[4], const uint32_t (&a)[PA][4],
                                          const uint32_t (&b)[PB][4], int h) {
#pragma unroll
  for (int s = N - 1; s >= 0; --s)
#pragma unroll
    for (int i = 0; i < PA; ++i) {
      const int j = s - i;
      if (j >= 0 && j < PB) mma_bf16(d, a[i], b[j][2 * h], b[j][2 * h + 1]);
    }
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat162 v) {
  return uint32_t(__bfloat16_as_ushort(v.x)) | (uint32_t(__bfloat16_as_ushort(v.y)) << 16);
}

// two float32 values (k, k + 1) -> their N bf16 terms, packed in pairs
template <int N>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
    out[i] = bf16_bits(v);
    x0 -= __low2float(v);
    x1 -= __high2float(v);
  }
}

// the split A fragments of the 16 x 16 block held as two 16 x 8 C tiles
template <int N>
__device__ __forceinline__ void split_a(uint32_t (&a)[N][4], const float (&c0)[4],
                                        const float (&c1)[4]) {
  uint32_t x[N];
  split_pair(c0[0], c0[1], x);
#pragma unroll
  for (int i = 0; i < N; ++i) a[i][0] = x[i];
  split_pair(c0[2], c0[3], x);
#pragma unroll
  for (int i = 0; i < N; ++i) a[i][1] = x[i];
  split_pair(c1[0], c1[1], x);
#pragma unroll
  for (int i = 0; i < N; ++i) a[i][2] = x[i];
  split_pair(c1[2], c1[3], x);
#pragma unroll
  for (int i = 0; i < N; ++i) a[i][3] = x[i];
}

// four float32 values -> their terms, stored at column c of row r of each plane
template <int LD, int N = 2>
__device__ __forceinline__ void store_split(__nv_bfloat16* planes, int plane, int r, int c,
                                            float4 x) {
  uint32_t lo[N], hi[N];
  split_pair(x.x, x.y, lo);
  split_pair(x.z, x.w, hi);
#pragma unroll
  for (int s = 0; s < N; ++s)
    *reinterpret_cast<uint2*>(planes + s * plane + r * LD + c) = make_uint2(lo[s], hi[s]);
}

// rows x HD float32 staged raw in shared memory -> N planes
template <int HD, int N = 2>
__device__ void split_rows(__nv_bfloat16* planes, int plane, const float* raw, int rows, int tid,
                           int nthreads) {
  constexpr int C4 = HD / 4;
  for (int i = tid; i < rows * C4; i += nthreads) {
    const int r = i / C4, c = (i % C4) * 4;
    store_split<HD + 8, N>(planes, plane, r, c, *reinterpret_cast<const float4*>(raw + r * HD + c));
  }
}

// rows x HD float32 read from device memory (rows past nvalid as zeros) -> N planes;
// UNROLL 16-byte chunks in flight a thread
template <int HD, int N = 2, int UNROLL = 4>
__device__ void load_split_rows(__nv_bfloat16* planes, int plane, const float* src,
                                size_t stride, int rows, int nvalid, int tid, int nthreads) {
  constexpr int C4 = HD / 4;
#pragma unroll (UNROLL)
  for (int i = tid; i < rows * C4; i += nthreads) {
    const int r = i / C4, c = (i % C4) * 4;
    const float4 x = r < nvalid ? __ldg(reinterpret_cast<const float4*>(src + r * stride + c))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    store_split<HD + 8, N>(planes, plane, r, c, x);
  }
}

// rows x HD values of type T, cp.async into rows of LD values (zeros past nvalid)
template <typename T, int HD, int LD>
__device__ void copy_rows(T* dst, const T* src, size_t stride, int rows, int nvalid, int tid,
                          int nthreads) {
  constexpr int kChunk = 16 / sizeof(T);
  constexpr int kPerRow = HD / kChunk;
  for (int i = tid; i < rows * kPerRow; i += nthreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kChunk;
    const bool ok = r < nvalid;
    cp_async16(dst + r * LD + c, ok ? src + r * stride + c : src, ok);
  }
}

// the first live tile at or after `from`, or -1
__device__ __forceinline__ int next_live(const uint32_t* mask, int words, int from) {
  int w = from >> 5;
  if (w >= words) return -1;
  uint32_t bits = mask[w] & (~0u << (from & 31));
  while (bits == 0) {
    if (++w >= words) return -1;
    bits = mask[w];
  }
  return (w << 5) + __ffs(bits) - 1;
}

__device__ __forceinline__ void warp_min_max(int& mn, int& mx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
}

__device__ __forceinline__ bool allowed(int qp, int kp, int causal, int window) {
  if (kp < 0) return false;
  if (causal && qp < kp) return false;
  if (window >= 0 && qp - kp >= window) return false;
  return true;
}
