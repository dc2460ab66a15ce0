// lowrank_tiles.cuh: the tensor-core pieces of the `lowrank` products,
// shared by lowrank_matmul.cu (the GEMM) and approx_attention.cu (its QK
// and AV contractions).
//
// Exact part.  A magnitude |x| <= 255 is 128 h + l; the signed planes s*h
// in {-1, 0, 1} and s*l in [-127, 127] are int8, and a*b = 16384 hh + 128
// (hl + lh) + ll: four mma.sync.m16n8k32.s8.s8 per tile and K step of 32,
// folded into one int32 sum (split_planes, transpose4, mma_s8).
//
// Correction.  The (2^n, r) SVD tables U and V sit in shared memory as
// (hi, lo) TF32 pairs, hi = tf32(x), lo = tf32(x - hi), with a zero row
// after the last (fill_tables).  An element's table entry names its row
// (the clamped magnitude, or the zero row for sign 0) and its sign in bit
// 15 (table_entry); gather loads the (hi, lo) pairs of r = 8q + 2t, 8q +
// 2t + 1 with one 16-byte load and flips their sign bits where the entry
// says, so that the load is the MMA fragment as it is.  mma_tf32 then runs
// lo*hi + hi*lo + hi*hi (lo*lo, about 2^-22 of a product, is dropped).

#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// four magnitude and sign bytes -> the signed planes s*h and s*l (|x| = 128 h + l)
__device__ __forceinline__ void split_planes(uint32_t mag, uint32_t sgn, uint32_t qmax4,
                                             uint32_t& h, uint32_t& l) {
  mag = __vminu4(mag, qmax4);
  const uint32_t neg = __vcmpgts4(0u, sgn);  // 0xff where the sign is negative
  const uint32_t keep = __vcmpne4(sgn, 0u);  // 0xff where it is not zero
  const uint32_t hb = (mag >> 7) & 0x01010101u, lb = mag & 0x7f7f7f7fu;
  h = __vsub4(hb ^ neg, neg) & keep;
  l = __vsub4(lb ^ neg, neg) & keep;
}

// rows r[k] of 4 bytes (one per column) -> columns r[c] of 4 bytes (one per k)
__device__ __forceinline__ void transpose4(uint32_t (&r)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362), t3 = __byte_perm(r[2], r[3], 0x7362);
  r[0] = __byte_perm(t0, t1, 0x5410);
  r[1] = __byte_perm(t0, t1, 0x7632);
  r[2] = __byte_perm(t2, t3, 0x5410);
  r[3] = __byte_perm(t2, t3, 0x7632);
}

// the table entry of byte e: the row (the clamped magnitude, or the zero
// row `side` for sign 0) and the sign in bit 15
__device__ __forceinline__ uint32_t table_entry(uint32_t mag, uint32_t sgn, int e, int qmax) {
  const int m = min(int((mag >> (8 * e)) & 0xffu), qmax);
  const int s = int(int8_t(sgn >> (8 * e)));
  return uint32_t(s != 0 ? m : qmax + 1) | (s < 0 ? 0x8000u : 0u);
}

// One table row's (hi, lo) pairs for r = 8q + 2t, 8q + 2t + 1, signed by
// the entry.  The XORs also let the compiler place each value straight in
// its fragment register: with the sign in the table rows instead (rows
// +T, -T), the loads' registers had to be moved into fragment order, and
// lowrank_matmul ran slower at M = 128 (PERF.md, its redesign).
__device__ __forceinline__ uint4 gather(const float* tab, int row_f, uint32_t entry, int off) {
  const uint4 x = *reinterpret_cast<const uint4*>(tab + int(entry & 0x7fffu) * row_f + off);
  const uint32_t neg = (entry & 0x8000u) << 16;
  return make_uint4(x.x ^ neg, x.y ^ neg, x.z ^ neg, x.w ^ neg);
}

// The tables as (hi, lo) pairs: r = 8q + 2p + e sits at float q*16 + p*4 +
// e (hi) and + 2 (lo), so lane t reads its r = 8q + 2t, 8q + 2t + 1 with
// one 16-byte load; row_f = 2 * r8 floats per row.  Columns past the rank
// and row `side` are 0.  A thread takes four r of a row at a time, its
// eight loads issued together.
template <int kThreads>
__device__ __forceinline__ void fill_tables(float* utab, float* vtab, const float* __restrict__ u,
                                            const float* __restrict__ v, int side, int rank,
                                            int r8, int tid) {
  const int row_f = 2 * r8;
  const int row_chunks = r8 / 4;
#pragma unroll 4
  for (int i = tid; i < (side + 1) * row_chunks; i += kThreads) {
    const int row = i / row_chunks, r0 = (i % row_chunks) * 4;
    float xu[4], xv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = row < side && r0 + e < rank;
      xu[e] = in ? __ldg(u + row * rank + r0 + e) : 0.f;
      xv[e] = in ? __ldg(v + row * rank + r0 + e) : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 2 * h;
      const int pos = row * row_f + (r >> 3) * 16 + ((r & 7) >> 1) * 4;
      const float u0 = __uint_as_float(tf32_rna(xu[2 * h])), u1 = __uint_as_float(tf32_rna(xu[2 * h + 1]));
      const float v0 = __uint_as_float(tf32_rna(xv[2 * h])), v1 = __uint_as_float(tf32_rna(xv[2 * h + 1]));
      const float4 us = make_float4(u0, u1, __uint_as_float(tf32_rna(xu[2 * h] - u0)),
                                    __uint_as_float(tf32_rna(xu[2 * h + 1] - u1)));
      const float4 vs = make_float4(v0, v1, __uint_as_float(tf32_rna(xv[2 * h] - v0)),
                                    __uint_as_float(tf32_rna(xv[2 * h + 1] - v1)));
      *reinterpret_cast<float4*>(utab + pos) = us;
      *reinterpret_cast<float4*>(vtab + pos) = vs;
    }
  }
}
