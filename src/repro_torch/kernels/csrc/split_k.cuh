// split_k.cuh: the split-K hand-off shared by the integer GEMMs
// (packed_matmul.cu, lowrank_matmul.cu, lut_matmul.cu, seqmul_matmul.cu).
//
// Each block (or work item) of a tile cut into `splits` K slices writes its
// partials to a workspace [split][M][N], then calls split_k_last.  The
// block that counts last for the tile gets true and adds the partials in
// split order 0, 1, 2, ..., so two launches on the same inputs give the
// same bits; once it has written the output it calls split_k_release,
// which sets the tile's counter back to 0 for the next launch on the
// stream (build.tile_counters zeroes the buffer once, when it is made).
//
// Order: every thread fences its own partials, the block waits for all of
// them (__syncthreads), and only then does thread 0 count the tile, so no
// block can count before its partials are visible.  The last block fences
// again before it reads the others' partials (through __ldcg, past L1).
// The call is a block-wide barrier: every thread of the block must make it.

#pragma once

__device__ __forceinline__ bool split_k_last(int* counters, int tile, int splits) {
  __threadfence();
  __syncthreads();  // every thread's partials are out before the count
  const bool last =
      __syncthreads_or(threadIdx.x == 0 && atomicAdd(counters + tile, 1) == splits - 1);
  if (last) __threadfence();
  return last;
}

__device__ __forceinline__ void split_k_release(int* counters, int tile) {
  if (threadIdx.x == 0) counters[tile] = 0;
}
