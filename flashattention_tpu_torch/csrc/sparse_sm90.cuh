// Shared by the tensor-core routes of sparse_fwd.cu and sparse_bwd.cu: the
// walk over a q block's list of active KV blocks and the element mask.
#pragma once

#include "flash_sm90.cuh"

namespace fat {
namespace sm90 {

// One CTA's walk over its q block's list: the active KV blocks, each cut
// into sub-tiles from the block's first key up to the causal stop of the
// CTA's last row. Producer and consumers walk it alike, so their ring steps
// agree.
struct ListWalk {
  const int32_t* blocks;
  int n_active, block_k, Nk, stop;  // stop: last row + offset + 1, or Nk
  __device__ __forceinline__ int lo(int w) const { return blocks[w] * block_k; }
  __device__ __forceinline__ int end(int w) const {
    return min(lo(w) + block_k, Nk);
  }
  __device__ __forceinline__ int stop_of(int w) const {
    return min(end(w), stop);
  }
};

// The walk of q block iq whose CTA ends at row r_last.
__device__ __forceinline__ ListWalk list_walk(const AttnArgs& a,
                                              const int32_t* list,
                                              const int32_t* count, int stride,
                                              int iq, int block_k,
                                              int r_last) {
  return ListWalk{list + (size_t)iq * stride, count[iq], block_k, a.Nk,
                  a.causal ? r_last + a.offset + 1 : a.Nk};
}

// Is (row, col) kept inside an active KV block whose keys end at c_end?
__device__ __forceinline__ bool kept(const AttnArgs& a, int row, int col,
                                     int c_end) {
  return col < c_end && (!a.causal || col <= row + a.offset);
}

}  // namespace sm90
}  // namespace fat
