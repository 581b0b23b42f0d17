// Deterministic reductions for kernels that run one instance per thread
// block.
//
// A warp reduces by an xor butterfly: floating-point addition is
// commutative and the pair orders below are total, so every lane ends with
// the bitwise-same value.  The one block-wide reduction, block_min_pair,
// takes its scratch from the caller's shared memory (the kernels keep all
// their shared memory in one dynamic allocation that the wrapper sizes):
// lane 0 of each warp writes its pair there and every thread combines the
// per-warp pairs in warp order, so every thread of the block holds the
// same result and control flow that depends on it stays uniform.  It costs
// two __syncthreads(); the first protects the scratch from the previous
// call's readers.
#pragma once

#include <climits>

namespace lexls {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;

// Sum over a warp's lanes, identical in every lane.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// (v, k) < (ov, ok) in the order "smaller value, then smaller key".
template <typename T>
__device__ __forceinline__ void take_min_pair(T& v, long long& k, T ov, long long ok) {
  if (ov < v || (ov == v && ok < k)) {
    v = ov;
    k = ok;
  }
}

// Smallest value over the block with ties to the smallest key: the pair
// (value, key) of every thread is replaced by the block's minimum.
// Threads without a candidate pass (+inf, LLONG_MAX).  `scratch` holds
// blockDim.x / 32 keys followed by as many values.
template <typename T>
__device__ void block_min_pair(T& v, long long& k, void* scratch) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    const T ov = __shfl_xor_sync(kFullMask, v, o);
    const long long ok = __shfl_xor_sync(kFullMask, k, o);
    take_min_pair(v, k, ov, ok);
  }
  const int lane = threadIdx.x % kWarp, wid = threadIdx.x / kWarp;
  const int nw = blockDim.x / kWarp;
  long long* keys = (long long*)scratch;
  T* vals = (T*)(keys + nw);
  __syncthreads();
  if (lane == 0) {
    keys[wid] = k;
    vals[wid] = v;
  }
  __syncthreads();
  v = vals[0];
  k = keys[0];
  for (int i = 1; i < nw; ++i) take_min_pair(v, k, vals[i], keys[i]);
}

}  // namespace lexls
