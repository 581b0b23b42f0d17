// Deterministic block-wide reductions for kernels that run one instance
// per thread block.
//
// A warp reduces by an xor butterfly: floating-point addition and
// min/max are commutative, so every lane ends with the bitwise-same
// value.  Lane 0 of each warp then writes its value to shared memory and
// every thread combines the per-warp values in warp order, so every
// thread of the block holds the same result and control flow that
// depends on it stays uniform.  Each call costs two __syncthreads(); the
// first one protects the shared buffer from the previous call's readers.
#pragma once

#include <climits>

namespace lexls {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 32;

struct SumOp {
  template <typename T> __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};
struct MaxOp {
  template <typename T> __device__ __forceinline__ T operator()(T a, T b) const { return a > b ? a : b; }
};
struct MinOp {
  template <typename T> __device__ __forceinline__ T operator()(T a, T b) const { return a < b ? a : b; }
};

template <typename T, typename Op>
__device__ __forceinline__ T warp_reduce(T v, Op op) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, typename Op>
__device__ T block_reduce(T v, Op op) {
  __shared__ T buf[kMaxWarps];
  v = warp_reduce(v, op);
  const int lane = threadIdx.x % kWarp, wid = threadIdx.x / kWarp;
  const int nw = blockDim.x / kWarp;
  __syncthreads();
  if (lane == 0) buf[wid] = v;
  __syncthreads();
  T r = buf[0];
  for (int i = 1; i < nw; ++i) r = op(r, buf[i]);
  return r;
}

template <typename T> __device__ __forceinline__ T block_sum(T v) { return block_reduce(v, SumOp()); }
template <typename T> __device__ __forceinline__ T block_max(T v) { return block_reduce(v, MaxOp()); }
template <typename T> __device__ __forceinline__ T block_min(T v) { return block_reduce(v, MinOp()); }

// Two sums for the price of one pair of barriers.
template <typename T>
__device__ void block_sum2(T& a, T& b) {
  __shared__ T buf[2 * kMaxWarps];
  a = warp_reduce(a, SumOp());
  b = warp_reduce(b, SumOp());
  const int lane = threadIdx.x % kWarp, wid = threadIdx.x / kWarp;
  const int nw = blockDim.x / kWarp;
  __syncthreads();
  if (lane == 0) {
    buf[wid] = a;
    buf[kMaxWarps + wid] = b;
  }
  __syncthreads();
  a = buf[0];
  b = buf[kMaxWarps];
  for (int i = 1; i < nw; ++i) {
    a += buf[i];
    b += buf[kMaxWarps + i];
  }
}

// Sum over a warp's lanes, identical in every lane.
template <typename T> __device__ __forceinline__ T warp_sum(T v) { return warp_reduce(v, SumOp()); }

}  // namespace lexls
