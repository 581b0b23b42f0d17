// Kernel B1: the level-panel factorization of a batch.
//
// Replaces the Pallas TPU kernel lexls_tpu/ops/pallas_lqr.py::panel_factorize
// (pl.pallas_call at pallas_lqr.py:238), which runs a tile of instances
// through the whole pivot loop of one level in VMEM.
//
// Design on the H100: one thread block (128 threads) per instance, which
// walks the level's pivot steps in order and stops at its own rank cutoff
// (the TPU tile had to run until its slowest instance stopped).  The level
// block is updated in place in device memory; per-instance scratch (column
// norms, the reflection vector) is allocated by the wrapper.  At the bench
// shape (dim 30, n 100) the block is 24 KB in float64 and stays in L1/L2,
// so a step is bound by the latency of its three block reductions and the
// barriers between phases, not by bytes or FLOPs: 384 independent blocks
// keep all 132 SMs busy to hide that latency.
#include <cuda_runtime.h>

#include "panel_step.cuh"

namespace lexls {

constexpr int kPanelThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kPanelThreads)
panel_factorize_kernel(T* block, int* pos, int* col_at, int* col_index, int* rank_row, T* hh,
                       T* scratch, int dim, int n, int fr, T tol) {
  const int b = blockIdx.x;
  const int ld = n + 1;
  Panel<T> P;
  P.blk = block + (size_t)b * dim * ld;
  P.ld = ld;
  P.dim = dim;
  P.n = n;
  P.cn = scratch + (size_t)b * (n + dim);
  P.u = P.cn + n;
  P.pos = pos + (size_t)b * n;
  P.col_at = col_at + (size_t)b * n;
  P.rank_row = rank_row + (size_t)b * n;
  P.hh = hh + (size_t)b * dim;
  P.fr = fr;
  P.tol = tol;

  for (int r = threadIdx.x; r < dim; r += blockDim.x) P.hh[r] = T(0);
  panel_init_norms(P);
  int ci = col_index[b];
  __syncthreads();
  for (int counter = 0; counter < dim; ++counter)
    if (!panel_step<T, false>(P, counter, ci)) break;
  if (threadIdx.x == 0) col_index[b] = ci;
}

template <typename T>
int launch_panel(T* block, int* pos, int* col_at, int* col_index, int* rank_row, T* hh,
                 T* scratch, int B, int dim, int n, int fr, T tol, cudaStream_t stream) {
  if (B > 0)
    panel_factorize_kernel<T><<<B, kPanelThreads, 0, stream>>>(
        block, pos, col_at, col_index, rank_row, hh, scratch, dim, n, fr, tol);
  return (int)cudaGetLastError();
}

}  // namespace lexls

extern "C" {

int lexls_panel_factorize_f32(float* block, int* pos, int* col_at, int* col_index,
                              int* rank_row, float* hh, float* scratch, int B, int dim, int n,
                              int fr, float tol, void* stream) {
  return lexls::launch_panel<float>(block, pos, col_at, col_index, rank_row, hh, scratch, B,
                                    dim, n, fr, tol, (cudaStream_t)stream);
}

int lexls_panel_factorize_f64(double* block, int* pos, int* col_at, int* col_index,
                              int* rank_row, double* hh, double* scratch, int B, int dim, int n,
                              int fr, double tol, void* stream) {
  return lexls::launch_panel<double>(block, pos, col_at, col_index, rank_row, hh, scratch, B,
                                     dim, n, fr, tol, (cudaStream_t)stream);
}

}  // extern "C"
