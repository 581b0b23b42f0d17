// Kernel B1: the level-panel factorization of a batch.
//
// Replaces the Pallas TPU kernel lexls_tpu/ops/pallas_lqr.py::panel_factorize
// (pl.pallas_call at pallas_lqr.py:238), which runs a tile of instances
// through the whole pivot loop of one level in VMEM.
//
// Design on the H100: one thread block (128 threads) per instance, which
// walks the level's pivot steps in order and stops at its own rank cutoff
// (the TPU tile had to run until its slowest instance stopped).  What
// bounds the kernel is the latency of that chain of steps (dim of them)
// and the instructions a block's four warps can issue in order, not bytes
// or operations, so the instance's whole state lives in shared memory for
// the length of the call: the block is loaded once, every step runs on
// shared memory with one block-wide barrier (panel_step.cuh), and the
// block, the permutation and the taus are stored once at the end.  At the
// bench shape (dim 30, n 100) that is 14 KB a block in float32; the row
// stride is odd, so a walk along a row and a gather down a column both
// touch 32 different banks.  A level block that does not fit the 227 KB a
// thread block may use stays in device memory, in the output tensor, and
// only the small vectors go to shared memory: the wrapper decides by the
// bytes (ops/panel_lqr.py::panel_layout) and hands the kernel the offsets
// it computed, and the kernel is compiled for either place, so that the
// compiler knows the address space of every access to the block.  The
// kernel reads its inputs and writes its outputs; no input is written.
#include <cuda_runtime.h>

#include "panel_step.cuh"
#include "shared_config.cuh"

namespace lexls {

constexpr int kPanelThreads = kStepWarps * kWarp;

// Regions of the dynamic shared memory, in the order of
// ops/panel_lqr.py::PANEL_REGIONS (byte offsets come from the wrapper).
enum PanelRegion {
  kPanBlk,
  kPanCn,
  kPanHh,
  kPanDen,
  kPanPos,
  kPanColAt,
  kPanRankRow,
  kPanStep,
  kPanRegions
};

template <typename T>
struct PanelArgs {
  const T* block_in;
  const int* pos_in;
  const int* col_at_in;
  const int* col_index_in;
  const int* rank_row_in;
  T* block;
  int* pos;
  int* col_at;
  int* col_index;
  int* rank_row;
  T* hh;
  int dim, n, fr;
  int lds;  // row stride of the level block in shared memory
  T tol;
  int off[kPanRegions];
};

// kBlkShared: the level block lives in shared memory (the compiler then
// knows the address space of every access to it), else in the output tensor.
template <typename T, bool kBlkShared>
__global__ void __launch_bounds__(kPanelThreads, 3) panel_factorize_kernel(PanelArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % kWarp, wid = tid / kWarp, nw = nt / kWarp;
  const int dim = a.dim, n = a.n, ldg = n + 1;
  const T* gin = a.block_in + (size_t)b * dim * ldg;
  T* gout = a.block + (size_t)b * dim * ldg;

  Panel<T> P;
  P.blk = kBlkShared ? (T*)(smem + a.off[kPanBlk]) : gout;
  P.ld = kBlkShared ? a.lds : ldg;
  P.dim = dim;
  P.n = n;
  P.cn = (T*)(smem + a.off[kPanCn]);
  P.hh = (T*)(smem + a.off[kPanHh]);
  P.den = (T*)(smem + a.off[kPanDen]);
  P.pos = (int*)(smem + a.off[kPanPos]);
  P.col_at = (int*)(smem + a.off[kPanColAt]);
  P.rank_row = (int*)(smem + a.off[kPanRankRow]);
  P.sc = (StepScratch<T>*)(smem + a.off[kPanStep]);
  P.fr = a.fr;
  P.tol = a.tol;

  // load: one warp per row of the block, lanes along the row
  for (int r = wid; r < dim; r += nw)
    for (int c = lane; c < ldg; c += kWarp) P.blk[r * P.ld + c] = gin[r * ldg + c];
  for (int c = tid; c < n; c += nt) {
    P.pos[c] = a.pos_in[(size_t)b * n + c];
    P.col_at[c] = a.col_at_in[(size_t)b * n + c];
    P.rank_row[c] = a.rank_row_in[(size_t)b * n + c];
  }
  for (int r = tid; r < dim; r += nt) P.hh[r] = T(0);
  int ci = a.col_index_in[b];
  __syncthreads();
  const int fc = ci;
  StepCarry carry;
  panel_init_norms(P, ci, carry);
  __syncthreads();
  for (int counter = 0; counter < dim; ++counter)
    if (!panel_step<T, false>(P, counter, ci, carry)) break;
  panel_finish(P, fc, ci - fc);

  if (kBlkShared)
    for (int r = wid; r < dim; r += nw)
      for (int c = lane; c < ldg; c += kWarp) gout[r * ldg + c] = P.blk[r * P.ld + c];
  for (int c = tid; c < n; c += nt) {
    a.pos[(size_t)b * n + c] = P.pos[c];
    a.col_at[(size_t)b * n + c] = P.col_at[c];
    a.rank_row[(size_t)b * n + c] = P.rank_row[c];
  }
  for (int r = tid; r < dim; r += nt) a.hh[(size_t)b * dim + r] = P.hh[r];
  if (tid == 0) a.col_index[b] = ci;
}

template <typename T, bool kBlkShared>
int launch_panel(const PanelArgs<T>& a, int B, int smem_bytes, int query, cudaStream_t stream) {
  static size_t configured = 0;
  auto kernel = panel_factorize_kernel<T, kBlkShared>;
  cudaError_t err = configure_shared(kernel, (size_t)smem_bytes, configured);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return query ? -(int)err : (int)err;
  }
  if (query) {
    // resident blocks per SM at this size, for the record
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kPanelThreads,
                                                        (size_t)smem_bytes);
    return err == cudaSuccess ? blocks : -(int)err;
  }
  if (B > 0) kernel<<<B, kPanelThreads, smem_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int panel_entry(const T* block_in, const int* pos_in, const int* col_at_in,
                const int* col_index_in, const int* rank_row_in, T* block, int* pos, int* col_at,
                int* col_index, int* rank_row, T* hh, int B, int dim, int n, int fr, T tol,
                int blk_shared, int lds, const int* off, int smem_bytes, int query,
                cudaStream_t stream) {
  PanelArgs<T> a;
  a.block_in = block_in;
  a.pos_in = pos_in;
  a.col_at_in = col_at_in;
  a.col_index_in = col_index_in;
  a.rank_row_in = rank_row_in;
  a.block = block;
  a.pos = pos;
  a.col_at = col_at;
  a.col_index = col_index;
  a.rank_row = rank_row;
  a.hh = hh;
  a.dim = dim;
  a.n = n;
  a.fr = fr;
  a.lds = lds;
  a.tol = tol;
  for (int i = 0; i < kPanRegions; ++i) a.off[i] = off[i];
  return blk_shared ? launch_panel<T, true>(a, B, smem_bytes, query, stream)
                    : launch_panel<T, false>(a, B, smem_bytes, query, stream);
}

}  // namespace lexls

// `off` is a host array of kPanRegions byte offsets.  With query != 0
// nothing is launched: the entry returns the resident blocks per SM at
// this shared-memory size (or minus the CUDA error).
#define LEXLS_PANEL_ENTRY(NAME, T)                                                              \
  int NAME(const T* block_in, const int* pos_in, const int* col_at_in, const int* col_index_in, \
           const int* rank_row_in, T* block, int* pos, int* col_at, int* col_index,             \
           int* rank_row, T* hh, const int* off, int B, int dim, int n, int fr, int blk_shared, \
           int lds, int smem_bytes, int query, T tol, void* stream) {                           \
    return lexls::panel_entry<T>(block_in, pos_in, col_at_in, col_index_in, rank_row_in,       \
                                  block, pos, col_at, col_index, rank_row, hh, B, dim, n, fr,   \
                                  tol, blk_shared, lds, off, smem_bytes, query,                 \
                                  (cudaStream_t)stream);                                        \
  }

extern "C" {
LEXLS_PANEL_ENTRY(lexls_panel_factorize_f32, float)
LEXLS_PANEL_ENTRY(lexls_panel_factorize_f64, double)
}  // extern "C"
