// One pivot step of the level-panel factorization, shared by kernel B1
// (panel_lqr.cu) and kernel B2 (fused.cu).
//
// Counterpart of lexls_tpu/ops/pallas_lqr.py::_panel_step_core: a
// column-pivoted Householder step on one level block of one instance,
// with a virtual column permutation (pos: physical column -> position;
// col_at: its inverse, kept only when LEAN is false).  The whole thread
// block works on one instance; every scalar (pivot, norms, tau) comes
// out of a deterministic block reduction and is held identically by all
// threads, so control flow is uniform.
//
// Exactness notes (same arithmetic as the TPU kernel, up to summation
// order):
//  * pivot = largest remaining column norm, compared with exact ==, ties
//    to the smallest *position*;
//  * the pivot norm is recomputed over the live rows and compared to tol;
//  * a step that does not accept (rank cutoff, or no position left)
//    changes nothing that is read later, and neither does any later step
//    of the level, so the caller may end the level there;
//  * a zero tail still accepts the pivot, with tau = 0 and beta = c0;
//  * the trailing mask uses the updated pos against the old ci and
//    includes the rhs column; the norm downdate reads the updated pivot
//    row.
#pragma once

#include "block_reduce.cuh"

namespace lexls {

template <typename T>
struct Panel {
  T* blk;         // level block, row-major, row stride ld; row 0 = level's first row
  int ld;         // n + 1 (the rhs column is column n)
  int dim;        // rows of the level
  int n;          // variables
  T* cn;          // (n) column norms
  int* pos;       // (n) physical column -> position
  int* col_at;    // (n) position -> physical column (LEAN: unused)
  int* rank_row;  // (n) row of the pivot at each position (LEAN: unused)
  T* hh;          // (dim) Householder tau of each level row
  T* u;           // (dim) scratch: pivot column, then reflection vector
  int fr;         // first row of the level in the whole problem
  T tol;          // rank cutoff on the squared column norm
};

// Column norms of the level block (step 0 state).
template <typename T>
__device__ void panel_init_norms(const Panel<T>& P) {
  for (int c = threadIdx.x; c < P.n; c += blockDim.x) {
    T s = 0;
    for (int r = 0; r < P.dim; ++r) {
      const T a = P.blk[r * P.ld + c];
      s += a * a;
    }
    P.cn[c] = s;
  }
}

// Pivot step `counter`; ci (next free position) is held in a register by
// every thread.  Returns false when the step did not accept a pivot: the
// level is then finished.
template <typename T, bool LEAN>
__device__ bool panel_step(const Panel<T>& P, int counter, int& ci) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = P.n, dim = P.dim, ld = P.ld;

  // pivot: max norm over remaining positions (-1 when none remain) ...
  T mloc = T(-1);
  for (int c = tid; c < n; c += nt)
    if (P.pos[c] >= ci && P.cn[c] > mloc) mloc = P.cn[c];
  const T mx = block_max(mloc);
  // ... then the smallest position among the exact maxima; the key packs
  // (position, column) so one reduction gives both
  long long kloc = LLONG_MAX;
  for (int c = tid; c < n; c += nt) {
    const int q = P.pos[c];
    if (q >= ci && P.cn[c] == mx) {
      const long long k = ((long long)q << 32) | (long long)c;
      if (k < kloc) kloc = k;
    }
  }
  const long long key = block_min(kloc);
  const bool has = key != LLONG_MAX;
  const int qmin = has ? (int)(key >> 32) : INT_MAX;
  const int piv = has ? (int)(key & 0xffffffffLL) : -1;

  // stability recomputation of the pivot norm over the live rows
  T live = 0, tail = 0;
  for (int r = tid; r < dim; r += nt) {
    const T a = has ? P.blk[r * ld + piv] : T(0);
    P.u[r] = a;
    if (r >= counter) live += a * a;
    if (r > counter) tail += a * a;
  }
  block_sum2(live, tail);  // barriers: P.u is visible to all threads after this
  const T max_val = live, s_tail = tail;
  if (has && tid == 0) P.cn[piv] = max_val;
  if (!(max_val >= P.tol) || ci >= n) {
    __syncthreads();  // the cn write above lands before the caller reuses cn
    return false;
  }

  // Householder scalars (identical in every thread)
  const T c0 = P.u[counter];
  const bool nonzero_tail = s_tail > T(0);
  T beta = sqrt(c0 * c0 + s_tail);
  if (c0 >= T(0)) beta = -beta;
  if (!nonzero_tail) beta = c0;
  const T denom = nonzero_tail ? c0 - beta : T(1);
  const T tau = nonzero_tail ? (beta - c0) / beta : T(0);
  const int ci_old = ci;

  // virtual swap: the column at position ci <-> the pivot column
  for (int c = tid; c < n; c += nt) {
    const int q = P.pos[c];
    if (q == ci_old) P.pos[c] = qmin;
    else if (c == piv) P.pos[c] = ci_old;
  }
  if (tid == 0) {
    if (!LEAN) {
      const int c1 = P.col_at[ci_old];
      P.col_at[qmin] = c1;
      P.col_at[ci_old] = piv;
      P.rank_row[ci_old] = P.fr + counter;
    }
    P.hh[counter] = tau;
  }
  __syncthreads();  // every thread has read c0 and the old pos
  for (int r = tid; r < dim; r += nt)
    P.u[r] = r == counter ? T(1) : (r > counter ? P.u[r] / denom : T(0));
  __syncthreads();

  // w = u^T block over the trailing columns (updated pos > old ci) + rhs,
  // then the rank-1 update and the pivot column, column by column; the
  // thread owning column c also downdates its norm by the new pivot row
  for (int c = tid; c <= n; c += nt) {
    if (c == piv) {
      P.blk[counter * ld + c] = beta;
      for (int r = counter + 1; r < dim; ++r) P.blk[r * ld + c] = P.u[r];
      continue;
    }
    if (c < n && !(P.pos[c] > ci_old)) continue;
    T s = 0;
    for (int r = counter; r < dim; ++r) s += P.u[r] * P.blk[r * ld + c];
    for (int r = counter; r < dim; ++r) P.blk[r * ld + c] -= (tau * P.u[r]) * s;
    if (c < n) {
      const T prow = P.blk[counter * ld + c];
      P.cn[c] -= prow * prow;
    }
  }
  ci = ci_old + 1;
  __syncthreads();
  return true;
}

}  // namespace lexls
