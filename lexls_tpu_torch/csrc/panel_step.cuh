// One pivot step of the level-panel factorization, shared by kernel B1
// (panel_lqr.cu) and kernel B2 (fused.cu).
//
// Counterpart of lexls_tpu/ops/pallas_lqr.py::_panel_step_core: a
// column-pivoted Householder step on one level block of one instance,
// with a virtual column permutation (pos: physical column -> position;
// col_at: its inverse, so that a column follows from its position).  The
// whole thread block (four warps) works on one instance.
//
// What bounds a step on the H100 is the latency of its chain of dependent
// phases, not bytes or operations: a block's few warps issue in order, so
// whatever one warp does alone, and every load whose value the next
// instruction waits for, is paid in full.  The step is therefore ONE
// block-wide barrier on shared memory (the level block itself may lie in
// device memory when it does not fit; the kernels are compiled for either
// so that the compiler knows the address space), and nothing is left to
// one warp:
//  * every thread reads the four warps' candidates for this step's pivot
//    (published by the step before) and forms the same beta, tau and
//    denominator itself;
//  * every thread takes the trailing columns it owns: the column and the
//    raw pivot column are loaded into registers, the dot product with the
//    reflection vector u = (1, a / denom) is taken as
//    x_0 + (sum a_i x_i) (1 / denom) and the rank-1 update as one
//    multiply-add per entry with the scalar (tau s) (1 / denom), so that u
//    itself is never formed and a step divides once; the thread downdates the column's norm and, from the same
//    registers, computes what the next step needs should this column
//    become its pivot (the norm over the live rows, the tail norm, the
//    diagonal entry);
//  * each warp reduces its columns to its best candidate (largest norm,
//    ties to the smallest position) and publishes it into the buffer of
//    the next step (two buffers alternate, so one barrier is enough);
//  * the owners of the two swapped columns write the new positions;
//  * barrier;
//  * the pivot column as the step leaves it has beta on the diagonal (the
//    pivot's owner writes it at once: no step reads a diagonal entry) and
//    the essential part of u, a / denom, below it, which can only be
//    written once nobody reads the raw column any more: the step stores
//    its denominator and panel_finish divides all the level's pivot
//    columns at once.
// panel_init_norms publishes the candidates of a level's first step.
// Every thread derives the same scalars from the same shared values, so
// control flow stays uniform.
//
// Exactness notes (same arithmetic as the TPU kernel, up to the order of
// sums and the placement of the division by the denominator):
//  * pivot = largest remaining column norm, compared with exact ==, ties
//    to the smallest *position*;
//  * the pivot norm is recomputed over the live rows and compared to tol;
//  * a step that does not accept (rank cutoff, or no position left)
//    changes nothing that is read later, and neither does any later step
//    of the level, so the caller may end the level there;
//  * a zero tail still accepts the pivot, with tau = 0 and beta = c0;
//  * the trailing columns are the remaining positions but the pivot's,
//    and the rhs column; the norm downdate reads the updated pivot row.
#pragma once

#include "block_reduce.cuh"

namespace lexls {

// Warps of a block that runs the step (the kernels launch 128 threads).
constexpr int kStepWarps = 4;

// A warp's best remaining column, with what the step needs of it.
template <typename T>
struct Candidate {
  T cn;    // downdated norm (what the pivot is chosen by); -1: none
  T live;  // norm recomputed over the live rows
  T tail;  // the same without the diagonal entry
  T c0;    // the diagonal entry
  int pos;  // INT_MAX: none
  int col;
};

// The step's shared scratch: the candidates of even and of odd steps
// (ops/panel_lqr.py::_STEP_BYTES holds either type).
template <typename T>
struct StepScratch {
  Candidate<T> best[2][kStepWarps];
};

template <typename T>
struct Panel {
  T* blk;         // level block, row-major, row stride ld; row 0 = level's first row
  int ld;         // row stride, at least n + 1 (the rhs column is column n)
  int dim;        // rows of the level
  int n;          // variables
  T* cn;          // (n) column norms, shared memory
  int* pos;       // (n) physical column -> position, shared memory
  int* col_at;    // (n) position -> physical column, shared memory
  int* rank_row;  // (n) row of the pivot at each position (LEAN: unused)
  T* hh;          // (dim) Householder tau of each level row, shared memory
  T* den;         // (dim) scratch: each step's denominator, shared memory
  StepScratch<T>* sc;
  int fr;         // first row of the level in the whole problem
  T tol;          // rank cutoff on the squared column norm
};

// What a step hands to the next one in registers, identical in every
// thread: the column at the next free position.
struct StepCarry {
  int c1;  // col_at[ci]
};

// (cn, pos) beats (bn, bq): larger norm, ties to the smaller position.
// A thread without a column holds (-1, INT_MAX), which nothing of norm
// -1 or less beats.
template <typename T>
__device__ __forceinline__ bool beats(T cn, int pos, T bn, int bq) {
  return cn > bn || (cn == bn && pos < bq);
}

template <typename T>
__device__ __forceinline__ Candidate<T> no_candidate() {
  Candidate<T> c;
  c.cn = T(-1);
  c.live = c.tail = c.c0 = T(0);
  c.pos = INT_MAX;
  c.col = -1;
  return c;
}

// Every thread of the block passes its best remaining column (or
// no_candidate()); each warp publishes the best of its lanes into `best`:
// the largest norm by a shuffle reduction of the norm alone, its owner by a
// ballot, and only where norms tie exactly a second reduction over the
// positions.  (The hardware's integer reductions, __reduce_max_sync on the
// norm's bits, would be shorter still, but a warp that reaches them from a
// divergent loop never returned from them on the H100 this was developed
// on.)
template <typename T>
__device__ __forceinline__ void publish_candidate(Candidate<T>* best, const Candidate<T>& mine) {
  // a column takes part if it beats no_candidate(): a norm of at least -1
  const bool valid = mine.pos != INT_MAX && mine.cn >= T(-1);
  const T v = valid ? mine.cn : T(-1);
  T mx = v;
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    const T other = __shfl_xor_sync(kFullMask, mx, o);
    mx = other > mx ? other : mx;
  }
  const unsigned tied = __ballot_sync(kFullMask, valid && v == mx);
  const int lane = threadIdx.x % kWarp, wid = threadIdx.x / kWarp;
  if (tied == 0u) {
    if (lane == 0) best[wid] = no_candidate<T>();
    return;
  }
  bool owner = tied == (1u << lane);
  if (tied & (tied - 1u)) {
    // several lanes hold the largest norm: the smallest position wins
    int bq = (tied >> lane) & 1u ? mine.pos : INT_MAX;
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1) {
      const int oq = __shfl_xor_sync(kFullMask, bq, o);
      bq = oq < bq ? oq : bq;
    }
    owner = ((tied >> lane) & 1u) && mine.pos == bq;
  }
  if (owner) best[wid] = mine;
}

// Column norms of the level block (step 0 state) and the candidates of
// the level's first step; ci is the next free position.  The caller puts
// a barrier between this and the first step.
template <typename T>
__device__ void panel_init_norms(const Panel<T>& P, int ci, StepCarry& carry) {
  Candidate<T> mine = no_candidate<T>();
  for (int c = threadIdx.x; c < P.n; c += blockDim.x) {
    T s = 0, c0 = 0, tail = 0;
    for (int r = 0; r < P.dim; ++r) {
      const T a = P.blk[r * P.ld + c];
      s += a * a;
      if (r == 0) c0 = a;
      else tail += a * a;
    }
    P.cn[c] = s;
    const int q = P.pos[c];
    if (q >= ci && beats(s, q, mine.cn, mine.pos)) {
      mine.cn = mine.live = s;
      mine.tail = tail;
      mine.c0 = c0;
      mine.pos = q;
      mine.col = c;
    }
  }
  publish_candidate(P.sc->best[0], mine);
  carry.c1 = ci < P.n ? P.col_at[ci] : -1;
}

// The rank-1 update of one trailing column held in registers (CH rows at
// most; nl of them live).  a: the raw pivot column (every thread reads the
// same entry: a broadcast); col: this column, both from the diagonal row
// down.  Returns the updated diagonal-row entry and
// the column's candidacy values for the next step.
template <typename T, int CH>
__device__ __forceinline__ void update_column(const T* a, T* col, int ld, int nl, T tau, T rden,
                                              T& prow, T& c0, T& tail) {
  // the pivot column goes to registers too where both fit comfortably
  constexpr bool kHoldA = sizeof(T) * CH <= 128;
  T x[CH], av[kHoldA ? CH : 1];
#pragma unroll
  for (int i = 0; i < CH; ++i) x[i] = i < nl ? col[i * ld] : T(0);
  if (kHoldA) {
#pragma unroll
    for (int i = 1; i < CH; ++i) av[i] = i < nl ? a[i * ld] : T(0);
  }
  T sraw = 0;
#pragma unroll
  for (int i = 1; i < CH; ++i)
    if (i < nl) sraw += (kHoldA ? av[i] : a[i * ld]) * x[i];
  const T s = x[0] + sraw * rden;
  const T t = (tau * s) * rden;
  x[0] -= tau * s;
#pragma unroll
  for (int i = 1; i < CH; ++i)
    if (i < nl) x[i] -= t * (kHoldA ? av[i] : a[i * ld]);
#pragma unroll
  for (int i = 0; i < CH; ++i)
    if (i < nl) col[i * ld] = x[i];
  prow = x[0];
  c0 = CH > 1 ? x[1] : T(0);
  tail = 0;
#pragma unroll
  for (int i = 2; i < CH; ++i) tail += x[i] * x[i];
}

// Pivot step `counter`; ci (next free position) is held in a register by
// every thread.  Returns false when the step did not accept a pivot: the
// level is then finished.  A step that accepts ends with a barrier; after
// the level's last step the caller runs panel_finish.
template <typename T, bool LEAN>
__device__ bool panel_step(const Panel<T>& P, int counter, int& ci, StepCarry& carry) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = P.n, dim = P.dim, ld = P.ld;

  // the best of the warps' candidates
  const Candidate<T>* best = P.sc->best[counter & 1];
  T bn = T(-1);
  int qmin = INT_MAX, w = 0;
#pragma unroll
  for (int i = 0; i < kStepWarps; ++i) {
    const T on = best[i].cn;
    const int oq = best[i].pos;
    if (beats(on, oq, bn, qmin)) {
      bn = on;
      qmin = oq;
      w = i;
    }
  }
  if (qmin == INT_MAX) return false;
  // stability recomputation of the pivot norm over the live rows
  const T max_val = best[w].live;
  if (!(max_val >= P.tol) || ci >= n) return false;
  const int piv = best[w].col;
  const T c0 = best[w].c0, s_tail = best[w].tail;
  const bool nonzero_tail = s_tail > T(0);
  T beta = sqrt(c0 * c0 + s_tail);
  if (c0 >= T(0)) beta = -beta;
  if (!nonzero_tail) beta = c0;
  const T denom = nonzero_tail ? c0 - beta : T(1);
  const T tau = nonzero_tail ? (beta - c0) / beta : T(0);
  const T rden = T(1) / denom;  // the columns multiply by it, one division a step
  const int c1 = carry.c1;
  const int nl = dim - counter;  // live rows
  const T* a = P.blk + counter * ld + piv;

  // w = u^T block over the trailing columns + rhs, then the rank-1 update,
  // column by column; the thread owning column c also downdates its norm
  // by the new pivot row, prepares the column's candidacy for the next
  // step (live rows counter + 1 ..) and moves the column's position
  Candidate<T> mine = no_candidate<T>();
  for (int c = tid; c <= n; c += nt) {
    int q = INT_MAX;
    if (c < n) {
      q = P.pos[c];
      // virtual swap: the column at position ci <-> the pivot column
      if (c == c1) P.pos[c] = q = qmin;
      if (c == piv) {
        P.pos[c] = ci;
        P.col_at[qmin] = c1;
        P.col_at[ci] = piv;
        if (!LEAN) P.rank_row[ci] = P.fr + counter;
        P.hh[counter] = tau;
        P.cn[c] = max_val;
        // the diagonal entry, which no thread reads during the level, and
        // the denominator that panel_finish divides the rest of the column by
        P.blk[counter * ld + c] = beta;
        P.den[counter] = denom;
      }
    }
    if (c == piv || q < ci) continue;
    T* col = P.blk + counter * ld + c;
    T prow, d0, tail;
    if (nl <= 8) {
      update_column<T, 8>(a, col, ld, nl, tau, rden, prow, d0, tail);
    } else if (nl <= 16) {
      update_column<T, 16>(a, col, ld, nl, tau, rden, prow, d0, tail);
    } else if (nl <= 24) {
      update_column<T, 24>(a, col, ld, nl, tau, rden, prow, d0, tail);
    } else if (nl <= 32) {
      update_column<T, 32>(a, col, ld, nl, tau, rden, prow, d0, tail);
    } else {
      T sraw = 0;
      for (int i = 1; i < nl; ++i) sraw += a[i * ld] * col[i * ld];
      const T s = col[0] + sraw * rden;
      const T t = (tau * s) * rden;
      prow = col[0] - tau * s;
      col[0] = prow;
      d0 = tail = 0;
      for (int i = 1; i < nl; ++i) {
        const T xi = col[i * ld] - t * a[i * ld];
        col[i * ld] = xi;
        if (i == 1) d0 = xi;
        else tail += xi * xi;
      }
    }
    if (c < n) {
      const T cnc = P.cn[c] - prow * prow;
      P.cn[c] = cnc;
      if (beats(cnc, q, mine.cn, mine.pos)) {
        mine.cn = cnc;
        mine.live = d0 * d0 + tail;
        mine.tail = tail;
        mine.c0 = d0;
        mine.pos = q;
        mine.col = c;
      }
    }
  }
  publish_candidate(P.sc->best[(counter + 1) & 1], mine);
  // the column at the next free position, as the swap above leaves it
  // (its slot is written by this step only when qmin is that position)
  carry.c1 = ci + 1 < n ? (qmin == ci + 1 ? c1 : P.col_at[ci + 1]) : -1;
  ci += 1;
  __syncthreads();
  return true;
}

// After the level's last step: the pivot columns as the steps leave them
// (below the diagonal, the essential part a / denom of each step's
// reflection vector), which can only be written once no step reads the raw
// columns any more; all of them at once, every thread a few entries.  fc
// is the level's first position and `steps` the number of accepted steps.
// Ends with a barrier, so that every thread sees the level as factorized.
template <typename T>
__device__ __forceinline__ void panel_finish(const Panel<T>& P, int fc, int steps) {
  for (int idx = threadIdx.x; idx < steps * P.dim; idx += blockDim.x) {
    const int j = idx / P.dim, r = idx - j * P.dim;
    if (r > j) P.blk[r * P.ld + P.col_at[fc + j]] /= P.den[j];
  }
  __syncthreads();
}

}  // namespace lexls
