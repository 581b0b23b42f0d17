// Kernel B2: the whole active-set solve of each instance in one kernel.
//
// Replaces the Pallas TPU kernel lexls_tpu/ops/fused.py::fused_active_set
// (pl.pallas_call at fused.py:966; body _fused_kernel, fused.py:182-769):
// general levels with an optional simple-bounds level (d0 > 0), the
// iter_cap/it0 pause and resume, and the export of the last factorization
// (per-level R in pivot order, positions, ranks), the working-set log and
// cycling handling.
//
// What bounds it on the H100: one thread block (128 threads) per instance
// loops over active-set iterations until its own instance terminates (the
// TPU kernel ran a tile of instances in lock step and waited for the
// tile's slowest), and every block of a batch is resident at once, so a
// call takes as long as its longest instance.  An iteration is a chain of
// small dependent stages (about 120 pivot steps at the bench shape, then
// the Gauss, substitution and multiplier stages) run by the four warps of
// one block, three or four blocks to an SM: the kernel is bound by the
// latency of that chain and by the instructions its few warps can issue in
// order, neither by bytes nor by operations, so that the more blocks an SM
// holds at once, the more instances advance together.  In float32 the launch
// bound asks for four blocks (128 registers a thread) and the layout's
// bytes fit four blocks of the bench shape; the register-tiled stages are
// sized for that cap (kChunk, and the pivot step's column update holds at
// most 16 rows of the pivot column), since spilling or serializing there
// would cost a block more than the fourth block gains.  The design
// therefore shortens the chain's links and leaves nothing to a single warp
// that four can do:
//  * the instance's state lives in shared memory for the length of the
//    call: the masked subproblem (LOD), taus, column norms, the
//    permutation, multipliers, and x, v, Ax, the step and the working set.
//    The kernel reads the caller's state once at entry and writes its own
//    outputs once at exit; no input is written.  What an iteration reads
//    once a row at most stays in device memory: the bounds (copied to
//    their outputs at entry and relaxed there when cycling handling is on)
//    and the stamps (copied to their output at entry and updated there).
//    The wrapper computes the layout (ops/fused.py::fused_layout) and hands
//    the kernel the byte offsets.  The LOD's row stride is odd, so a walk
//    along a row and a gather down a column both touch 32 different banks.
//    Where the state does not fit the 227 KB a thread block may use, the
//    LOD alone stays in device memory (`work`): the kernel is compiled for
//    either place, so that the compiler knows the address space of every
//    access (a pointer that may be either costs every load twice);
//  * A is read from device memory (it stays in L2) when an iteration builds
//    the LOD, by asynchronous copies of the active rows that are all in
//    flight at once, and when it forms A dx, four rows to a warp at a time;
//  * a pivot step is one block-wide barrier on shared memory
//    (panel_step.cuh);
//  * the factorization runs in a function of its own (not inlined), so that
//    its register-tiled stages do not compete for registers with the state
//    the rest of the iteration keeps live;
//  * the Gauss elimination of the rows below a level writes each
//    multiplier straight into its pivot column (no separate L buffer):
//    first one thread per row sweeps the pivot columns with the row's
//    values in registers and R read as broadcasts, then every thread takes
//    a trailing column with its R values in registers and a share of the
//    rows, and reads the multipliers as broadcasts: one shared-memory load
//    for every multiply-add.  A row that is not in the working set is zero
//    and is skipped;
//  * the backward substitution keeps a level's vector in the lanes of one
//    warp and passes each solved entry by shuffle; the λ replay keeps a
//    level's multipliers in the lanes likewise;
//  * the ratio test and the removal selection are one block reduction
//    over (value, key) pairs each.
// Reflection vectors for the λ replay are read back from the pivot columns
// of the LOD (where the panel step leaves their essential parts).  Nothing
// after the factorization writes the LOD, so the factor export reads it
// once, after the instance's last iteration of the call; a block whose
// instance is not alive on entry (parked by the caller) copies its state
// through, writes the empty export and exits.
// Simple bounds: the first d0 rows of A are unit rows whose active ones fix
// their variables; the LOD holds the general rows only, with the fixed
// columns zeroed and their values folded into the rhs by plain indexing
// through var_idx, and the multipliers of the fixed variables land on the
// bound rows of the (p, m) multiplier table that the selection scans.
// Working-set log and cycling handling (run-time options, so that one
// compiled kernel serves every caller): what an iteration changed (row,
// type, step length or multiplier, total rank) is known identically to
// every thread, so thread 0 appends the entry to the output log by plain
// indexing at log_len (the block copies the incoming log there at entry)
// and relaxes the one bound of a detected cycle in its output.  The log
// length and the detector's four integers are instance scalars like the
// counters.
//
// Stages per iteration (fused.py line numbers): formLexLSE masking
// (278-327, fixed variables 291-319), per-level panel loop (335-411), Gauss
// elimination of the lower rows with L stored in the pivot columns
// (433-455), backward substitution (479-498, fixed values 497-498), step
// (511-517), ratio test (150-174), λ sweep by Householder replay
// j = K-1..0 (532-583), removal selection with both strategies and
// CORRECT_SIGN marking (585-648, multipliers of fixed variables 598-609),
// working-set update and counters (650-677), pause at iter_cap (262-268),
// factor export (457-475), working-set log (679-704), cycling handling
// (706-746).
#include <cuda_runtime.h>

#include <cmath>

#include "panel_step.cuh"
#include "shared_config.cuh"

namespace lexls {

constexpr int kFusedThreads = kStepWarps * kWarp;  // 128
// Pivot columns of a level that the Gauss stages hold in registers at a
// time: 16 in float32, where the launch bound leaves 128 registers a thread.
template <typename T>
constexpr int kChunk = sizeof(T) == 4 ? 16 : 32;
// The same for the forward sweep that computes the multipliers.
constexpr int kChunkL = 16;
// Rows that a warp works on together in the matrix-vector stages.
constexpr int kRows = 4;
constexpr int kInactive = 0, kActiveLb = 1, kActiveUb = 2, kActiveEq = 3;
// CORRECT_SIGN: a flag added to a row's type in ct while the removal
// selection runs; the working-set update takes it off again.
constexpr int kCorrectSign = 8;
constexpr int kUnknown = -1, kSolved = 0, kSolvedCycling = 1;
constexpr int kOpUndefined = 0, kOpAdd = 1, kOpRemove = 2;

// The entry's argument arrays, in the order of ops/fused.py's FUSED_INPUTS,
// FUSED_OUTPUTS, FUSED_INTS, FUSED_REALS and FUSED_REGIONS.
enum FusedInput {
  kInA, kInLb, kInUb, kInCt, kInSt, kInNs, kInX, kInV, kInAx, kInNf,
  kInIt0,                                      // null: zeros
  kInLobj, kInLctr, kInLtyp, kInLval, kInLrank, kInLcyc, kInLlen, kInLovf,  // null: empty log
  kInCcnt, kInCop, kInCrow, kInCtyp,           // null: the initial detector
  kInLvl, kInPrio, kInElig, kInVidx,
  kFusedInputs
};
enum FusedOutput {
  kOutX, kOutV, kOutAx, kOutDx, kOutDv, kOutAdx, kOutCt, kOutSt, kOutNs, kOutIt, kOutNa,
  kOutNd, kOutNf, kOutStatus, kOutRpad, kOutPosf, kOutRanks,
  kOutLb, kOutUb,                              // null unless cycling handling is on
  kOutLobj, kOutLctr, kOutLtyp, kOutLval, kOutLrank, kOutLcyc, kOutLlen, kOutLovf,
  kOutCcnt, kOutCop, kOutCrow, kOutCtyp,
  kOutWork,                                    // the LOD when it is not in shared memory
  kFusedOutputs
};
enum FusedInt {
  kIntB, kIntM, kIntN, kIntP, kIntD0, kIntKmax, kIntLd, kIntLodShared, kIntSmemBytes,
  kIntMaxFact, kIntDeactFirst, kIntIterCap, kIntLogCap, kIntCycling, kIntCycMax, kIntQuery,
  kFusedInts
};
enum FusedReal { kRealTolLd, kRealTolFeas, kRealTolWrong, kRealTolCorrect, kRealCycRelax,
                 kFusedReals };
enum FusedRegion {
  kRegLod, kRegHh, kRegCn, kRegU, kRegXdx, kRegLam, kRegRhsAll, kRegFval, kRegX, kRegV,
  kRegAx, kRegDv, kRegAdx, kRegRed, kRegStep,
  kRegPos, kRegColAt, kRegCt, kRegLvlFc, kRegLvlRank, kRegFmask,
  kFusedRegions
};

template <typename T>
struct FusedArgs {
  const void* in[kFusedInputs];
  void* out[kFusedOutputs];
  int off[kFusedRegions];
  int m, n, p, d0, kmax, ld;
  T tol_ld, tol_feas, tol_wrong, tol_correct;
  int max_fact, deact_first, iter_cap;
  int log_cap, cycling, cyc_max;
  T cyc_relax;
};

__device__ __forceinline__ bool is_active(int t) {
  return t == kActiveLb || t == kActiveUb || t == kActiveEq;
}

template <typename T>
__device__ __forceinline__ T rhs_of(int t, T lb, T ub) {
  return (t == kActiveUb || t == kActiveEq) ? ub : (t == kActiveLb ? lb : T(0));
}

// Instance b's part of a per-instance input or output array of `count`
// elements (null stays null).
template <typename E>
__device__ __forceinline__ E* slice(const void* base, int b, int count) {
  return base ? (E*)base + (size_t)b * count : nullptr;
}

// The block's dynamic shared memory; ops/fused.py::fused_layout places the
// regions.
extern __shared__ __align__(16) unsigned char smem[];

// What the factorization of one iteration needs, with the shared-memory
// regions as byte offsets so that the compiler still knows their address
// space inside a function that is not inlined.
template <typename T>
struct FactorCtx {
  T* lod_global;    // the LOD when it is not in shared memory
  const int* dims;  // (2, p) level sizes, then first rows
  int lod, hh, cn, u, pos, col_at, step, ct, lvl_fc, lvl_rank;
  int ld, n, p, mg, d0;
  T tol;
};

// Factorize the LOD level by level: the panel pivot loop, then the Gauss
// elimination of the rows below.  Returns the total rank.  Kept out of line:
// its register-tiled stages then do not compete for registers with the
// state that the rest of the iteration keeps live.
template <typename T, bool kLodShared>
__device__ __noinline__ int factorize(const FactorCtx<T> x) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = x.n, p = x.p, ld = x.ld, mg = x.mg;
  T* lod = kLodShared ? (T*)(smem + x.lod) : x.lod_global;
  int* col_at = (int*)(smem + x.col_at);
  const int* ct = (const int*)(smem + x.ct) + x.d0;  // types of the general rows
  int* lvl_fc = (int*)(smem + x.lvl_fc);
  int* lvl_rank = (int*)(smem + x.lvl_rank);
  const int* dims = x.dims;
  const int* offs = dims + p;

  int ci = 0;
  for (int k = 0; k < p; ++k) {
    const int dim = dims[k], fr = offs[k];
    const int fc = ci;
    if (dim > 0) {
      Panel<T> P;
      P.blk = lod + (size_t)fr * ld;
      P.ld = ld;
      P.dim = dim;
      P.n = n;
      P.cn = (T*)(smem + x.cn);
      P.pos = (int*)(smem + x.pos);
      P.col_at = col_at;
      P.rank_row = nullptr;
      P.hh = (T*)(smem + x.hh) + fr;
      P.den = (T*)(smem + x.u);  // free until the backward substitution
      P.sc = (StepScratch<T>*)(smem + x.step);
      P.fr = fr;
      P.tol = x.tol;
      StepCarry carry;
      panel_init_norms(P, ci, carry);
      __syncthreads();
      for (int counter = 0; counter < dim; ++counter)
        if (!panel_step<T, true>(P, counter, ci, carry)) break;
      panel_finish(P, fc, ci - fc);
    }
    // every thread holds fc and the rank; the copies are for later stages.
    // The pivot column of slot j of this level is col_at[fc + j]: positions
    // below ci never move again
    const int end = ci, rank = ci - fc;
    if (tid == 0) {
      lvl_fc[k] = fc;
      lvl_rank[k] = rank;
    }
    if (k == p - 1 || rank == 0) continue;

    // Gauss elimination of the rows below: L R = B by a forward column
    // sweep, one thread per row with the row's pivot-column values in
    // registers (chunks of kChunk columns); each multiplier goes straight
    // into its pivot column.  R(i, j) = Rrow[i * ld + cl[j]].  An inactive
    // row is zero and stays zero: it is skipped here and below
    const T* Rrow = lod + (size_t)fr * ld;
    const int* cl = col_at + fc;
    const int rb = fr + dim;  // first row below the level
    for (int r = rb + tid; r < mg; r += nt) {
      if (!is_active(ct[r])) continue;
      T* row = lod + (size_t)r * ld;
      for (int cb = 0; cb < rank; cb += kChunkL) {
        const int nc = rank - cb < kChunkL ? rank - cb : kChunkL;
        T w[kChunkL];
        int cc[kChunkL];  // this chunk's pivot columns
#pragma unroll
        for (int j = 0; j < kChunkL; ++j) {
          cc[j] = cl[cb + (j < nc ? j : 0)];
          w[j] = row[cc[j]];
        }
        // the multipliers of the chunks before this one
        for (int i = 0; i < cb; ++i) {
          const T li = row[cl[i]];
          const T* Ri = Rrow + i * ld;
#pragma unroll
          for (int j = 0; j < kChunkL; ++j) w[j] -= li * Ri[cc[j]];
        }
#pragma unroll
        for (int j = 0; j < kChunkL; ++j)
          if (j < nc) {
            const T* Rj = Rrow + (cb + j) * ld;
            const T rjj = Rj[cc[j]];
            w[j] = w[j] / (rjj != T(0) ? rjj : T(1));
#pragma unroll
            for (int j2 = j + 1; j2 < kChunkL; ++j2) w[j2] -= w[j] * Rj[cc[j2]];
          }
#pragma unroll
        for (int j = 0; j < kChunkL; ++j)
          if (j < nc) row[cc[j]] = w[j];
      }
    }
    __syncthreads();
    // trailing update below -= L [R T | rhs]: a thread takes one trailing
    // column (position >= end, or the rhs) with its R values in registers,
    // and every `groups`-th row below, in about four items a thread so
    // that the threads end together; the multipliers are read as broadcasts
    const int ncols = n - end + 1;
    int groups = (4 * nt) / ncols;
    if (groups < 1) groups = 1;
    for (int item = tid; item < ncols * groups; item += nt) {
      const int g = item / ncols, jc = item - g * ncols;
      const int c = jc < n - end ? col_at[end + jc] : n;
      for (int cb = 0; cb < rank; cb += kChunk<T>) {
        const int nc = rank - cb < kChunk<T> ? rank - cb : kChunk<T>;
        T Rc[kChunk<T>];
        int cc[kChunk<T>];  // this chunk's pivot columns
#pragma unroll
        for (int j = 0; j < kChunk<T>; ++j) {
          cc[j] = cl[cb + (j < nc ? j : 0)];
          Rc[j] = j < nc ? Rrow[(cb + j) * ld + c] : T(0);
        }
        for (int r = rb + g; r < mg; r += groups) {
          if (!is_active(ct[r])) continue;
          T* row = lod + (size_t)r * ld;
          T s = 0;
#pragma unroll
          for (int j = 0; j < kChunk<T>; ++j) s += row[cc[j]] * Rc[j];
          row[c] -= s;
        }
      }
    }
    __syncthreads();
  }
  __syncthreads();  // lvl_fc, lvl_rank and the last level's writes
  return ci;
}

// 4- or 8-byte asynchronous copy from device to shared memory.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst_shared, const T* src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(dst_shared);
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst), "l"(src) : "memory");
}

// kLodShared: the LOD lives in shared memory (the compiler then knows the
// address space of every access to it), else in `work`.
template <typename T, bool kLodShared>
__global__ void __launch_bounds__(kFusedThreads, sizeof(T) == 8 ? 2 : 4)
    fused_kernel(FusedArgs<T> a) {
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % kWarp, wid = tid / kWarp, nw = nt / kWarp;
  const int m = a.m, n = a.n, p = a.p, ld = a.ld, kmax = a.kmax;
  const int d0 = a.d0, mg = m - d0;  // rows < d0 are simple bounds
  const T inf = T(INFINITY);

  const T* A = slice<const T>(a.in[kInA], b, m * n);
  const T* Ag = A + (size_t)d0 * n;  // general rows of A
  const int* dims = (const int*)a.in[kInLvl];
  const int* offs = dims + p;
  const int* prio = (const int*)a.in[kInPrio];
  const int* elig = (const int*)a.in[kInElig];
  const int* vidx = (const int*)a.in[kInVidx];

  // (mg, ld) masked subproblem: shared memory, or this instance's part of `work`
  T* lod = kLodShared ? (T*)(smem + a.off[kRegLod])
                      : (T*)a.out[kOutWork] + (size_t)b * mg * ld;
  T* hh = (T*)(smem + a.off[kRegHh]);          // (mg) taus
  T* cn = (T*)(smem + a.off[kRegCn]);          // (n) column norms
  T* u = (T*)(smem + a.off[kRegU]);            // (dmax) step denominators, then backsub's vector
  T* xdx = (T*)(smem + a.off[kRegXdx]);        // (n) basic solution, then the step dx
  T* lam = (T*)(smem + a.off[kRegLam]);        // (p, m) multipliers, all rows
  T* rhs_all = (T*)(smem + a.off[kRegRhsAll]); // (p-1, n) λ back-propagation of objectives 1..
  T* fval = (T*)(smem + a.off[kRegFval]);      // (n) values of the fixed variables (d0 > 0)
  T* x = (T*)(smem + a.off[kRegX]);            // (n)
  T* v = (T*)(smem + a.off[kRegV]);            // (m)
  T* Ax = (T*)(smem + a.off[kRegAx]);          // (m)
  T* dv = (T*)(smem + a.off[kRegDv]);          // (m)
  T* Adx = (T*)(smem + a.off[kRegAdx]);        // (m)
  void* red = smem + a.off[kRegRed];           // block_min_pair's scratch
  StepScratch<T>* sc = (StepScratch<T>*)(smem + a.off[kRegStep]);
  int* pos = (int*)(smem + a.off[kRegPos]);        // (n) column -> position
  int* col_at = (int*)(smem + a.off[kRegColAt]);   // (n) position -> column
  int* ct = (int*)(smem + a.off[kRegCt]);          // (m) working set
  int* lvl_fc = (int*)(smem + a.off[kRegLvlFc]);   // (p) first position of each level
  int* lvl_rank = (int*)(smem + a.off[kRegLvlRank]);  // (p) rank of each level
  int* fmask = (int*)(smem + a.off[kRegFmask]);    // (n) 1 where the variable is fixed (d0 > 0)

  // (m) in device memory: the bounds, read in place unless cycling handling
  // may relax them (their outputs exist), and the stamps, in their output
  const bool relaxable = a.out[kOutLb] != nullptr;
  T* lb = relaxable ? slice<T>(a.out[kOutLb], b, m) : (T*)slice<const T>(a.in[kInLb], b, m);
  T* ub = relaxable ? slice<T>(a.out[kOutUb], b, m) : (T*)slice<const T>(a.in[kInUb], b, m);
  int* st = slice<int>(a.out[kOutSt], b, m);

  // ---- entry: the caller's state into shared memory (and the stamps and
  // relaxable bounds into their outputs)
  {
    const T* gx = slice<const T>(a.in[kInX], b, n);
    const T* gv = slice<const T>(a.in[kInV], b, m);
    const T* gAx = slice<const T>(a.in[kInAx], b, m);
    const T* glb = slice<const T>(a.in[kInLb], b, m);
    const T* gub = slice<const T>(a.in[kInUb], b, m);
    const int* gct = slice<const int>(a.in[kInCt], b, m);
    const int* gst = slice<const int>(a.in[kInSt], b, m);
    for (int c = tid; c < n; c += nt) {
      x[c] = gx[c];
      xdx[c] = T(0);
    }
    for (int i = tid; i < m; i += nt) {
      v[i] = gv[i];
      Ax[i] = gAx[i];
      if (relaxable) {
        lb[i] = glb[i];
        ub[i] = gub[i];
      }
      ct[i] = gct[i];
      st[i] = gst[i];
      dv[i] = Adx[i] = T(0);
    }
  }
  int* lobj = slice<int>(a.out[kOutLobj], b, a.log_cap);
  int* lctr = slice<int>(a.out[kOutLctr], b, a.log_cap);
  int* ltyp = slice<int>(a.out[kOutLtyp], b, a.log_cap);
  T* lval = slice<T>(a.out[kOutLval], b, a.log_cap);
  int* lrank = slice<int>(a.out[kOutLrank], b, a.log_cap);
  int* lcyc = slice<int>(a.out[kOutLcyc], b, a.log_cap);
  if (a.log_cap > 0) {
    // the incoming log (or an empty one) into the output log
    const int* iobj = slice<const int>(a.in[kInLobj], b, a.log_cap);
    const int* ictr = slice<const int>(a.in[kInLctr], b, a.log_cap);
    const int* ityp = slice<const int>(a.in[kInLtyp], b, a.log_cap);
    const T* ival = slice<const T>(a.in[kInLval], b, a.log_cap);
    const int* irank = slice<const int>(a.in[kInLrank], b, a.log_cap);
    const int* icyc = slice<const int>(a.in[kInLcyc], b, a.log_cap);
    for (int e = tid; e < a.log_cap; e += nt) {
      lobj[e] = iobj ? iobj[e] : 0;
      lctr[e] = ictr ? ictr[e] : 0;
      ltyp[e] = ityp ? ityp[e] : 0;
      lval[e] = ival ? ival[e] : T(0);
      lrank[e] = irank ? irank[e] : 0;
      lcyc[e] = icyc ? icyc[e] : 0;
    }
  }

  // instance scalars, held identically by every thread
  const int it0 = a.in[kInIt0] ? ((const int*)a.in[kInIt0])[b] : 0;
  int ns = ((const int*)a.in[kInNs])[b], nf = ((const int*)a.in[kInNf])[b];
  int it = it0, na = 0, nd = 0, status = kUnknown;
  int llen = 0, lovf = 0, ccnt = 0, cop = kOpUndefined, crow = -1, ctypv = -1;
  if (a.in[kInLlen]) llen = ((const int*)a.in[kInLlen])[b];
  if (a.in[kInLovf]) lovf = ((const int*)a.in[kInLovf])[b];
  if (a.in[kInCcnt]) {
    ccnt = ((const int*)a.in[kInCcnt])[b];
    cop = ((const int*)a.in[kInCop])[b];
    crow = ((const int*)a.in[kInCrow])[b];
    ctypv = ((const int*)a.in[kInCtyp])[b];
  }
  __syncthreads();

  // alive: not terminated, within the factorization budget, and (with
  // iter_cap) not yet paused; a paused instance keeps status UNKNOWN
  while (status == kUnknown && (it == 0 || nf < a.max_fact) &&
         (a.iter_cap == 0 || it < it0 + a.iter_cap)) {
    // ---- masked LexLSE subproblem: inactive rows are zero; active bound
    // rows fix their variables (columns zeroed, values folded into the rhs)
    if (d0 > 0) {
      for (int c = tid; c < n; c += nt) {
        fmask[c] = 0;
        fval[c] = T(0);
      }
      __syncthreads();
      for (int r = tid; r < d0; r += nt) {
        const int t = ct[r];
        if (is_active(t)) {
          fmask[vidx[r]] = 1;
          fval[vidx[r]] = rhs_of(t, lb[r], ub[r]);
        }
      }
      __syncthreads();
    }
    // one warp per general row, lanes along the row: an inactive row is
    // zero, an active one is copied from A (asynchronously, every row's
    // copies in flight at once, when the LOD is in shared memory)
    for (int i = wid; i < mg; i += nw) {
      const int t = ct[d0 + i];
      const bool act = is_active(t);
      const T* Ai = Ag + (size_t)i * n;
      T* row = lod + (size_t)i * ld;
      for (int c = lane; c < n; c += kWarp) {
        if (!act) row[c] = T(0);
        else if (kLodShared) copy_async(row + c, Ai + c);
        else row[c] = Ai[c];
      }
      if (d0 == 0 && lane == 0) row[n] = act ? rhs_of(t, lb[i], ub[i]) : T(0);
    }
    for (int c = tid; c < n; c += nt) pos[c] = col_at[c] = c;
    for (int i = tid; i < mg; i += nt) hh[i] = T(0);
    if (kLodShared) asm volatile("cp.async.wait_all;" ::: "memory");
    if (d0 > 0) {
      // fixed variables leave their columns (zeroed) for the rhs:
      // rhs = bound - A_g fixed_val.  Each warp finishes the rows it copied
      __syncwarp();
      for (int i = wid; i < mg; i += nw) {
        const int t = ct[d0 + i];
        const bool act = is_active(t);
        T* row = lod + (size_t)i * ld;
        T s = 0;
        if (act) {
          for (int c = lane; c < n; c += kWarp)
            if (fmask[c]) {
              s += row[c] * fval[c];
              row[c] = T(0);
            }
          s = warp_sum(s);
        }
        if (lane == 0) row[n] = act ? rhs_of(t, lb[d0 + i], ub[d0 + i]) - s : T(0);
      }
    }
    __syncthreads();

    // ---- factorize level by level
    FactorCtx<T> fx;
    fx.lod_global = kLodShared ? nullptr : lod;
    fx.dims = dims;
    fx.lod = a.off[kRegLod];
    fx.hh = a.off[kRegHh];
    fx.cn = a.off[kRegCn];
    fx.u = a.off[kRegU];
    fx.pos = a.off[kRegPos];
    fx.col_at = a.off[kRegColAt];
    fx.step = a.off[kRegStep];
    fx.ct = a.off[kRegCt];
    fx.lvl_fc = a.off[kRegLvlFc];
    fx.lvl_rank = a.off[kRegLvlRank];
    fx.ld = ld;
    fx.n = n;
    fx.p = p;
    fx.mg = mg;
    fx.d0 = d0;
    fx.tol = a.tol_ld;
    const int total_rank = factorize<T, kLodShared>(fx);  // sum of the level ranks

    // ---- basic solve: backward substitution per level, free vars = 0
    for (int c = tid; c < n; c += nt) xdx[c] = T(0);
    __syncthreads();
    for (int k = p - 1; k >= 0; --k) {
      const int rank = lvl_rank[k];
      if (rank == 0) continue;
      const int fc = lvl_fc[k], end = fc + rank, fr = offs[k];
      const int* cl = col_at + fc;
      const T* Rrow = lod + (size_t)fr * ld;
      // u = rhs - R T x over the columns of the levels below (pos >= end):
      // a warp takes kRows rows at a time, so that their loads and their
      // shuffle sums overlap
      for (int i0 = wid * kRows; i0 < rank; i0 += nw * kRows) {
        T s[kRows];
#pragma unroll
        for (int q = 0; q < kRows; ++q) s[q] = 0;
        for (int c = lane; c < n; c += kWarp) {
          if (pos[c] < end) continue;
          const T xc = xdx[c];
#pragma unroll
          for (int q = 0; q < kRows; ++q)
            if (i0 + q < rank) s[q] += Rrow[(i0 + q) * ld + c] * xc;
        }
#pragma unroll
        for (int q = 0; q < kRows; ++q) s[q] = warp_sum(s[q]);
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          if (lane == q && i0 + q < rank) u[i0 + q] = Rrow[(i0 + q) * ld + n] - s[q];
      }
      __syncthreads();
      // triu(R) y = u by warp 0, kWarp rows at a time from the bottom: lane
      // i holds u_i in a register and y_j travels by shuffle; then the rows
      // above take the chunk's y out of their u
      if (wid == 0) {
        for (int cb = ((rank - 1) / kWarp) * kWarp; cb >= 0; cb -= kWarp) {
          const int nc = rank - cb < kWarp ? rank - cb : kWarp;
          const int i = cb + lane;
          T ui = lane < nc ? u[i] : T(0);
          // lane j brings column j and its diagonal entry
          const int cmine = cl[cb + (lane < nc ? lane : 0)];
          const T dmine = Rrow[(cb + (lane < nc ? lane : 0)) * ld + cmine];
          for (int j = nc - 1; j >= 0; --j) {
            const int cj = __shfl_sync(kFullMask, cmine, j);
            const T rjj = __shfl_sync(kFullMask, dmine, j);
            const T rij = lane < j ? Rrow[i * ld + cj] : T(0);
            const T yj = __shfl_sync(kFullMask, ui, j) / (rjj != T(0) ? rjj : T(1));
            if (lane == j) ui = yj;
            else if (lane < j) ui -= yj * rij;
          }
          if (lane < nc) u[i] = ui;
          __syncwarp();
          for (int i2 = lane; i2 < cb; i2 += kWarp) {
            T acc = u[i2];
            for (int j = nc - 1; j >= 0; --j) acc -= u[cb + j] * Rrow[i2 * ld + cl[cb + j]];
            u[i2] = acc;
          }
          __syncwarp();
        }
      }
      __syncthreads();
      for (int j = tid; j < rank; j += nt) xdx[cl[j]] += u[j];
      __syncthreads();
    }

    // ---- step (objective.h:288-338); fixed variables take their values
    for (int c = tid; c < n; c += nt) {
      const T xv = (d0 > 0 && fmask[c]) ? fval[c] : xdx[c];
      xdx[c] = xv - x[c];
    }
    __syncthreads();
    const T* dx = xdx;
    // A dx, a warp on kRows rows of A at a time (their loads from device
    // memory in flight together)
    for (int i0 = wid * kRows; i0 < m; i0 += nw * kRows) {
      T s[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) s[q] = 0;
      for (int c = lane; c < n; c += kWarp) {
        const T dxc = dx[c];
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const int i = i0 + q < m ? i0 + q : m - 1;
          s[q] += A[(size_t)i * n + c] * dxc;
        }
      }
#pragma unroll
      for (int q = 0; q < kRows; ++q) s[q] = warp_sum(s[q]);
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int i = i0 + q;
        if (lane == q && i < m) {
          const int t = ct[i];
          Adx[i] = s[q];
          dv[i] = -v[i] + (is_active(t) ? Ax[i] + s[q] - rhs_of(t, lb[i], ub[i]) : T(0));
        }
      }
    }
    __syncthreads();

    // ---- ratio test over inactive rows; the first minimum wins
    T amin = inf;
    long long bkey = LLONG_MAX;
    for (int i = tid; i < m; i += nt) {
      const T den = Adx[i] - dv[i];
      const bool neg = den < -a.tol_feas, posd = den > a.tol_feas;
      if (ct[i] == kInactive && (neg || posd)) {
        T r = ((neg ? lb[i] : ub[i]) - Ax[i] + v[i]) / den;
        r = r < T(0) ? T(0) : r;
        if (r < inf) take_min_pair(amin, bkey, r, (long long)i);
      }
    }
    block_min_pair(amin, bkey, red);
    const int brow = bkey == LLONG_MAX ? INT_MAX : (int)bkey;
    const bool blocking = amin < T(1) && brow < m;
    const T alpha = blocking ? amin : T(1);
    int btype = kInactive;
    if (blocking) btype = (Adx[brow] - dv[brow] < -a.tol_feas) ? kActiveLb : kActiveUb;

    // ---- λ sweep and removal selection, when nothing blocks
    bool found = false;
    int sel_row = -1;
    T sel_val = T(0);  // the selected multiplier, for the log (0 under deact_first)
    if (!blocking) {
      for (int idx = tid; idx < (p - 1) * n; idx += nt) rhs_all[idx] = T(0);
      __syncthreads();
      for (int k = p - 1; k >= 0; --k) {
        const int dim = dims[k];
        if (dim == 0) continue;
        const int fr = offs[k], rank = lvl_rank[k], fc = lvl_fc[k];
        const int* cl = col_at + fc;
        const T* Lv = lod + (size_t)fr * ld;
        for (int idx = tid; idx < p * dim; idx += nt) {
          const int jp = idx / dim, r = idx - jp * dim;
          T s = T(0);
          if (jp == k) s = r >= rank ? -Lv[r * ld + n] : T(0);
          else if (jp > k && r < rank) s = rhs_all[(jp - 1) * n + cl[r]];
          lam[jp * m + d0 + fr + r] = s;
        }
        __syncthreads();
        // S <- S Q^T, Householder replay j = K-1..0, one warp per objective
        for (int jp = k + wid; jp < p; jp += nw) {
          T* S = lam + jp * m + d0 + fr;
          if (dim <= kWarp) {
            // lane r holds S_r in a register
            T sr = lane < dim ? S[lane] : T(0);
            for (int j = rank - 1; j >= 0; --j) {
              const T tau = hh[fr + j];
              if (tau == T(0)) continue;
              const T vr = lane == j ? T(1) : (lane > j && lane < dim ? Lv[lane * ld + cl[j]] : T(0));
              const T t = tau * warp_sum(sr * vr);
              sr -= t * vr;
            }
            if (lane < dim) S[lane] = sr;
            continue;
          }
          for (int j = rank - 1; j >= 0; --j) {
            const T tau = hh[fr + j];
            if (tau == T(0)) continue;
            const int cj = cl[j];
            T s = 0;
            for (int r = j + lane; r < dim; r += kWarp)
              s += S[r] * (r == j ? T(1) : Lv[r * ld + cj]);
            const T t = tau * warp_sum(s);
            for (int r = j + lane; r < dim; r += kWarp)
              S[r] -= t * (r == j ? T(1) : Lv[r * ld + cj]);
            __syncwarp();
          }
        }
        __syncthreads();
        // back-propagate into the columns of higher levels (pos < fc),
        // through the L rows stored in their pivot columns; objective 0's
        // back-propagation is never read
        const int jp0 = k > 1 ? k : 1;
        for (int idx = tid; idx < (p - jp0) * n; idx += nt) {
          const int jp = jp0 + idx / n, c = idx % n;
          if (pos[c] >= fc) continue;
          const T* S = lam + jp * m + d0 + fr;
          T s = 0;
          for (int r = 0; r < dim; ++r) s += S[r] * Lv[r * ld + c];
          rhs_all[(jp - 1) * n + c] -= s;
        }
        __syncthreads();
      }
      if (d0 > 0) {
        // multipliers of the fixed variables, -A_g^T λ_j over the active
        // general rows (lexlse.h:591-601), on their bound rows
        for (int idx = tid; idx < p * d0; idx += nt) {
          const int jp = idx / d0, r = idx - jp * d0;
          T s = T(0);
          if (is_active(ct[r])) {
            const int c = vidx[r];
            const T* S = lam + jp * m + d0;
            for (int i = 0; i < mg; ++i)
              if (is_active(ct[d0 + i])) s -= Ag[(size_t)i * n + c] * S[i];
          }
          lam[jp * m + r] = s;
        }
        __syncthreads();
      }

      // removal selection: the first objective with a wrong-sign
      // multiplier commits; CORRECT_SIGN marks (on ct, by the thread that
      // owns the row) only affect later ones.  One reduction per objective
      // over (value, key) pairs: the oldest stamp, ties to the smallest row
      // (deact_first), or the smallest multiplier, ties to the smallest
      // visit priority, then row
      for (int j = 0; j < p && !found; ++j) {
        T bv = inf;
        long long bk = LLONG_MAX;
        for (int i = tid; i < m; i += nt) {
          const T val = lam[j * m + i];
          const int t = ct[i];  // a marked row is not considered, so its sign is not read
          const T ai = t == kActiveLb ? -val : val;
          const bool consider = elig[j * m + i] != 0 && (t == kActiveLb || t == kActiveUb);
          if (consider && ai > a.tol_correct) ct[i] = t + kCorrectSign;
          if (consider && ai < -a.tol_wrong) {
            if (a.deact_first) take_min_pair(bv, bk, T(0), ((long long)st[i] << 32) | (long long)i);
            else take_min_pair(bv, bk, ai, ((long long)prio[j * m + i] << 32) | (long long)i);
          }
        }
        block_min_pair(bv, bk, red);
        if (bk != LLONG_MAX) {
          found = true;
          sel_row = (int)(bk & 0xffffffffLL);
          sel_val = a.deact_first ? T(0) : bv;
        }
      }
    }
    const bool do_remove = !blocking && found;
    const bool solved = !blocking && !found;
    // the type the removed row had, read before the update overwrites it
    const int rm_type = do_remove ? ct[sel_row] % kCorrectSign : -1;

    // ---- working-set update (CORRECT_SIGN marks off), step, counters
    __syncthreads();
    for (int i = tid; i < m; i += nt) {
      if (blocking && i == brow) {
        ct[i] = btype;
        st[i] = ns;
      } else if (do_remove && i == sel_row) {
        ct[i] = kInactive;
        st[i] = -1;
      } else if (ct[i] >= kCorrectSign) {
        ct[i] -= kCorrectSign;
      }
    }
    const T afl = alpha > T(0) ? alpha : T(0);
    for (int c = tid; c < n; c += nt) x[c] += afl * dx[c];
    for (int i = tid; i < m; i += nt) {
      v[i] += afl * dv[i];
      Ax[i] += afl * Adx[i];
    }
    ns += blocking;
    if (solved) status = kSolved;
    nf += it > 0;
    it += 1;
    na += blocking;
    nd += do_remove;

    // ---- working-set log: one entry per change; a full log drops it
    if (a.log_cap > 0 && (blocking || do_remove)) {
      if (llen < a.log_cap) {
        if (tid == 0) {
          const int row = blocking ? brow : sel_row;
          int obj = 0, rin = row;  // a bound row: objective 0
          if (row >= d0) {
            int k = 0;
            while (k < p - 1 && row - d0 >= offs[k] + dims[k]) ++k;
            obj = k + (d0 > 0);
            rin = row - d0 - offs[k];
          }
          lobj[llen] = obj;
          lctr[llen] = rin;
          ltyp[llen] = blocking ? btype : kInactive;
          lval[llen] = blocking ? alpha : sel_val;
          lrank[llen] = total_rank;
        }
        llen += 1;
      } else {
        lovf = 1;
      }
    }

    // ---- cycling handling: an ADD of the (row, type) that the previous
    // operation removed relaxes that bound, or past cyc_max detections ends
    // the solve
    if (a.cycling && (blocking || do_remove)) {
      const int op = blocking ? kOpAdd : kOpRemove;
      const int row = blocking ? brow : sel_row;
      const int typ = blocking ? btype : rm_type;
      if (op == kOpAdd && cop == kOpRemove && row == crow && typ == ctypv) {
        if (ccnt >= a.cyc_max) {
          status = kSolvedCycling;
        } else {
          if (tid == 0) {
            if (ctypv == kActiveLb) lb[crow] -= a.cyc_relax;
            else if (ctypv == kActiveUb) ub[crow] += a.cyc_relax;
            if (a.log_cap > 0) lcyc[llen - 1 < 0 ? 0 : llen - 1] = 1;
          }
          ccnt += 1;
        }
      }
      cop = op;
      crow = row;
      ctypv = typ;
    }
    __syncthreads();
  }

  // ---- export the factorization of the last iteration this call ran:
  // rpad[k][i][j] = row fr+i of the LOD at the physical column whose
  // position is fc+j (zero at or past the rank), the positions, the ranks;
  // zeros / identity positions / zeros when no iteration ran
  const bool ran = it > it0;
  T* rpad = slice<T>(a.out[kOutRpad], b, p * kmax * kmax);
  for (int idx = tid; idx < p * kmax * kmax; idx += nt) {
    const int k = idx / (kmax * kmax), rem = idx - k * kmax * kmax;
    const int i = rem / kmax, j = rem - i * kmax;
    T val = T(0);
    if (ran) {
      const int rank = lvl_rank[k];
      if (i < rank && j < rank) val = lod[(size_t)(offs[k] + i) * ld + col_at[lvl_fc[k] + j]];
    }
    rpad[idx] = val;
  }
  int* posf = slice<int>(a.out[kOutPosf], b, n);
  int* ranks = slice<int>(a.out[kOutRanks], b, p);
  for (int c = tid; c < n; c += nt) posf[c] = ran ? pos[c] : c;
  for (int k = tid; k < p; k += nt) ranks[k] = ran ? lvl_rank[k] : 0;

  // ---- exit: the state into the output tensors
  {
    T* gx = slice<T>(a.out[kOutX], b, n);
    T* gdx = slice<T>(a.out[kOutDx], b, n);
    T* gv = slice<T>(a.out[kOutV], b, m);
    T* gAx = slice<T>(a.out[kOutAx], b, m);
    T* gdv = slice<T>(a.out[kOutDv], b, m);
    T* gAdx = slice<T>(a.out[kOutAdx], b, m);
    int* gct = slice<int>(a.out[kOutCt], b, m);
    for (int c = tid; c < n; c += nt) {
      gx[c] = x[c];
      gdx[c] = xdx[c];
    }
    for (int i = tid; i < m; i += nt) {
      gv[i] = v[i];
      gAx[i] = Ax[i];
      gdv[i] = dv[i];
      gAdx[i] = Adx[i];
      gct[i] = ct[i];
    }
  }
  if (tid == 0) {
    ((int*)a.out[kOutNs])[b] = ns;
    ((int*)a.out[kOutNf])[b] = nf;
    ((int*)a.out[kOutIt])[b] = it;
    ((int*)a.out[kOutNa])[b] = na;
    ((int*)a.out[kOutNd])[b] = nd;
    ((int*)a.out[kOutStatus])[b] = status;
    ((int*)a.out[kOutLlen])[b] = llen;
    ((int*)a.out[kOutLovf])[b] = lovf;
    ((int*)a.out[kOutCcnt])[b] = ccnt;
    ((int*)a.out[kOutCop])[b] = cop;
    ((int*)a.out[kOutCrow])[b] = crow;
    ((int*)a.out[kOutCtyp])[b] = ctypv;
  }
}

// What ints[kIntQuery] asks of the kernel instead of a launch.
enum FusedQuery { kQueryNone, kQueryBlocksPerSm, kQueryRegs, kQueryLocalBytes };

// `in`, `out`, `off`, `ints` and `reals` are host arrays in the order of
// the enums above.  With ints[kIntQuery] != kQueryNone nothing is
// launched: the entry returns the resident blocks per SM at this
// shared-memory size, or the registers or the local-memory bytes a thread
// of the kernel (or minus the CUDA error).
template <typename T, bool kLodShared>
int launch_fused(const FusedArgs<T>& a, int B, size_t smem_bytes, int query, cudaStream_t stream) {
  static size_t configured = 0;
  auto kernel = fused_kernel<T, kLodShared>;
  cudaError_t err = configure_shared(kernel, smem_bytes, configured);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return query ? -(int)err : (int)err;
  }
  if (query == kQueryBlocksPerSm) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kFusedThreads,
                                                        smem_bytes);
    return err == cudaSuccess ? blocks : -(int)err;
  }
  if (query) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return -(int)err;
    return query == kQueryRegs ? attr.numRegs : (int)attr.localSizeBytes;
  }
  if (B > 0) kernel<<<B, kFusedThreads, smem_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int fused_entry(const void* const* in, void* const* out, const int* off, const int* ints,
                const double* reals, void* stream) {
  FusedArgs<T> a;
  for (int i = 0; i < kFusedInputs; ++i) a.in[i] = in[i];
  for (int i = 0; i < kFusedOutputs; ++i) a.out[i] = out[i];
  for (int i = 0; i < kFusedRegions; ++i) a.off[i] = off[i];
  a.m = ints[kIntM];
  a.n = ints[kIntN];
  a.p = ints[kIntP];
  a.d0 = ints[kIntD0];
  a.kmax = ints[kIntKmax];
  a.ld = ints[kIntLd];
  a.tol_ld = (T)reals[kRealTolLd];
  a.tol_feas = (T)reals[kRealTolFeas];
  a.tol_wrong = (T)reals[kRealTolWrong];
  a.tol_correct = (T)reals[kRealTolCorrect];
  a.max_fact = ints[kIntMaxFact];
  a.deact_first = ints[kIntDeactFirst];
  a.iter_cap = ints[kIntIterCap];
  a.log_cap = ints[kIntLogCap];
  a.cycling = ints[kIntCycling];
  a.cyc_max = ints[kIntCycMax];
  a.cyc_relax = (T)reals[kRealCycRelax];
  const size_t smem_bytes = (size_t)ints[kIntSmemBytes];
  return ints[kIntLodShared]
             ? launch_fused<T, true>(a, ints[kIntB], smem_bytes, ints[kIntQuery],
                                     (cudaStream_t)stream)
             : launch_fused<T, false>(a, ints[kIntB], smem_bytes, ints[kIntQuery],
                                      (cudaStream_t)stream);
}

}  // namespace lexls

extern "C" {

int lexls_fused_active_set_f32(const void* const* in, void* const* out, const int* off,
                               const int* ints, const double* reals, void* stream) {
  return lexls::fused_entry<float>(in, out, off, ints, reals, stream);
}

int lexls_fused_active_set_f64(const void* const* in, void* const* out, const int* off,
                               const int* ints, const double* reals, void* stream) {
  return lexls::fused_entry<double>(in, out, off, ints, reals, stream);
}

}  // extern "C"
