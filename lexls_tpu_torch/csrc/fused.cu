// Kernel B2: the whole active-set solve of each instance in one kernel.
//
// Replaces the Pallas TPU kernel lexls_tpu/ops/fused.py::fused_active_set
// (pl.pallas_call at fused.py:966; body _fused_kernel, fused.py:182-769):
// general levels with an optional simple-bounds level (d0 > 0), the
// iter_cap/it0 pause and resume, and the export of the last factorization
// (per-level R in pivot order, positions, ranks), the working-set log and
// cycling handling.
//
// Design on the H100: one thread block (128 threads) per instance loops
// over active-set iterations until its own instance terminates; the TPU
// kernel ran a tile of instances in lock step and froze finished ones by
// predication, so it waited for the tile's slowest instance (and needed
// compaction to recover).  Per-instance state lives in device memory
// allocated by the wrapper (the masked LOD, taus, column norms, positions,
// multipliers, L rows) and stays in L1/L2 while the block works on it.
// An iteration is a chain of small dependent stages (about 120 pivot steps
// at the bench shape, each ending in block reductions), so the kernel is
// bound by barrier and reduction latency, not by bytes or FLOPs; many
// independent blocks per SM hide that latency.  Reflection vectors for
// the λ replay are read back from the pivot columns of the LOD (where the
// panel step leaves their essential parts) instead of being stored twice.
// Nothing after the factorization writes the LOD, so the factor export
// reads it once, after the instance's last iteration of the call, instead
// of on every iteration as the TPU tile did; a block whose instance is not
// alive on entry (parked by the caller) writes the empty export and exits.
// Simple bounds: the first d0 rows of A are unit rows whose active ones fix
// their variables; the LOD holds the general rows only, with the fixed
// columns zeroed and their values folded into the rhs by plain indexing
// through var_idx, and the multipliers of the fixed variables land on the
// bound rows of the (p, m) multiplier table that the selection scans.
// Working-set log and cycling handling (run-time options, so that one
// compiled kernel serves every caller): what an iteration changed (row,
// type, step length or multiplier, total rank) is known identically to
// every thread, so thread 0 appends the entry by plain indexing at log_len
// and relaxes the one bound of a detected cycle in place; the TPU tile
// wrote both through one-hot masks over the whole ring and the whole row.
// The log length and the detector's four integers are instance scalars
// like the counters; lb/ub are per-instance state under cycling (the
// wrapper hands the kernel its own copy), re-read by every iteration.
//
// Stages per iteration (fused.py line numbers): formLexLSE masking
// (278-327, fixed variables 291-319), per-level panel loop (335-411), Gauss elimination of the
// lower rows with L stored in the pivot columns (433-455), backward
// substitution (479-498, fixed values 497-498), step (511-517), ratio test (150-174), λ sweep by
// Householder replay j = K-1..0 (532-583), removal selection with both
// strategies and CORRECT_SIGN marking (585-648, multipliers of fixed
// variables 598-609), working-set update and counters (650-677), pause at
// iter_cap (262-268), factor export (457-475), working-set log (679-704),
// cycling handling (706-746).
#include <cuda_runtime.h>

#include <cmath>

#include "panel_step.cuh"

namespace lexls {

constexpr int kFusedThreads = 128;
constexpr int kInactive = 0, kActiveLb = 1, kActiveUb = 2, kActiveEq = 3, kCorrectSign = 4;
constexpr int kUnknown = -1, kSolved = 0, kSolvedCycling = 1;
constexpr int kOpUndefined = 0, kOpAdd = 1, kOpRemove = 2;

template <typename T>
struct FusedArgs {
  const T* A;
  T* lb;  // written only by cycling handling
  T* ub;
  int* ct;
  int* st;
  int* ns;
  T* x;
  T* v;
  T* Ax;
  int* nf;
  const int* it0;
  T* dx;
  T* dv;
  T* Adx;
  int* it;
  int* na;
  int* nd;
  int* status;
  T* rpad;          // (p, kmax, kmax) exported R per level, pivot order
  int* posf;        // (n) exported positions
  int* ranks;       // (p) exported ranks
  const int* lvl;   // (2, p): general level sizes, then first general rows
  const int* prio;  // (p, m) λ-sweep visit priority
  const int* elig;  // (p, m) λ-sweep eligibility
  const int* vidx;  // (d0) variable of each bound row
  T* work;
  int* iwork;
  // working-set log, (log_cap) per instance: objective, row within it,
  // type, value, total rank, cycling flag; then its length and overflow flag
  int* lobj;
  int* lctr;
  int* ltyp;
  T* lval;
  int* lrank;
  int* lcyc;
  int* llen;
  int* lovf;
  // cycling detector: counter, previous operation, row and type
  int* ccnt;
  int* cop;
  int* crow;
  int* ctypv;
  int m, n, p, d0, kmax, dmax;
  size_t wstride, iwstride;
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

template <typename T>
__global__ void __launch_bounds__(kFusedThreads) fused_kernel(FusedArgs<T> a) {
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % kWarp, wid = tid / kWarp, nw = nt / kWarp;
  const int m = a.m, n = a.n, p = a.p, ld = n + 1, kmax = a.kmax;
  const int d0 = a.d0, mg = m - d0;  // rows < d0 are simple bounds
  const T inf = T(INFINITY);

  const T* A = a.A + (size_t)b * m * n;
  T* lb = a.lb + (size_t)b * m;
  T* ub = a.ub + (size_t)b * m;
  int* ct = a.ct + (size_t)b * m;
  int* st = a.st + (size_t)b * m;
  T* x = a.x + (size_t)b * n;
  T* v = a.v + (size_t)b * m;
  T* Ax = a.Ax + (size_t)b * m;
  T* dx = a.dx + (size_t)b * n;
  T* dv = a.dv + (size_t)b * m;
  T* Adx = a.Adx + (size_t)b * m;

  const T* Ag = A + (size_t)d0 * n;          // general rows of A

  T* lod = a.work + (size_t)b * a.wstride;  // (mg, n+1) masked subproblem
  T* hh = lod + (size_t)mg * ld;            // (mg) taus
  T* cn = hh + mg;                          // (n) column norms
  T* u = cn + n;                            // (dmax) reflection / backsub vector
  T* xvar = u + a.dmax;                     // (n) basic solution
  T* lam = xvar + n;                        // (p, m) multipliers, all rows
  T* rhs_all = lam + (size_t)p * m;         // (p, n) λ back-propagation
  T* Lbuf = rhs_all + (size_t)p * n;        // (mg, kmax) Gauss multipliers per row
  T* fval = Lbuf + (size_t)mg * kmax;       // (n) values of the fixed variables
  int* pos = a.iwork + (size_t)b * a.iwstride;  // (n) column -> position
  int* colat = pos + n;                     // (p, kmax) pivot column per level slot
  int* sense = colat + p * kmax;            // (m) types with CORRECT_SIGN marks
  int* wrong = sense + m;                   // (m) wrong-sign flags of one objective
  int* lvl_fc = wrong + m;                  // (p) first position of each level
  int* lvl_rank = lvl_fc + p;               // (p) rank of each level
  int* fmask = lvl_rank + p;                // (n) 1 where the variable is fixed
  const int* dims = a.lvl;
  const int* offs = a.lvl + p;

  // instance scalars, held identically by every thread
  const int it0 = a.it0[b];
  int ns = a.ns[b], nf = a.nf[b], it = it0, na = 0, nd = 0, status = kUnknown;
  int llen = 0, lovf = 0, ccnt = 0, cop = kOpUndefined, crow = -1, ctypv = -1;
  if (a.log_cap > 0) {
    llen = a.llen[b];
    lovf = a.lovf[b];
  }
  if (a.cycling) {
    ccnt = a.ccnt[b];
    cop = a.cop[b];
    crow = a.crow[b];
    ctypv = a.ctypv[b];
  }
  for (int c = tid; c < n; c += nt) dx[c] = T(0);
  for (int i = tid; i < m; i += nt) dv[i] = Adx[i] = T(0);

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
          fmask[a.vidx[r]] = 1;
          fval[a.vidx[r]] = rhs_of(t, lb[r], ub[r]);
        }
      }
      __syncthreads();
    }
    for (int idx = tid; idx < mg * ld; idx += nt) {
      const int i = idx / ld, c = idx - i * ld;
      const int t = ct[d0 + i];
      T val = T(0);
      if (is_active(t)) {
        if (c < n) val = (d0 > 0 && fmask[c]) ? T(0) : Ag[(size_t)i * n + c];
        else val = rhs_of(t, lb[d0 + i], ub[d0 + i]);
      }
      lod[idx] = val;
    }
    for (int c = tid; c < n; c += nt) pos[c] = c;
    for (int i = tid; i < mg; i += nt) hh[i] = T(0);
    __syncthreads();
    if (d0 > 0) {
      // rhs -= A_g fixed_val, one warp per active general row
      for (int i = wid; i < mg; i += nw) {
        if (!is_active(ct[d0 + i])) continue;
        T s = 0;
        for (int c = lane; c < n; c += kWarp) s += Ag[(size_t)i * n + c] * fval[c];
        s = warp_sum(s);
        if (lane == 0) lod[(size_t)i * ld + n] -= s;
      }
      __syncthreads();
    }

    // ---- factorize level by level
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
        P.cn = cn;
        P.pos = pos;
        P.col_at = nullptr;
        P.rank_row = nullptr;
        P.hh = hh + fr;
        P.u = u;
        P.fr = fr;
        P.tol = a.tol_ld;
        panel_init_norms(P);
        __syncthreads();
        for (int counter = 0; counter < dim; ++counter)
          if (!panel_step<T, true>(P, counter, ci)) break;
      }
      const int end = ci, rank = ci - fc;
      int* cl = colat + k * kmax;
      for (int c = tid; c < n; c += nt) {
        const int q = pos[c];
        if (q >= fc && q < end) cl[q - fc] = c;
      }
      if (tid == 0) {
        lvl_fc[k] = fc;
        lvl_rank[k] = rank;
      }
      __syncthreads();
      if (k == p - 1 || rank == 0) continue;

      // Gauss elimination of the rows below: L R = B by a forward column
      // sweep, one thread per row
      const T* Rrow = lod + (size_t)fr * ld;  // R(i, j) = Rrow[i * ld + cl[j]]
      for (int r = fr + dim + tid; r < mg; r += nt) {
        T* Lr = Lbuf + (size_t)r * kmax;
        for (int j = 0; j < rank; ++j) {
          const int cj = cl[j];
          T wj = lod[(size_t)r * ld + cj];
          for (int i = 0; i < j; ++i) wj -= Lr[i] * Rrow[i * ld + cj];
          const T rjj = Rrow[j * ld + cj];
          Lr[j] = wj / (rjj != T(0) ? rjj : T(1));
        }
      }
      __syncthreads();
      // trailing update below - L [R T | rhs], and L into the pivot columns
      for (int r = fr + dim; r < mg; ++r) {
        const T* Lr = Lbuf + (size_t)r * kmax;
        for (int c = tid; c <= n; c += nt) {
          if (c < n) {
            const int q = pos[c];
            if (q < fc) continue;
            if (q < end) {
              lod[(size_t)r * ld + c] = Lr[q - fc];
              continue;
            }
          }
          T s = 0;
          for (int j = 0; j < rank; ++j) s += Lr[j] * Rrow[j * ld + c];
          lod[(size_t)r * ld + c] -= s;
        }
      }
      __syncthreads();
    }

    const int total_rank = ci;  // positions consumed = sum of the level ranks

    // ---- basic solve: backward substitution per level, free vars = 0
    for (int c = tid; c < n; c += nt) xvar[c] = T(0);
    __syncthreads();
    for (int k = p - 1; k >= 0; --k) {
      const int rank = lvl_rank[k];
      if (rank == 0) continue;
      const int fc = lvl_fc[k], end = fc + rank, fr = offs[k];
      const int* cl = colat + k * kmax;
      const T* Rrow = lod + (size_t)fr * ld;
      for (int i = wid; i < rank; i += nw) {
        T s = 0;
        for (int c = lane; c < n; c += kWarp)
          if (pos[c] >= end) s += Rrow[i * ld + c] * xvar[c];
        s = warp_sum(s);
        if (lane == 0) u[i] = Rrow[i * ld + n] - s;
      }
      __syncthreads();
      if (wid == 0) {
        for (int j = rank - 1; j >= 0; --j) {
          const T rjj = Rrow[j * ld + cl[j]];
          const T yj = u[j] / (rjj != T(0) ? rjj : T(1));
          __syncwarp();
          if (lane == 0) u[j] = yj;
          for (int i = lane; i < j; i += kWarp) u[i] -= yj * Rrow[i * ld + cl[j]];
          __syncwarp();
        }
      }
      __syncthreads();
      for (int c = tid; c < n; c += nt) {
        const int q = pos[c];
        if (q >= fc && q < end) xvar[c] += u[q - fc];
      }
      __syncthreads();
    }

    // ---- step (objective.h:288-338); fixed variables take their values
    for (int c = tid; c < n; c += nt) {
      if (d0 > 0 && fmask[c]) xvar[c] = fval[c];
      dx[c] = xvar[c] - x[c];
    }
    __syncthreads();
    for (int i = wid; i < m; i += nw) {
      T s = 0;
      for (int c = lane; c < n; c += kWarp) s += A[(size_t)i * n + c] * dx[c];
      s = warp_sum(s);
      if (lane == 0) {
        const int t = ct[i];
        Adx[i] = s;
        dv[i] = -v[i] + (is_active(t) ? Ax[i] + s - rhs_of(t, lb[i], ub[i]) : T(0));
      }
    }
    __syncthreads();

    // ---- ratio test over inactive rows; first minimum wins
    T rloc = inf;
    for (int i = tid; i < m; i += nt) {
      const T den = Adx[i] - dv[i];
      const bool neg = den < -a.tol_feas, posd = den > a.tol_feas;
      T masked = inf;
      if (ct[i] == kInactive && (neg || posd)) {
        T r = ((neg ? lb[i] : ub[i]) - Ax[i] + v[i]) / den;
        masked = r < T(0) ? T(0) : r;
      }
      lam[i] = masked;  // lam is free until the sweep fills it
      if (masked < rloc) rloc = masked;
    }
    const T amin = block_min(rloc);
    int rowloc = INT_MAX;
    for (int i = tid; i < m; i += nt)
      if (lam[i] != inf && lam[i] == amin && i < rowloc) rowloc = i;
    const int brow = block_min(rowloc);
    const bool blocking = amin < T(1) && brow < m;
    const T alpha = blocking ? amin : T(1);
    int btype = kInactive;
    if (blocking) btype = (Adx[brow] - dv[brow] < -a.tol_feas) ? kActiveLb : kActiveUb;

    // ---- λ sweep and removal selection, when nothing blocks
    bool found = false;
    int sel_row = -1;
    T sel_val = T(0);  // the selected multiplier, for the log (0 under deact_first)
    if (!blocking) {
      for (int idx = tid; idx < p * n; idx += nt) rhs_all[idx] = T(0);
      __syncthreads();
      for (int k = p - 1; k >= 0; --k) {
        const int dim = dims[k];
        if (dim == 0) continue;
        const int fr = offs[k], rank = lvl_rank[k], fc = lvl_fc[k];
        const int* cl = colat + k * kmax;
        const T* Lv = lod + (size_t)fr * ld;
        for (int idx = tid; idx < p * dim; idx += nt) {
          const int jp = idx / dim, r = idx - jp * dim;
          T s = T(0);
          if (jp == k) s = r >= rank ? -Lv[r * ld + n] : T(0);
          else if (jp > k && r < rank) s = rhs_all[jp * n + cl[r]];
          lam[jp * m + d0 + fr + r] = s;
        }
        __syncthreads();
        // S <- S Q^T, Householder replay j = K-1..0, one warp per objective
        for (int jp = k + wid; jp < p; jp += nw) {
          T* S = lam + jp * m + d0 + fr;
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
        // through the L rows stored in their pivot columns
        for (int idx = tid; idx < (p - k) * n; idx += nt) {
          const int jp = k + idx / n, c = idx % n;
          if (pos[c] >= fc) continue;
          const T* S = lam + jp * m + d0 + fr;
          T s = 0;
          for (int r = 0; r < dim; ++r) s += S[r] * Lv[r * ld + c];
          rhs_all[jp * n + c] -= s;
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
            const int c = a.vidx[r];
            const T* S = lam + jp * m + d0;
            for (int i = 0; i < mg; ++i)
              if (is_active(ct[d0 + i])) s -= Ag[(size_t)i * n + c] * S[i];
          }
          lam[jp * m + r] = s;
        }
        __syncthreads();
      }

      // removal selection: the first objective with a wrong-sign
      // multiplier commits; CORRECT_SIGN marks only affect later ones
      for (int i = tid; i < m; i += nt) sense[i] = ct[i];
      for (int j = 0; j < p && !found; ++j) {
        T aloc = inf;
        int kloc = INT_MAX;
        for (int i = tid; i < m; i += nt) {
          const T val = lam[j * m + i];
          const T ai = ct[i] == kActiveLb ? -val : val;
          const int sn = sense[i];
          const bool consider = a.elig[j * m + i] != 0 && (sn == kActiveLb || sn == kActiveUb);
          if (consider && ai > a.tol_correct) sense[i] = kCorrectSign;
          const bool w = consider && ai < -a.tol_wrong;
          wrong[i] = w;
          if (w) {
            if (st[i] < kloc) kloc = st[i];
            if (ai < aloc) aloc = ai;
          }
        }
        int row_j;
        T am = T(0);  // the minimum wrong-sign multiplier (largest-multiplier strategy)
        if (a.deact_first) {
          const int kmin = block_min(kloc);
          int rloc2 = INT_MAX;
          for (int i = tid; i < m; i += nt)
            if (wrong[i] && st[i] == kmin && i < rloc2) rloc2 = i;
          row_j = block_min(rloc2);
        } else {
          am = block_min(aloc);
          long long key = LLONG_MAX;
          for (int i = tid; i < m; i += nt) {
            const T val = lam[j * m + i];
            const T ai = ct[i] == kActiveLb ? -val : val;
            if (wrong[i] && ai == am) {
              const long long kk = ((long long)a.prio[j * m + i] << 32) | (long long)i;
              if (kk < key) key = kk;
            }
          }
          key = block_min(key);
          row_j = key == LLONG_MAX ? INT_MAX : (int)(key & 0xffffffffLL);
        }
        if (row_j != INT_MAX) {
          found = true;
          sel_row = row_j;
          sel_val = am;
        }
      }
    }
    const bool do_remove = !blocking && found;
    const bool solved = !blocking && !found;
    // the type the removed row had, read before the update overwrites it
    const int rm_type = do_remove ? ct[sel_row] : -1;

    // ---- working-set update, step, counters
    __syncthreads();
    for (int i = tid; i < m; i += nt) {
      if (blocking && i == brow) {
        ct[i] = btype;
        st[i] = ns;
      } else if (do_remove && i == sel_row) {
        ct[i] = kInactive;
        st[i] = -1;
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
          const size_t e = (size_t)b * a.log_cap + llen;
          a.lobj[e] = obj;
          a.lctr[e] = rin;
          a.ltyp[e] = blocking ? btype : kInactive;
          a.lval[e] = blocking ? alpha : sel_val;
          a.lrank[e] = total_rank;
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
            if (a.log_cap > 0) {
              const int last = llen - 1 < 0 ? 0 : llen - 1;
              a.lcyc[(size_t)b * a.log_cap + last] = 1;
            }
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
  T* rpad = a.rpad + (size_t)b * p * kmax * kmax;
  for (int idx = tid; idx < p * kmax * kmax; idx += nt) {
    const int k = idx / (kmax * kmax), rem = idx - k * kmax * kmax;
    const int i = rem / kmax, j = rem - i * kmax;
    T val = T(0);
    if (ran) {
      const int rank = lvl_rank[k];
      if (i < rank && j < rank) val = lod[(size_t)(offs[k] + i) * ld + colat[k * kmax + j]];
    }
    rpad[idx] = val;
  }
  for (int c = tid; c < n; c += nt) a.posf[(size_t)b * n + c] = ran ? pos[c] : c;
  for (int k = tid; k < p; k += nt) a.ranks[(size_t)b * p + k] = ran ? lvl_rank[k] : 0;

  if (tid == 0) {
    a.ns[b] = ns;
    a.nf[b] = nf;
    a.it[b] = it;
    a.na[b] = na;
    a.nd[b] = nd;
    a.status[b] = status;
    if (a.log_cap > 0) {
      a.llen[b] = llen;
      a.lovf[b] = lovf;
    }
    if (a.cycling) {
      a.ccnt[b] = ccnt;
      a.cop[b] = cop;
      a.crow[b] = crow;
      a.ctypv[b] = ctypv;
    }
  }
}

template <typename T>
int launch_fused(FusedArgs<T> a, int B, cudaStream_t stream) {
  if (B > 0) fused_kernel<T><<<B, kFusedThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int fused_entry(const T* A, T* lb, T* ub, int* ct, int* st, int* ns, T* x, T* v,
                T* Ax, int* nf, const int* it0, T* dx, T* dv, T* Adx, int* it, int* na, int* nd,
                int* status, T* rpad, int* posf, int* ranks, const int* lvl, const int* prio,
                const int* elig, const int* vidx, T* work, int* iwork, int* lobj, int* lctr,
                int* ltyp, T* lval, int* lrank, int* lcyc, int* llen, int* lovf, int* ccnt,
                int* cop, int* crow, int* ctypv, int B, int m, int n,
                int p, int d0, int kmax, int dmax, T tol_ld, T tol_feas, T tol_wrong,
                T tol_correct, int max_fact, int deact_first, int iter_cap, int log_cap,
                int cycling, int cyc_max, T cyc_relax, void* stream) {
  FusedArgs<T> a;
  a.A = A;
  a.lb = lb;
  a.ub = ub;
  a.ct = ct;
  a.st = st;
  a.ns = ns;
  a.x = x;
  a.v = v;
  a.Ax = Ax;
  a.nf = nf;
  a.it0 = it0;
  a.dx = dx;
  a.dv = dv;
  a.Adx = Adx;
  a.it = it;
  a.na = na;
  a.nd = nd;
  a.status = status;
  a.rpad = rpad;
  a.posf = posf;
  a.ranks = ranks;
  a.lvl = lvl;
  a.prio = prio;
  a.elig = elig;
  a.vidx = vidx;
  a.work = work;
  a.iwork = iwork;
  a.lobj = lobj;
  a.lctr = lctr;
  a.ltyp = ltyp;
  a.lval = lval;
  a.lrank = lrank;
  a.lcyc = lcyc;
  a.llen = llen;
  a.lovf = lovf;
  a.ccnt = ccnt;
  a.cop = cop;
  a.crow = crow;
  a.ctypv = ctypv;
  a.m = m;
  a.n = n;
  a.p = p;
  a.d0 = d0;
  a.kmax = kmax;
  a.dmax = dmax;
  const size_t mg = (size_t)(m - d0);
  a.wstride = mg * (n + 1) + mg + n + dmax + n + (size_t)p * m + (size_t)p * n + mg * kmax + n;
  a.iwstride = (size_t)n + (size_t)p * kmax + 2 * (size_t)m + 2 * (size_t)p + n;
  a.tol_ld = tol_ld;
  a.tol_feas = tol_feas;
  a.tol_wrong = tol_wrong;
  a.tol_correct = tol_correct;
  a.max_fact = max_fact;
  a.deact_first = deact_first;
  a.iter_cap = iter_cap;
  a.log_cap = log_cap;
  a.cycling = cycling;
  a.cyc_max = cyc_max;
  a.cyc_relax = cyc_relax;
  return launch_fused<T>(a, B, (cudaStream_t)stream);
}

}  // namespace lexls

#define LEXLS_FUSED_ENTRY(NAME, T)                                                              \
  int NAME(const T* A, T* lb, T* ub, int* ct, int* st, int* ns, T* x, T* v, T* Ax, int* nf,     \
           const int* it0, T* dx, T* dv, T* Adx, int* it, int* na, int* nd, int* status,        \
           T* rpad, int* posf, int* ranks, const int* lvl, const int* prio, const int* elig,    \
           const int* vidx, T* work, int* iwork, int* lobj, int* lctr, int* ltyp, T* lval,      \
           int* lrank, int* lcyc, int* llen, int* lovf, int* ccnt, int* cop, int* crow,         \
           int* ctypv, int B, int m, int n, int p, int d0, int kmax, int dmax, T tol_ld,        \
           T tol_feas, T tol_wrong, T tol_correct, int max_fact, int deact_first, int iter_cap, \
           int log_cap, int cycling, int cyc_max, T cyc_relax, void* stream) {                  \
    return lexls::fused_entry<T>(A, lb, ub, ct, st, ns, x, v, Ax, nf, it0, dx, dv, Adx, it, na, \
                                 nd, status, rpad, posf, ranks, lvl, prio, elig, vidx, work,    \
                                 iwork, lobj, lctr, ltyp, lval, lrank, lcyc, llen, lovf, ccnt,  \
                                 cop, crow, ctypv, B, m, n, p, d0, kmax, dmax, tol_ld,          \
                                 tol_feas, tol_wrong, tol_correct, max_fact, deact_first,       \
                                 iter_cap, log_cap, cycling, cyc_max, cyc_relax, stream);       \
  }

extern "C" {
LEXLS_FUSED_ENTRY(lexls_fused_active_set_f32, float)
LEXLS_FUSED_ENTRY(lexls_fused_active_set_f64, double)
}  // extern "C"
