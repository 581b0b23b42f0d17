// Phase 1 of a warm step: the working-set activation and the hot start,
// one launch each.
//
// Replaces no Pallas TPU kernel: the JAX package's phase 1
// (lexls_tpu/sequence.py::_device_initial_activation and the x_guess branch
// of lexls_tpu/lexlsi.py::_initial_state) is jnp code that XLA fuses into a
// few kernels.  Written as torch code it was some ninety launches and their
// allocations a warm step, whose issue kept the card idle for longer than
// kernel B2 ran; these two kernels do the same work in one launch each.
//
//  * activation (sequence._device_initial_activation): per row, the
//    equality test (|lb - ub| < 1e-15 and a nonzero normal, or a row of the
//    simple-bounds level) and the guess test give ctr_type; the insertion
//    stamps come from two prefix counts in row order (equalities first,
//    then the guessed LB/UB rows), and next_stamp from their totals.
//  * phase1_warm (lexlsi._initial_state with an x guess): Ax = A x, the
//    hot-start repair of the guessed working set (objective.h:115-172)
//    with fresh stamps for newly active rows in row order, the move of x
//    onto the simple bounds and Ax again (objective.h:73-103), v0
//    (objective.h:183-237) unless the caller gives it, the step at dx = 0
//    (Adx = 0, dv) and the counters, status and cycling detector of a
//    state before its first iteration.
//
// What bounds them on the H100: both read A once (at the bench shape,
// B=384 instances of 120 x 100, 18.4 MB in float32: 5.5 us at 3.35 TB/s)
// and do a few operations per element; at that size a launch is bound by
// its latency, not by bytes.  One block of four warps per instance: the
// row reductions by warps, four rows at a time each (lanes along the rows,
// so that a warp's loads are adjacent, and four rows' loads in flight), a
// barrier, and the prefix counts in row order by one warp with ballots, 32
// rows at a time.  Nothing is staged in shared memory: each value is read
// once or twice, and the kernels' own outputs (Ax, ctr_type) carry the
// per-row results between stages, which the block's barriers make visible.  The outputs are those of the plain
// versions (ops/phase1.py) bit for bit, except Ax and what is computed
// from it, whose sums run in another order: integers and comparisons are
// exact, the sum of squares is tested only for > 0, which no summation
// order changes, and v = Ax - (lb + ub) / 2 is written with an explicitly
// rounded product so that the compiler does not contract it into an fma.
#include <cuda_runtime.h>

#include "block_reduce.cuh"

namespace lexls::phase1 {

constexpr int kThreads = 128;
constexpr int kRowsAtOnce = 4;
constexpr int kInactive = 0, kActiveLb = 1, kActiveUb = 2, kActiveEq = 3;
constexpr int kUnknown = -1;

// The entries' argument arrays, in the order of ops/phase1.py's
// ACTIVATION_INPUTS, ACTIVATION_OUTPUTS, ACTIVATION_INTS, WARM_INPUTS,
// WARM_OUTPUTS and WARM_INTS.
enum ActivationInput { kActInA, kActInLb, kActInUb, kActInGuess, kActInputs };
enum ActivationOutput { kActOutCt, kActOutSt, kActOutNs, kActOutputs };
enum ActivationInt { kActIntB, kActIntM, kActIntN, kActIntD0, kActInts };
enum WarmInput {
  kWarmInA, kWarmInLb, kWarmInUb, kWarmInCt, kWarmInSt, kWarmInNs, kWarmInX,
  kWarmInV0,                                   // null unless v0 is given
  kWarmInVidx,
  kWarmInputs
};
enum WarmOutput {
  kWarmOutX,                                   // null unless x moves onto its bounds
  kWarmOutV,                                   // null when v0 is given
  kWarmOutDx, kWarmOutDv, kWarmOutAx, kWarmOutAdx,
  kWarmOutCt, kWarmOutSt, kWarmOutNs,          // null when v0 is given (no repair)
  kWarmOutZero, kWarmOutNf, kWarmOutStatus, kWarmOutMinusOne, kWarmOutOvf,
  kWarmOutputs
};
enum WarmInt {
  kWarmIntB, kWarmIntM, kWarmIntN, kWarmIntD0, kWarmIntModifyInactive, kWarmIntModifyActive,
  kWarmIntModifyX, kWarmIntMinViolation, kWarmIntNFact,
  kWarmInts
};

struct ActivationArgs {
  const void* in[kActInputs];
  void* out[kActOutputs];
  int m, n, d0;
};

template <typename T>
struct WarmArgs {
  const void* in[kWarmInputs];
  void* out[kWarmOutputs];
  int m, n, d0, modify_inactive, modify_active, modify_x, min_violation, n_fact;
  T tol_feas;
};

__device__ __forceinline__ bool is_active(int t) {
  return t == kActiveLb || t == kActiveUb || t == kActiveEq;
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// For each row i of one instance, s_i = sum_j A_ij x_j (or, with x null,
// sum_j A_ij^2), then done(i, s_i) in lane 0.  A warp takes kRowsAtOnce
// rows at a time, so that it has that many rows' loads in flight: a warp
// working through its rows one by one waits out the memory's latency once
// a row, and that chain, not the bytes, set the kernel's time.
template <typename T, typename Done>
__device__ void row_sums(const T* __restrict__ A, const T* x, int m, int n, Done done) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  for (int i0 = warp * kRowsAtOnce; i0 < m; i0 += kThreads / kWarp * kRowsAtOnce) {
    T s[kRowsAtOnce];
#pragma unroll
    for (int r = 0; r < kRowsAtOnce; ++r) s[r] = T(0);
    for (int j = lane; j < n; j += kWarp) {
      const T xj = x ? x[j] : T(0);
#pragma unroll
      for (int r = 0; r < kRowsAtOnce; ++r) {
        if (i0 + r < m) {
          const T a = A[(size_t)(i0 + r) * n + j];
          s[r] += a * (x ? xj : a);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsAtOnce; ++r) {
      const T sr = warp_sum(s[r]);
      if (lane == 0 && i0 + r < m) done(i0 + r, sr);
    }
  }
}

// A x into Ax.
template <typename T>
__device__ void matvec(const T* __restrict__ A, const T* x, T* Ax, int m, int n) {
  row_sums(A, x, m, n, [&](int i, T s) { Ax[i] = s; });
}

template <typename T>
__global__ void __launch_bounds__(kThreads) activation_kernel(ActivationArgs a) {
  const int b = blockIdx.x, m = a.m, n = a.n;
  const size_t bm = (size_t)b * m;
  const T* A = (const T*)a.in[kActInA] + bm * n;
  const T* lb = (const T*)a.in[kActInLb] + bm;
  const T* ub = (const T*)a.in[kActInUb] + bm;
  const int* guess = (const int*)a.in[kActInGuess] + bm;
  int* ct = (int*)a.out[kActOutCt] + bm;
  int* st = (int*)a.out[kActOutSt] + bm;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  row_sums(A, (const T*)nullptr, m, n, [&](int i, T s) {
    const bool eq = fabs(lb[i] - ub[i]) < T(1e-15) && (s > T(0) || i < a.d0);
    const int g = guess[i];
    ct[i] = eq ? kActiveEq : ((g == kActiveLb || g == kActiveUb) ? g : kInactive);
  });
  __syncthreads();
  if (warp != 0) return;
  // An EQ row is an equality, an LB/UB row a guessed row: equalities take
  // the first stamps in row order, the guessed rows the next ones.
  int n_eq = 0;
  for (int base = 0; base < m; base += kWarp) {
    const int i = base + lane;
    n_eq += __popc(__ballot_sync(kFullMask, i < m && ct[i] == kActiveEq));
  }
  const unsigned below = (1u << lane) - 1u;
  int c_eq = 0, c_g = 0;
  for (int base = 0; base < m; base += kWarp) {
    const int i = base + lane;
    const int t = i < m ? ct[i] : kInactive;
    const unsigned e = __ballot_sync(kFullMask, t == kActiveEq);
    const unsigned g = __ballot_sync(kFullMask, t == kActiveLb || t == kActiveUb);
    if (i < m)
      st[i] = t == kActiveEq ? c_eq + __popc(e & below)
                             : (t == kInactive ? -1 : n_eq + c_g + __popc(g & below));
    c_eq += __popc(e);
    c_g += __popc(g);
  }
  if (lane == 0) ((int*)a.out[kActOutNs])[b] = n_eq + c_g;
}

// The repaired type of a row of type t at Ax (_form_initial_working_set).
template <typename T>
__device__ __forceinline__ int repaired(int t, T ax, T lb, T ub, int modify_inactive,
                                        int modify_active) {
  if (modify_inactive && t == kInactive) {
    if (ax <= lb) return kActiveLb;
    if (ax > lb && ax >= ub) return kActiveUb;
  }
  if (modify_active) {
    if (t == kActiveLb && ax > lb) return ax >= ub ? kActiveUb : kInactive;
    if (t == kActiveUb && ax < ub) return ax <= lb ? kActiveLb : kInactive;
  }
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) warm_kernel(WarmArgs<T> a) {
  const int b = blockIdx.x, m = a.m, n = a.n, tid = threadIdx.x;
  const size_t bm = (size_t)b * m, bn = (size_t)b * n;
  const T* A = (const T*)a.in[kWarmInA] + bm * n;
  const T* lb = (const T*)a.in[kWarmInLb] + bm;
  const T* ub = (const T*)a.in[kWarmInUb] + bm;
  const int* ct0 = (const int*)a.in[kWarmInCt] + bm;
  const T* x0 = (const T*)a.in[kWarmInX] + bn;
  T* Ax = (T*)a.out[kWarmOutAx] + bm;
  T* dx = (T*)a.out[kWarmOutDx] + bn;
  T* x = a.out[kWarmOutX] ? (T*)a.out[kWarmOutX] + bn : nullptr;
  const bool repair = a.out[kWarmOutCt] != nullptr;
  const int lane = tid % kWarp, warp = tid / kWarp;

  matvec(A, x0, Ax, m, n);
  for (int j = tid; j < n; j += kThreads) {
    dx[j] = T(0);
    if (x) x[j] = x0[j];
  }
  __syncthreads();
  const int* ct = ct0;
  if (repair) {
    int* ctn = (int*)a.out[kWarmOutCt] + bm;
    if (warp == 0) {
      const int* st0 = (const int*)a.in[kWarmInSt] + bm;
      int* st = (int*)a.out[kWarmOutSt] + bm;
      const int ns0 = ((const int*)a.in[kWarmInNs])[b];
      const unsigned below = (1u << lane) - 1u;
      int c = 0;
      for (int base = 0; base < m; base += kWarp) {
        const int i = base + lane;
        int t = kInactive, nt = kInactive;
        if (i < m) {
          t = ct0[i];
          nt = repaired(t, Ax[i], lb[i], ub[i], a.modify_inactive, a.modify_active);
        }
        const bool newly = nt != t && is_active(nt);
        const unsigned na = __ballot_sync(kFullMask, newly);
        if (i < m) {
          ctn[i] = nt;
          st[i] = newly ? ns0 + c + __popc(na & below) : (nt != t && nt == kInactive ? -1 : st0[i]);
        }
        c += __popc(na);
      }
      if (lane == 0) ((int*)a.out[kWarmOutNs])[b] = ns0 + c;
      if (x) {
        // in row order, so that of two bound rows on one variable the
        // later one wins, as in the plain version's indexed assignment
        __syncwarp();
        if (lane == 0) {
          const int* vidx = (const int*)a.in[kWarmInVidx];
          for (int i = 0; i < a.d0; ++i) {
            const int t = ctn[i];
            x[vidx[i]] = t == kInactive ? mul_rn(T(0.5), lb[i] + ub[i])
                                        : (t == kActiveLb ? lb[i] : ub[i]);
          }
        }
      }
    }
    ct = ctn;
    __syncthreads();
    if (x) {
      matvec(A, (const T*)x, Ax, m, n);
      __syncthreads();
    }
  }
  const T* v0 = (const T*)a.in[kWarmInV0];
  T* vout = (T*)a.out[kWarmOutV];
  T* dv = (T*)a.out[kWarmOutDv] + bm;
  T* Adx = (T*)a.out[kWarmOutAdx] + bm;
  for (int i = tid; i < m; i += kThreads) {
    const int t = ct[i];
    const T ax = Ax[i], l = lb[i], u = ub[i];
    T v;
    if (v0) {
      v = v0[bm + i];
    } else {
      v = ax - mul_rn(T(0.5), l + u);
      if (t == kActiveLb) v = ax - l;
      if (t == kActiveUb || t == kActiveEq) v = ax - u;
      if (t == kInactive) {
        if (a.min_violation)
          v = ax <= l ? ax - l : (ax >= u ? ax - u : T(0));
        else if (ax >= l - a.tol_feas && ax <= u + a.tol_feas)
          v = T(0);
      }
      vout[bm + i] = v;
    }
    const T rhs = (t == kActiveUb || t == kActiveEq) ? u : (t == kActiveLb ? l : T(0));
    dv[i] = -v + (is_active(t) ? (ax + T(0)) - rhs : T(0));
    Adx[i] = T(0);
  }
  if (tid == 0) {
    ((int*)a.out[kWarmOutZero])[b] = 0;
    ((int*)a.out[kWarmOutNf])[b] = a.n_fact;
    ((int*)a.out[kWarmOutStatus])[b] = kUnknown;
    ((int*)a.out[kWarmOutMinusOne])[b] = -1;
    ((bool*)a.out[kWarmOutOvf])[b] = false;
  }
}

template <typename T>
int activation_entry(const void* const* in, void* const* out, const int* ints, void* stream) {
  ActivationArgs a;
  for (int i = 0; i < kActInputs; ++i) a.in[i] = in[i];
  for (int i = 0; i < kActOutputs; ++i) a.out[i] = out[i];
  a.m = ints[kActIntM];
  a.n = ints[kActIntN];
  a.d0 = ints[kActIntD0];
  if (ints[kActIntB] > 0)
    activation_kernel<T><<<ints[kActIntB], kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int warm_entry(const void* const* in, void* const* out, const int* ints, double tol_feas,
               void* stream) {
  WarmArgs<T> a;
  for (int i = 0; i < kWarmInputs; ++i) a.in[i] = in[i];
  for (int i = 0; i < kWarmOutputs; ++i) a.out[i] = out[i];
  a.m = ints[kWarmIntM];
  a.n = ints[kWarmIntN];
  a.d0 = ints[kWarmIntD0];
  a.modify_inactive = ints[kWarmIntModifyInactive];
  a.modify_active = ints[kWarmIntModifyActive];
  a.modify_x = ints[kWarmIntModifyX];
  a.min_violation = ints[kWarmIntMinViolation];
  a.n_fact = ints[kWarmIntNFact];
  a.tol_feas = (T)tol_feas;
  if (ints[kWarmIntB] > 0)
    warm_kernel<T><<<ints[kWarmIntB], kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace lexls::phase1

extern "C" {

int lexls_activation_f32(const void* const* in, void* const* out, const int* ints,
                         void* stream) {
  return lexls::phase1::activation_entry<float>(in, out, ints, stream);
}

int lexls_activation_f64(const void* const* in, void* const* out, const int* ints,
                         void* stream) {
  return lexls::phase1::activation_entry<double>(in, out, ints, stream);
}

int lexls_phase1_warm_f32(const void* const* in, void* const* out, const int* ints,
                          double tol_feas, void* stream) {
  return lexls::phase1::warm_entry<float>(in, out, ints, tol_feas, stream);
}

int lexls_phase1_warm_f64(const void* const* in, void* const* out, const int* ints,
                          double tol_feas, void* stream) {
  return lexls::phase1::warm_entry<double>(in, out, ints, tol_feas, stream);
}

}  // extern "C"
