// Fused population psi for ODE models: explicit Runge-Kutta tier, exact
// propagation tier, SDIRK tier, BDF tier and their feature tier, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel pharmsol_tpu/ops/pallas_ode.py::psi_ode
// (_make_ode_kernel): K2a, the explicit `integrate` march (dopri5 and tsit5,
// merged dense output, RHS-difference boluses, several dose inputs, linear
// outputs, censoring); K2e, its feature tier (covariate lanes and
// LaneCov :417/:644-660, init :1614-1618, the lag/fa split march with slot
// tables :1665-1807); and K2d, the exact propagation of an affine autonomous
// RHS (`integrate_expm` :1152-1287, solver code 2, see march_expm below),
// with or without the feature tier; K2b, the SDIRK tier for stiff models
// (`integrate_sdirk` :949-1150 with `_lane_inverse` :339: trbdf2, kvaerno3 =
// esdirk34, kvaerno5; solver codes 3, 4, 5, see march_sdirk below); and K2c,
// the variable-order BDF tier (`integrate_bdf` :1289-1612 with `_bdf_U` :312;
// solver code 6, see march_bdf below). Plain PyTorch twin:
// pharmsol_tpu_torch/ops/fused_ode.py::psi_ode_plain.
//
// The model's right-hand side is not written here: it is generated from the
// model's torch closure by pharmsol_tpu_torch/ops/rhs_codegen.py as one
// straight-line function `rhs<T>(x, p, t, b, rateiv, cov_a, cov_b, dx)` and
// included through PHARMSOL_ODE_RHS, so each model builds its own library.
// A covariate reads cov_a[i] (constant over the row) or cov_a[i] +
// cov_b[i] * t (affine within the segment). A header generated with the
// Jacobian (PHARMSOL_RHS_HAS_JVP) also holds `rhs_jvp<T>(x, p, t, b, rateiv,
// cov_a, cov_b, v, jv)`, jv = (df/dx)(x) v by symbolic forward mode; such a
// library holds K2d's instantiations and no other, a header without it the
// explicit tier's, so a model's explicit library is what it was before K2d.
// A header without it may also split rhs into `rhs_pre<T>(p, t, cov_a,
// cov_b, pre)`, the covariate-only terms (PHARMSOL_RHS_NPRE of them), and
// `rhs_body<T>(x, p, t, b, rateiv, cov_a, cov_b, pre, dx)`, which reads them:
// the explicit tier computes them once per run where no covariate has a
// slope (rhs_run).
// The implicit tiers are chosen at compile time: -DPHARMSOL_ODE_SOLVER=3, 4,
// 5 (K2b) or 6 (K2c) on a header with rhs_jvp builds that one solver's
// instantiations and no other, with -fmad=false so that every multiply and
// add rounds as in the twin, op by op (ops/_build.py::ode_kind).
//
// Two instantiations of one kernel template: FEAT = false is K2a, whose code
// is the explicit tier's alone (no covariate, init, lag or fa work is
// compiled in); FEAT = true is K2e. K2e's inputs ride in one struct of
// pointers (Feat, null = off):
// - covariates: cov_a, cov_b [NCOV, R, M]: per segment column, the constant
//   value or the affine (a, b) of the segment (warp broadcasts);
// - init: init_rows [N, S] or init_planes [N, R, S], times init_mask [R];
// - lag, fa: plane stacks [n, R, S] (coalesced along supports), selected per
//   (bolus plane, segment) by the slot tables [nb, M] of the int table (-1:
//   no dose lands there; static planes have slot k in every column).
// With lag, each bolus plane's pending dose lives in two registers
// (pend_amt, pend_rem) and the segment march splits at the fire times: the
// doses due at the breakpoint fire after its observation, new doses park
// with their lag, one pass per bolus plane marches to the next earliest fire
// time (equal times fire together, strict rem < dt), and the last pass runs
// to the segment's end; pend_rem counts down on spanned segments only. A dose
// at time t is x += f(x, b, t) - f(x, 0, t) with the segment's covariates.
// The Hairer starting step is estimated on segment 0's first pass only.
//
// Layout. The explicit and implicit tiers run a persistent grid
// (fused_ode_explicit_kernel, fused_ode_implicit_kernel): as many blocks of
// 128 threads as the card holds at once, each lane marching the cells that
// CellWalk gives it one after the other, one trial a pass of one loop, in
// support-major order (a warp on 32 neighbouring rows of one support, whose
// parameters, lag and grid they share). The explicit tier's warp takes its
// march calls' boundaries together; the implicit tiers' lanes take theirs on
// their own. K2d keeps one thread per (row, support) cell
// (fused_ode_kernel): threadIdx.x runs along the supports, so the parameter
// rows [P, S], the output coefficients and the psi writes [R, S] are
// coalesced and the 32 threads of a warp share one row; blocks stride over
// rows in y. No padding of R, S or M, and M has no limit. States, the 7 FSAL
// stages, the step size and the controller live in registers; the tableaus
// are compile-time constants.
//
// Per cell, for each run of segments [m0, m1) (one segment per run, or a
// merged run whose interior breakpoints carry observations only):
// 1. add the observation term at m0, read before the dose;
// 2. apply each active input's bolus by the RHS difference, x += f(x, b) -
//    f(x, 0), the general engine's own semantics;
// 3. march the run with the adaptive embedded pair (I-controller, growth in
//    [0.2, 5]); on the first run the step starts from the Hairer-Norsett-
//    Wanner estimate floored at h0, later runs reuse the last step. An
//    accepted step that crosses an interior observation captures it from the
//    tableau's quartic interpolant, x(theta) = x + h sum_i b_i(theta) k_i, at
//    T_eff = min(T, target - 1e-6 target); zero-offset observations read the
//    run's start state. A lane that stalls (t + h == t) or runs out of steps
//    is poisoned to NaN, and so are the captures it never reached; a lane that
//    arrives non-finite does not march.
// Censored terms use the exact log of the normal CDF through erfcx/erfc.
//
// What bounds it. Arithmetic issue: each trial step costs 6 RHS evaluations
// plus ~(7 + 6) * n fused multiply-adds for the stages and the error norm,
// a square root and a power for the controller; a 3-state PK model takes
// ~20-40 trials over a 12 h profile, about 10^4 instructions per cell. Memory
// is minor (one psi value written per cell, K2e's [R, S] planes read once).
// Adaptive step counts differ between the lanes of a warp, so a warp runs to
// its slowest lane in each march call; the support-major walk gives a warp
// rows of one support, whose calls need nearly the same trials. The float64
// pow and division routines are software sequences: a covariate model's
// covariate-only terms (the reference's creatinine pow) move out of the
// stages into rhs_pre, once per run where no covariate has a slope.
//
// Build (plain C interface, loaded with ctypes; ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -I<dir> -DPHARMSOL_ODE_RHS='"rhs_<key>.cuh"' \
//        -o libfused_ode_<hash>.so fused_ode.cu

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef PHARMSOL_ODE_RHS
#error "define PHARMSOL_ODE_RHS as the generated RHS header (ops/_build.py)"
#endif
#include PHARMSOL_ODE_RHS

namespace {

constexpr int N = PHARMSOL_RHS_NSTATES;
constexpr int NP = PHARMSOL_RHS_NPARAMS;
constexpr int NIN = PHARMSOL_RHS_NINPUT;
constexpr int NS = 7;  // stages of both tableaus (FSAL: stage 7 = f(x_new))
constexpr int NCOV = PHARMSOL_RHS_NCOV;
constexpr int NC = NCOV > 0 ? NCOV : 1;  // register arrays of the covariates
#ifndef PHARMSOL_RHS_NPRE
#define PHARMSOL_RHS_NPRE 0  // a header without rhs_pre / rhs_body
#endif
constexpr int NPRE = PHARMSOL_RHS_NPRE;
constexpr int NQ = NPRE > 0 ? NPRE : 1;  // register array of the covariate-only terms

// Butcher tableaus: the constants of pharmsol_tpu_torch/engine/ode.py, as
// the same double expressions.
template <int SOLVER>
struct Tab;

template <>
struct Tab<0> {  // Dormand-Prince 5(4)
  __host__ __device__ static constexpr double a(int i, int j) {
    constexpr double A[NS][NS] = {
        {0, 0, 0, 0, 0, 0, 0},
        {1.0 / 5, 0, 0, 0, 0, 0, 0},
        {3.0 / 40, 9.0 / 40, 0, 0, 0, 0, 0},
        {44.0 / 45, -56.0 / 15, 32.0 / 9, 0, 0, 0, 0},
        {19372.0 / 6561, -25360.0 / 2187, 64448.0 / 6561, -212.0 / 729, 0, 0, 0},
        {9017.0 / 3168, -355.0 / 33, 46732.0 / 5247, 49.0 / 176, -5103.0 / 18656, 0, 0},
        {35.0 / 384, 0.0, 500.0 / 1113, 125.0 / 192, -2187.0 / 6784, 11.0 / 84, 0}};
    return A[i][j];
  }
  __host__ __device__ static constexpr double b(int i) {
    constexpr double B[NS] = {35.0 / 384, 0.0, 500.0 / 1113, 125.0 / 192,
                              -2187.0 / 6784, 11.0 / 84, 0.0};
    return B[i];
  }
  // b5 - b4, as engine/ode.py _DP_E
  __host__ __device__ static constexpr double e(int i) {
    constexpr double E[NS] = {
        35.0 / 384 - 5179.0 / 57600, 0.0 - 0.0, 500.0 / 1113 - 7571.0 / 16695,
        125.0 / 192 - 393.0 / 640, -2187.0 / 6784 - -92097.0 / 339200,
        11.0 / 84 - 187.0 / 2100, 0.0 - 1.0 / 40};
    return E[i];
  }
  __host__ __device__ static constexpr double c(int i) {
    constexpr double C[NS] = {0.0, 1.0 / 5, 3.0 / 10, 4.0 / 5, 8.0 / 9, 1.0, 1.0};
    return C[i];
  }
};

template <>
struct Tab<1> {  // Tsitouras 5(4)
  __host__ __device__ static constexpr double a(int i, int j) {
    constexpr double A[NS][NS] = {
        {0, 0, 0, 0, 0, 0, 0},
        {0.161, 0, 0, 0, 0, 0, 0},
        {-0.008480655492356989, 0.335480655492357, 0, 0, 0, 0, 0},
        {2.8971530571054935, -6.359448489975075, 4.3622954328695815, 0, 0, 0, 0},
        {5.325864828439257, -11.748883564062828, 7.4955393428898365,
         -0.09249506636175525, 0, 0, 0},
        {5.86145544294642, -12.92096931784711, 8.159367898576159,
         -0.071584973281401, -0.028269050394068383, 0, 0},
        {0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
         -3.290069515436081, 2.324710524099774, 0}};
    return A[i][j];
  }
  __host__ __device__ static constexpr double b(int i) { return a(NS - 1, i); }
  __host__ __device__ static constexpr double e(int i) {
    constexpr double E[NS] = {
        -0.00178001105222577714, -0.0008164344596567469, 0.007880878010261995,
        -0.1447110071732629,     0.5823571654525552,     -0.45808210592918697,
        0.015151515151515152};
    return E[i];
  }
  __host__ __device__ static constexpr double c(int i) {
    constexpr double C[NS] = {0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0};
    return C[i];
  }
};

template <typename T>
struct Fn;

template <>
struct Fn<float> {
  static __device__ __forceinline__ float log1p(float v) { return log1pf(v); }
  static __device__ __forceinline__ float erfc(float v) { return erfcf(v); }
  static __device__ __forceinline__ float erfcx(float v) { return erfcxf(v); }
};

template <>
struct Fn<double> {
  static __device__ __forceinline__ double log1p(double v) { return ::log1p(v); }
  static __device__ __forceinline__ double erfc(double v) { return ::erfc(v); }
  static __device__ __forceinline__ double erfcx(double v) { return ::erfcx(v); }
};

// log Phi(v), exact: the left tail through the scaled complementary error
// function, the right side through log1p.
template <typename T>
__device__ __forceinline__ T log_ndtr(T v) {
  const T inv_sqrt2 = T(0.70710678118654752440);
  if (v < T(0)) {
    return pm_log(T(0.5) * Fn<T>::erfcx(-v * inv_sqrt2)) - T(0.5) * v * v;
  }
  return Fn<T>::log1p(T(-0.5) * Fn<T>::erfc(v * inv_sqrt2));
}

// K2e's feature inputs (null = off).
template <typename T>
struct Feat {
  const T* cov_a;        // [NCOV, R, M]
  const T* cov_b;        // [NCOV, R, M] or null (no affine covariate)
  const T* lag;          // [n_lag, R, S]
  const T* fa;           // [n_fa, R, S]
  const T* init_rows;    // [N, S]
  const T* init_planes;  // [N, R, S]
  const T* init_mask;    // [R]
  const int* lag_slots;  // [nb, M]
  const int* fa_slots;   // [nb, M]
  int n_lag, n_fa;
};

template <typename T>
struct Args {
  const T* seg_dt;     // [R, M]
  const T* seg_bolus;  // [nb, R, M]
  const T* seg_rate;   // [nr, R, M] or null
  const T* obs_mask;   // [R, M]
  const T* obs_value;
  const T* obs_sigma;
  const T* obs_cens;   // or null
  const T* obs_outeq;  // or null when n_out == 1
  const T* seg_t0;     // [R, M]
  const T* params;     // [NP, S]
  const T* coef;       // [n_out, N, S]
  const T* bias;       // [n_out, S] or null
  const T* dense;      // [NS, 4] quartic interpolant
  const int* bolus_in; // [nb] RHS input of each bolus plane
  const int* rate_in;  // [nr]
  const int* runs;     // [n_runs + 1] run boundaries
  T* out;              // [R, S]
  int R, S, M, nb, nr, n_out, n_runs, max_iters;
  int newton_iters;    // K2b, K2c: Newton rounds per stage or step
  int bdf_max_order;   // K2c: the order cap, 1..5
  T rtol, atol, h0;
  Feat<T> f;           // K2e only
};

// Observation term of stream element i for state xv (0 when masked).
template <typename T>
__device__ __forceinline__ T obs_term(const Args<T>& a, size_t i, int s,
                                      const T* xv) {
  if (!(a.obs_mask[i] > T(0))) return T(0);
  const int k = a.n_out > 1 ? (int)a.obs_outeq[i] : 0;
  T pred = T(0);
  if (k >= 0 && k < a.n_out) {
    const T* ck = a.coef + (size_t)k * N * a.S + s;
    pred = ck[0] * xv[0];
#pragma unroll
    for (int j = 1; j < N; ++j) pred = pred + ck[(size_t)j * a.S] * xv[j];
    if (a.bias != nullptr) pred = pred + a.bias[(size_t)k * a.S + s];
  }
  const T LOG_2PI = T(1.8378770664093454836);
  const T sig = a.obs_sigma[i];
  const T z = (a.obs_value[i] - pred) / sig;
  const T sc = a.obs_cens != nullptr ? a.obs_cens[i] : T(0);
  return sc == T(0) ? T(-0.5) * LOG_2PI - pm_log(sig) - T(0.5) * z * z
                    : log_ndtr(sc * z);
}

template <typename T>
__device__ __forceinline__ bool all_finite(const T* v) {
  bool ok = true;
#pragma unroll
  for (int j = 0; j < N; ++j) ok = ok && isfinite(v[j]);
  return ok;
}

// What a lane of the persistent grids carries from one trial to the next
// (fused_ode_explicit_kernel and fused_ode_implicit_kernel below): its cell,
// the cell's parameters, state and log-likelihood, the run (and with lag the
// pass of its segment) it marches, and the position of that march call. The
// solver's own state rides beside it (RkCall, SdirkCall, BdfCall).
template <typename T>
struct Lane {
  int s;                     // the cell's support
  size_t row, rs;            // its row in [R, M] streams; the cell in [R, S]
  T p[NP], x[N], ll, h;
  T rate[NIN], ca[NC], cb[NC];
  T pre[NQ];                 // the explicit tier: the run's covariate-only RHS terms
  bool fixed;                // ... valid: no covariate has a slope in the run
  T pend_amt[NIN], pend_rem[NIN];  // K2e with lag: each bolus plane's pending dose
  int ri, pass;              // the run; with lag the pass of its segment
  int m0, m1;                // the march call's columns [m0, m1)
  T t0, elapsed;             // the run's start; with lag the time marched in it
  T tc, target, thr, tau, hc;  // the march call: start, length, end, progress, step
  int it;                    // the call's trials so far
  bool live;                 // the call marches on
};

// f(x) at t on a run: with the run's covariate-only terms `pre` where they
// are valid for the whole run (`fixed`: no covariate has a slope), else
// from the covariates at t. rhs_pre + rhs_body compute rhs's own
// expressions, so both give rhs's values; a header without the split (every
// tier but the explicit one, and an RHS whose split saves nothing) calls
// rhs.
template <typename T>
__device__ __forceinline__ void rhs_run(const T* pre, bool fixed, const T* x, const T* p, T t,
                                        const T* b, const T* rate, const T* ca, const T* cb,
                                        T* dx) {
#if PHARMSOL_RHS_NPRE > 0
  T q[NPRE];
  if (fixed) {
#pragma unroll
    for (int i = 0; i < NPRE; ++i) q[i] = pre[i];
  } else {
    rhs_pre<T>(p, t, ca, cb, q);
  }
  rhs_body<T>(x, p, t, b, rate, ca, cb, q, dx);
#else
  (void)pre;
  (void)fixed;
  rhs<T>(x, p, t, b, rate, ca, cb, dx);
#endif
}

#if defined(PHARMSOL_ODE_SOLVER) && !defined(PHARMSOL_RHS_HAS_JVP)
#error "the implicit tiers need a header generated with rhs_jvp"
#endif

#if defined(PHARMSOL_RHS_HAS_JVP) && !defined(PHARMSOL_ODE_SOLVER)
// K2d: the exact propagation of one pass over `target` time from t0, for an
// RHS that is affine in the state and autonomous within the pass (the plan
// proved both with float64 probes, and that no covariate has a slope; the
// covariates read at t0 stand for the whole pass). The JAX kernel's
// `integrate_expm` (ops/pallas_ode.py:1152-1287):
//   u = f(0), A's columns by rhs_jvp at 0 against unit vectors, both scaled
//   by the pass length; norm = max_i(|u_i| + sum_j |A_ij|);
//   s = ceil(max(log2 norm, 0)); A, u scaled by 2^-s; the Taylor-13 Horner
//   chain on the block [[A, u], [0, 0]] in (P, q) form,
//   (P, q) <- (I + A P / d, (A q + u) / d), d = 12 .. 1; then s squarings
//   (P, q) <- (P P, P q + q); x <- P x + q.
// The TPU kernel squares every lane to its tile's largest count under a
// mask, because its lanes move together; a thread squares to its own count.
// A lane whose count passes EXPM_SQUARINGS (16), or whose result is not
// finite, is NaN (a -inf cell); a pass of zero length leaves x untouched.
// No library routine computes the exponential: the chain is written out
// here. Both loops stay rolled (one product's code each, unrolled over N);
// As, us, P, q and one product are 3 N^2 + 2 N live values a thread.
constexpr int EXPM_TAYLOR = 13;
constexpr int EXPM_SQUARINGS = 16;

template <typename T>
__device__ __forceinline__ T pm_log2(T v);
template <>
__device__ __forceinline__ float pm_log2<float>(float v) { return log2f(v); }
template <>
__device__ __forceinline__ double pm_log2<double>(double v) { return log2(v); }
template <typename T>
__device__ __forceinline__ T pm_exp2(T v);
template <>
__device__ __forceinline__ float pm_exp2<float>(float v) { return exp2f(v); }
template <>
__device__ __forceinline__ double pm_exp2<double>(double v) { return exp2(v); }
template <typename T>
__device__ __forceinline__ T pm_ceil(T v);
template <>
__device__ __forceinline__ float pm_ceil<float>(float v) { return ceilf(v); }
template <>
__device__ __forceinline__ double pm_ceil<double>(double v) { return ceil(v); }

template <typename T>
__device__ __forceinline__ void march_expm(T* x, const T* p, const T* rate,
                                           const T* ca, const T* cb, T t0,
                                           T target) {
  if (!(target > T(0))) return;
  T bz[NIN], zero[N];
#pragma unroll
  for (int j = 0; j < NIN; ++j) bz[j] = T(0);
#pragma unroll
  for (int j = 0; j < N; ++j) zero[j] = T(0);
  T us[N], As[N][N];
  rhs<T>(zero, p, t0, bz, rate, ca, cb, us);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T e[N], col[N];
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = (i == j) ? T(1) : T(0);
    rhs_jvp<T>(zero, p, t0, bz, rate, ca, cb, e, col);
#pragma unroll
    for (int i = 0; i < N; ++i) As[i][j] = col[i] * target;
  }
  T norm = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    us[i] = us[i] * target;
    T row = pm_abs(us[i]);
#pragma unroll
    for (int j = 0; j < N; ++j) row = row + pm_abs(As[i][j]);
    norm = i == 0 ? row : pm_max(norm, row);
  }
  norm = pm_max(norm, T(1e-30));
  const T s_cnt = pm_ceil(pm_max(pm_log2(norm), T(0)));
  const T sc = pm_exp2(-s_cnt);
  T P[N][N], q[N];
  const T inv0 = T(1.0 / EXPM_TAYLOR);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    us[i] = us[i] * sc;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      As[i][j] = As[i][j] * sc;
      P[i][j] = As[i][j] * inv0 + (i == j ? T(1) : T(0));
    }
    q[i] = us[i] * inv0;
  }
#pragma unroll 1
  for (int d = EXPM_TAYLOR - 1; d >= 1; --d) {
    const T inv = T(1.0 / (double)d);
    T Pn[N][N], qn[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T acc = As[i][0] * P[0][j];
#pragma unroll
        for (int l = 1; l < N; ++l) acc = acc + As[i][l] * P[l][j];
        Pn[i][j] = acc * inv + (i == j ? T(1) : T(0));
      }
      T acc = As[i][0] * q[0];
#pragma unroll
      for (int l = 1; l < N; ++l) acc = acc + As[i][l] * q[l];
      qn[i] = (acc + us[i]) * inv;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      q[i] = qn[i];
#pragma unroll
      for (int j = 0; j < N; ++j) P[i][j] = Pn[i][j];
    }
  }
  bool bad = !(s_cnt <= T(EXPM_SQUARINGS));
  const int n_sq = bad ? 0 : (int)s_cnt;
#pragma unroll 1
  for (int it = 0; it < n_sq; ++it) {
    T Pn[N][N], qn[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T acc = P[i][0] * P[0][j];
#pragma unroll
        for (int l = 1; l < N; ++l) acc = acc + P[i][l] * P[l][j];
        Pn[i][j] = acc;
      }
      T acc = P[i][0] * q[0];
#pragma unroll
      for (int l = 1; l < N; ++l) acc = acc + P[i][l] * q[l];
      qn[i] = acc + q[i];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      q[i] = qn[i];
#pragma unroll
      for (int j = 0; j < N; ++j) P[i][j] = Pn[i][j];
    }
  }
  T xn[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T acc = P[i][0] * x[0];
#pragma unroll
    for (int l = 1; l < N; ++l) acc = acc + P[i][l] * x[l];
    xn[i] = acc + q[i];
  }
  bad = bad || !all_finite(xn);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = bad ? T(NAN) : xn[i];
}
#endif  // K2d

#if defined(PHARMSOL_ODE_SOLVER)
// ---------------------------------------------------------------------------
// The implicit tiers (K2b, K2c). Both freeze the RHS's Jacobian once per
// trial step, J's column j = rhs_jvp against unit vector j, and invert the
// iteration matrix I - c J once per trial; each Newton round is then one RHS
// and one N x N matrix-vector product. No library routine stands in for any
// of it: the elimination, the Newton rounds, the Hermite capture and the
// difference-array transforms are written out here, in the twin's expression
// order (the library is built with -fmad=false), so that kernel and twin take
// the same step decisions.
// ---------------------------------------------------------------------------

// Minv = (I - c J(x, t))^-1 by Gauss-Jordan without pivoting, the diagonal
// clamped at 1e-30 (the JAX kernel's _lane_inverse, ops/pallas_ode.py:339):
// the iteration matrix has a dominant positive diagonal for compartment
// kinetics, and a singular lane gives garbage that the Newton residual check
// rejects. This elimination decides which lanes reject: keep it as it is.
template <typename T>
__device__ __forceinline__ void newton_inverse(const T* x, const T* p, T t,
                                               const T* rate, const T* ca,
                                               const T* cb, T c,
                                               T (*Minv)[N]) {
  T bz[NIN];
#pragma unroll
  for (int j = 0; j < NIN; ++j) bz[j] = T(0);
  T aug[N][2 * N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T e[N], col[N];
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = (i == j) ? T(1) : T(0);
    rhs_jvp<T>(x, p, t, bz, rate, ca, cb, e, col);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      aug[i][j] = (i == j ? T(1) : T(0)) - c * col[i];
      aug[i][N + j] = (i == j) ? T(1) : T(0);
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    T d = aug[k][k];
    d = pm_abs(d) > T(1e-30) ? d : T(1e-30);
    const T inv_d = T(1) / d;
#pragma unroll
    for (int j = 0; j < 2 * N; ++j) aug[k][j] = aug[k][j] * inv_d;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i == k) continue;
      const T factor = aug[i][k];
#pragma unroll
      for (int j = 0; j < 2 * N; ++j) aug[i][j] = aug[i][j] - factor * aug[k][j];
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) Minv[i][j] = aug[i][N + j];
}

template <typename T>
__device__ __forceinline__ void matvec(T (*Mx)[N], const T* v, T* out) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T acc = Mx[i][0] * v[0];
#pragma unroll
    for (int j = 1; j < N; ++j) acc = acc + Mx[i][j] * v[j];
    out[i] = acc;
  }
}

#if PHARMSOL_ODE_SOLVER != 6
// The embedded ESDIRK pairs of pharmsol_tpu_torch/engine/ode.py
// (SDIRK_TABLEAUS), the same doubles: NSTG stages, A (lower triangle, the
// diagonal gamma left out), B, BHAT, C, gamma, the controller's order and the
// most a step may grow.
template <int SOLVER>
struct STab;

template <>
struct STab<3> {  // TR-BDF2 as a 3-stage ESDIRK 2(3) (Hosea & Shampine 1996)
  static constexpr int NSTG = 3;
  static constexpr double gamma = 0.2928932188134524;  // (2 - sqrt 2) / 2
  static constexpr double order = 2.0, max_growth = 5.0;
  __host__ __device__ static constexpr double a(int i, int j) {
    constexpr double W = 0.3535533905932738;  // sqrt(2) / 4
    constexpr double A[NSTG][NSTG] = {{0, 0, 0}, {gamma, 0, 0}, {W, W, 0}};
    return A[i][j];
  }
  __host__ __device__ static constexpr double b(int i) {
    constexpr double B[NSTG] = {0.3535533905932738, 0.3535533905932738, gamma};
    return B[i];
  }
  __host__ __device__ static constexpr double bhat(int i) {
    constexpr double BH[NSTG] = {0.21548220313557542, 0.6868867239266071,
                                 0.09763107293781748};
    return BH[i];
  }
  __host__ __device__ static constexpr double c(int i) {
    constexpr double C[NSTG] = {0.0, 0.5857864376269049, 1.0};
    return C[i];
  }
};

template <>
struct STab<4> {  // Kvaerno 3/2: 4-stage ESDIRK, stiffly accurate, L-stable
  static constexpr int NSTG = 4;
  static constexpr double gamma = 0.4358665215084590;
  static constexpr double order = 3.0, max_growth = 5.0;
  __host__ __device__ static constexpr double a(int i, int j) {
    constexpr double A[NSTG][NSTG] = {
        {0, 0, 0, 0},
        {gamma, 0, 0, 0},
        {0.490563388419108, 0.073570090080892, 0, 0},
        {0.308809969973036, 1.490563388254106, -1.235239879727145, 0}};
    return A[i][j];
  }
  __host__ __device__ static constexpr double b(int i) {
    constexpr double B[NSTG] = {0.308809969973036, 1.490563388254106,
                                -1.235239879727145, gamma};
    return B[i];
  }
  __host__ __device__ static constexpr double bhat(int i) {
    constexpr double BH[NSTG] = {0.490563388419108, 0.073570090080892, gamma, 0.0};
    return BH[i];
  }
  __host__ __device__ static constexpr double c(int i) {
    constexpr double C[NSTG] = {0.0, 2 * 0.4358665215084590, 1.0, 1.0};
    return C[i];
  }
};

template <>
struct STab<5> {  // Kvaerno 5(4): 7-stage ESDIRK, L-stable (Kvaerno 2004)
  static constexpr int NSTG = 7;
  static constexpr double gamma = 0.26;
  // the order-5 estimator is optimistic across sharp nonlinear transitions:
  // growth stays at 1.5
  static constexpr double order = 5.0, max_growth = 1.5;
  __host__ __device__ static constexpr double a(int i, int j) {
    constexpr double A[NSTG][NSTG] = {
        {0, 0, 0, 0, 0, 0, 0},
        {gamma, 0, 0, 0, 0, 0, 0},
        {0.13, 0.84033320996790809, 0, 0, 0, 0, 0},
        {0.22371961478320505, 0.47675532319799699, -0.06470895363112615, 0, 0, 0, 0},
        {0.16648564323248321, 0.10450018841591720, 0.03631482272098715,
         -0.13090704451073998, 0, 0, 0},
        {0.13855640231268224, 0.0, -0.04245337201752043, 0.02446657898003141,
         0.61943039072480676, 0, 0},
        {0.13659751177640291, 0.0, -0.05496908796538376, -0.04118626728321046,
         0.62993304899016403, 0.06962479448202728, 0}};
    return A[i][j];
  }
  __host__ __device__ static constexpr double b(int i) {
    return i == NSTG - 1 ? gamma : a(NSTG - 1, i);
  }
  __host__ __device__ static constexpr double bhat(int i) {
    return i == NSTG - 1 ? 0.0 : (i == NSTG - 2 ? gamma : a(NSTG - 2, i));
  }
  __host__ __device__ static constexpr double c(int i) {
    constexpr double C[NSTG] = {0.0, 0.52, 1.230333209967908, 0.8957659843500759,
                                0.43639360985864756, 1.0, 1.0};
    return C[i];
  }
};

// The likelihood term of stream element i for an output value `pred` already
// contracted with the observation's output row (no bias yet): obs_term's own
// arithmetic from the bias on.
template <typename T>
__device__ __forceinline__ T obs_term_pred(const Args<T>& a, size_t i, int s,
                                           int k, T pred) {
  if (a.bias != nullptr) pred = pred + a.bias[(size_t)k * a.S + s];
  const T LOG_2PI = T(1.8378770664093454836);
  const T sig = a.obs_sigma[i];
  const T z = (a.obs_value[i] - pred) / sig;
  const T sc = a.obs_cens != nullptr ? a.obs_cens[i] : T(0);
  return sc == T(0) ? T(-0.5) * LOG_2PI - pm_log(sig) - T(0.5) * z * z
                    : log_ndtr(sc * z);
}

// Output row k of state vector xv: sum_j coef[k][j][s] xv[j].
template <typename T>
__device__ __forceinline__ T out_of(const Args<T>& a, int k, int s, const T* xv) {
  const T* ck = a.coef + (size_t)k * N * a.S + s;
  T v = ck[0] * xv[0];
#pragma unroll
  for (int j = 1; j < N; ++j) v = v + ck[(size_t)j * a.S] * xv[j];
  return v;
}

#endif  // PHARMSOL_ODE_SOLVER != 6

#if PHARMSOL_ODE_SOLVER != 6
// K2b: the adaptive SDIRK march of one call over `target` time from tc (the
// JAX kernel's `integrate_sdirk`, ops/pallas_ode.py:949-1150), split into
// its start (sdirk_begin), one trial (sdirk_trial) and its end (sdirk_end).
// Per trial: h_try = min(h, max(rem, 1e-14)); J at the step's start; Minv =
// (I - h_try gamma J)^-1 once; stage 0 explicit; each later stage starts
// from base + h gamma k_{i-1} and takes newton_iters rounds z -= Minv F(z),
// F(z) = z - base - h gamma f(z), then one more RHS for the stage slope and
// the WRMS of the residual. The step is finite only if the largest residual
// is <= 0.1 and the state moved by at most 10 (1 + max |x|); it is accepted
// if the embedded error ratio is <= 1 too. Interior observations of a merged
// run are captured by the cubic Hermite on (x0, f0, x1, f1), f1 the last
// stage slope (these pairs are stiffly accurate), contracted with the output
// row first. A lane that arrives non-finite or with no time to cover does not
// march; one that stalls or runs out of trials is NaN, and so are the
// captures it never reached. The TPU kernel's lane masks, its tile-wide loop
// condition and its halved tiles have no counterpart.
//
// Per thread: Minv[N][N], ks[NSTG][N], z, base, F, live within one trial
// only. The stage loop is unrolled (the tableau is a compile-time constant,
// zero weights are skipped as in the twin), the Newton loop is rolled.
template <typename T>
struct SdirkCall {
  int mm;      // next interior column
  T Tj;        // its offset from the run's start
  bool live0;  // the call marches at all (then it hands its step on)
};

template <typename T>
__device__ __forceinline__ void call_begin(const Args<T>& a, Lane<T>& L, SdirkCall<T>& C) {
  L.thr = L.target - T(1e-6) * pm_max(L.target, T(1e-30));
  C.live0 = L.target > T(0) && all_finite(L.x);
  C.mm = L.m0 + 1;
  C.Tj = a.seg_dt[L.row + L.m0];
  // zero-offset observations read the run's start state
  while (C.mm < L.m1 && C.Tj <= T(0)) {
    L.ll += obs_term(a, L.row + C.mm, L.s, L.x);
    C.Tj = C.Tj + a.seg_dt[L.row + C.mm];
    ++C.mm;
  }
  L.tau = T(0);
  L.hc = pm_min(L.h, pm_max(L.target, T(1e-14)));
  L.live = C.live0;
  L.it = 0;
}

template <typename T, int SOLVER>
__device__ __forceinline__ void call_trial(const Args<T>& a, Lane<T>& L, SdirkCall<T>& C) {
  using Tb = STab<SOLVER>;
  constexpr int NSTG = Tb::NSTG;
  const T rtol = a.rtol, atol = a.atol;
  const T gamma = T(Tb::gamma);
  T bz[NIN];
#pragma unroll
  for (int j = 0; j < NIN; ++j) bz[j] = T(0);
  T ks[NSTG][N];
  T Minv[N][N];
  const T ht = pm_min(L.hc, pm_max(L.target - L.tau, T(1e-14)));
  const T tb = L.tc + L.tau;
  const T hg = ht * gamma;
  newton_inverse<T>(L.x, L.p, tb, L.rate, L.ca, L.cb, hg, Minv);
  rhs<T>(L.x, L.p, tb, bz, L.rate, L.ca, L.cb, ks[0]);
  T resid_max = T(0);
#pragma unroll
  for (int i = 1; i < NSTG; ++i) {
    T base[N], z[N], F[N], dz[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      T acc = T(0);
      bool any = false;
#pragma unroll
      for (int l = 0; l < i; ++l) {
        if (Tb::a(i, l) != 0.0) {
          acc = any ? acc + ks[l][j] * T(Tb::a(i, l)) : ks[l][j] * T(Tb::a(i, l));
          any = true;
        }
      }
      base[j] = L.x[j] + ht * acc;
      z[j] = base[j] + hg * ks[i - 1][j];
    }
    const T t_st = tb + T(Tb::c(i)) * ht;
#pragma unroll 1
    for (int nit = 0; nit < a.newton_iters; ++nit) {
      rhs<T>(z, L.p, t_st, bz, L.rate, L.ca, L.cb, F);
#pragma unroll
      for (int j = 0; j < N; ++j) F[j] = z[j] - base[j] - hg * F[j];
      matvec<T>(Minv, F, dz);
#pragma unroll
      for (int j = 0; j < N; ++j) z[j] = z[j] - dz[j];
    }
    rhs<T>(z, L.p, t_st, bz, L.rate, L.ca, L.cb, ks[i]);
    T r2 = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const T Fs = z[j] - base[j] - hg * ks[i][j];
      const T q = Fs / (atol + rtol * pm_abs(z[j]));
      r2 = r2 + q * q;
    }
    resid_max = pm_max(resid_max, pm_sqrt(r2 / T(N)));
  }
  T xn[N];
  T err2 = T(0), growth = T(0), xmax = T(0);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T accb = T(0), acch = T(0);
    bool anyb = false, anyh = false;
#pragma unroll
    for (int l = 0; l < NSTG; ++l) {
      if (Tb::b(l) != 0.0) {
        accb = anyb ? accb + ks[l][j] * T(Tb::b(l)) : ks[l][j] * T(Tb::b(l));
        anyb = true;
      }
      if (Tb::bhat(l) != 0.0) {
        acch = anyh ? acch + ks[l][j] * T(Tb::bhat(l)) : ks[l][j] * T(Tb::bhat(l));
        anyh = true;
      }
    }
    xn[j] = L.x[j] + ht * accb;
    const T e = ht * (accb - acch);
    const T q = e / (atol + rtol * pm_max(pm_abs(L.x[j]), pm_abs(xn[j])));
    err2 = err2 + q * q;
    growth = pm_max(growth, pm_abs(xn[j] - L.x[j]));
    xmax = pm_max(xmax, pm_abs(L.x[j]));
  }
  const T ratio = pm_sqrt(err2 / T(N));
  // a Newton stage that did not converge invalidates the step; a tenfold
  // jump of the state is a spurious Newton root
  const bool finite = isfinite(ratio) && resid_max <= T(0.1) && all_finite(xn) &&
                      growth <= T(10) * (T(1) + xmax);
  const bool accept = ratio <= T(1) && finite;
  const T factor =
      finite ? pm_min(pm_max(T(0.9) * pm_pow(pm_max(ratio, T(1e-10)),
                                             T(-1.0 / (Tb::order + 1.0))),
                             T(0.2)), T(Tb::max_growth))
             : T(0.25);
  if (accept) {
    // cubic Hermite captures of the interior observations this step crosses
    while (C.mm < L.m1) {
      const T te = pm_min(C.Tj, L.thr);
      if (!(te <= L.tau + ht)) break;
      const size_t io = L.row + C.mm;
      if (a.obs_mask[io] > T(0)) {
        const int k = a.n_out > 1 ? (int)a.obs_outeq[io] : 0;
        T pred = T(0);
        if (k >= 0 && k < a.n_out) {
          const T th = (te - L.tau) / ht;
          const T c0 = out_of(a, k, L.s, L.x), c1 = out_of(a, k, L.s, xn);
          const T f0 = out_of(a, k, L.s, ks[0]), f1 = out_of(a, k, L.s, ks[NSTG - 1]);
          const T d = c1 - c0;
          const T a_ = ht * f0 - d;
          const T b_ = d - ht * f1;
          pred = c0 + th * d + th * (T(1) - th) * ((T(1) - th) * a_ + th * b_);
        }
        L.ll += obs_term_pred(a, io, L.s, k, pred);
      }
      C.Tj = C.Tj + a.seg_dt[io];
      ++C.mm;
    }
    L.tau = L.tau + ht;
#pragma unroll
    for (int j = 0; j < N; ++j) L.x[j] = xn[j];
  }
  L.hc = pm_max(ht * factor, T(1e-14));
  const bool done = L.tau >= L.thr;
  const bool stalled = (L.tau + L.hc) <= L.tau && !done;
  L.live = !done && !stalled;
  ++L.it;
}

template <typename T>
__device__ __forceinline__ void call_end(const Args<T>& a, Lane<T>& L, SdirkCall<T>& C) {
  if (L.tau < L.thr) {
#pragma unroll
    for (int j = 0; j < N; ++j) L.x[j] = T(NAN);
  }
  // captures an incomplete lane never reached
  T xnan[N];
#pragma unroll
  for (int j = 0; j < N; ++j) xnan[j] = T(NAN);
  for (; C.mm < L.m1; ++C.mm) L.ll += obs_term(a, L.row + C.mm, L.s, xnan);
  if (C.live0) L.h = L.hc;
}

template <typename T, int CAP>
struct CallOf {
  using type = SdirkCall<T>;
};
#else  // PHARMSOL_ODE_SOLVER == 6

// Variable-order BDF (1-5), fixed leading coefficient with the kappa
// stabilisation (SUNDIALS/ode15s): alpha, the gamma sums and the error
// constant of each order, the doubles of pharmsol_tpu_torch/engine/ode.py;
// and U = R(1), the involutory backward-difference transform (the JAX
// kernel's _bdf_U, ops/pallas_ode.py:312; ops/fused_ode.py::bdf_U). Every
// index into them is a compile-time constant: the loops over orders are
// unrolled to the kernel's largest order CAP and predicated on the lane's
// order, and a table entry at the lane's order is a chain of selects.
struct BdfAlpha {
  __host__ __device__ static constexpr double at(int k) {
    constexpr double BDF_ALPHA[6] = {0.0, 1.185, 1.6666666666666667,
                                     1.9842166666666667, 2.1697916666666663,
                                     2.283333333333333};
    return BDF_ALPHA[k];
  }
};
struct BdfGamma {
  __host__ __device__ static constexpr double at(int k) {
    constexpr double BDF_GAMMA[6] = {0.0, 1.0, 1.5, 1.8333333333333333,
                                     2.083333333333333, 2.283333333333333};
    return BDF_GAMMA[k];
  }
};
struct BdfErrorConst {
  __host__ __device__ static constexpr double at(int k) {
    constexpr double BDF_ERROR_CONST[6] = {1.0, 0.315, 0.16666666666666666,
                                           0.09911666666666669, 0.11354166666666668,
                                           0.16666666666666666};
    return BDF_ERROR_CONST[k];
  }
};
__host__ __device__ constexpr double bdf_u(int b, int c) {
  constexpr double BDF_U[6][6] = {
      {1.0, 1.0, 1.0, 1.0, 1.0, 1.0},
      {0.0, -1.0, -2.0, -3.0, -4.0, -5.0},
      {0.0, -0.0, 1.0, 3.0, 6.0, 10.0},
      {0.0, -0.0, 0.0, -1.0, -4.0, -10.0},
      {0.0, -0.0, 0.0, -0.0, 1.0, 5.0},
      {0.0, -0.0, 0.0, -0.0, 0.0, -1.0},
  };
  return BDF_U[b][c];
}

// c ? a : b, kept a select: the compiler folds a chain of selects (or of
// predicated stores) over the lane's order into one access at a computed
// index, and a D indexed at run time cannot stay in registers. Every access
// to D below is at a compile-time index and goes through keep_sel.
#if defined(__CUDA_ARCH__)
__device__ __forceinline__ float keep_sel(bool c, float a, float b) {
  float r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %3, 0;\n\tselp.f32 %0, %1, %2, p;\n\t}"
      : "=f"(r) : "f"(a), "f"(b), "r"((int)c));
  return r;
}
__device__ __forceinline__ double keep_sel(bool c, double a, double b) {
  double r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %3, 0;\n\tselp.f64 %0, %1, %2, p;\n\t}"
      : "=d"(r) : "d"(a), "d"(b), "r"((int)c));
  return r;
}
#else
template <typename T>
inline T keep_sel(bool c, T a, T b) { return c ? a : b; }
#endif

// Tab::at(k) for a run-time k in [LO, HI].
template <typename Tab, typename T, int LO, int HI>
__device__ __forceinline__ T bdf_at(int k) {
  T v = T(Tab::at(LO));
#pragma unroll
  for (int i = LO + 1; i <= HI; ++i) v = keep_sel(k == i, T(Tab::at(i)), v);
  return v;
}

// D[0..k] <- (R(fac) U)^T D[0..k] for a step-size change by `fac` at order k
// <= CAP: tmp = R^T D with R[0][j] = 1, R[i][0] = 0 (i >= 1), R[i][j] =
// R[i-1][j] (i - 1 - fac j) / i built by its recurrence column by column,
// then U^T tmp. The TPU kernel applies both as 6 x 6 transforms masked to the
// identity beyond each lane's order; a thread runs its own order's terms.
// Rows above k are untouched.
template <typename T, int CAP>
__device__ __forceinline__ void bdf_change_D(T (*D)[N], int k, T fac) {
  // every row to CAP is computed, the rows above k are left as they were
  T tmp[CAP + 1][N];
#pragma unroll
  for (int j = 0; j < N; ++j) tmp[0][j] = D[0][j];
#pragma unroll
  for (int c = 1; c <= CAP; ++c) {
    T acc[N];
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = D[0][j];
    T r = T(1);
#pragma unroll
    for (int b = 1; b <= CAP; ++b) {
      const T m = (T(b - 1) - fac * T(c)) / T(b);
      r = b == 1 ? m : r * m;
#pragma unroll
      for (int j = 0; j < N; ++j) acc[j] = keep_sel(b <= k, acc[j] + r * D[b][j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) tmp[c][j] = acc[j];
  }
#pragma unroll
  for (int c = 0; c <= CAP; ++c) {
    T acc[N];
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = T(0);
#pragma unroll
    for (int b = 0; b <= CAP; ++b) {
      const T u = T(bdf_u(b, c));
#pragma unroll
      for (int j = 0; j < N; ++j) acc[j] = keep_sel(b <= k, acc[j] + u * tmp[b][j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) D[c][j] = keep_sel(c <= k, acc[j], D[c][j]);
  }
}

template <typename T>
__device__ __forceinline__ T bdf_rms(T ec, const T* v, const T* scales) {
  T r2 = T(0);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const T q = (ec * v[j]) / scales[j];
    r2 = r2 + q * q;
  }
  return pm_sqrt(r2 / T(N));
}

// The step factor of an error norm at order k + dord. exp(log(.) * .), not
// pow: it is what the TPU kernel computes, and pow would move step decisions.
template <typename T>
__device__ __forceinline__ T bdf_fac(T e, int k, T dord) {
  return pm_exp(pm_log(pm_max(e, T(1e-16))) * (T(-1) / (T(k) + dord)));
}

// K2c: the variable-order BDF march of one call over `target` time from tc
// (the JAX kernel's `integrate_bdf`, ops/pallas_ode.py:1289-1612), orders 1
// to bdf_max_order <= CAP, split into its start (call_begin), one trial
// (call_trial) and its end (call_end). A thread holds the backward-difference
// array D[CAP + 3][N] in registers, its order, the count of equal steps since
// the last change (neq) and of rejections in a row (nrej). Per trial: the
// step is clipped to the remaining span and D rescaled to match; x_pred =
// sum_{i <= k} D[i], psi = sum gamma_i D[i] / alpha_k, c = h / alpha_k; J at
// (x_pred, t_new) and Minv = (I - c J)^-1 once; newton_iters rounds on (d,
// y); the error norm rms(error_const_k d) and the residual norm decide. An
// accepted step updates D (D[k+2] = d - D[k+1], D[k+1] = d, D[i] += D[i+1]
// downward); after k + 1 equal steps the order is chosen among k - 1, k, k + 1
// by the largest step factor, the middle winning ties. Beyond the general
// engine's controller: the third rejection in a row resets to order 1 at h /
// 4; an accept whose error is below 0.25 grows the step 1.4x at once. A lane
// that arrives non-finite leaves at once (it would otherwise burn the whole
// trial budget in every later segment). Never merged: there is no interior
// observation. The TPU kernel's float-valued order lanes with their near()
// bands and its masked transforms have no counterpart: the order is an int,
// and the loops over D are unrolled to CAP and predicated on it, so that D
// never leaves the registers.
template <typename T, int CAP>
struct BdfCall {
  T D[CAP + 3][N];
  int order, neq, nrej;
  bool entered;  // the call marches at all (then it hands its step on)
};

template <typename T, int CAP>
__device__ __forceinline__ void call_begin(const Args<T>& a, Lane<T>& L, BdfCall<T, CAP>& C) {
  L.thr = L.target - T(1e-6) * pm_max(L.target, T(1e-30));
  L.it = 0;
  C.entered = L.target > T(0) && all_finite(L.x);
  L.live = C.entered;
  if (!C.entered) {
    // dead on entry: no march; a lane with time to cover stays NaN
    if (T(0) < L.thr) {
#pragma unroll
      for (int j = 0; j < N; ++j) L.x[j] = T(NAN);
    }
    return;
  }
  T bz[NIN];
#pragma unroll
  for (int j = 0; j < NIN; ++j) bz[j] = T(0);
  L.hc = pm_min(L.h, pm_max(L.target, T(1e-14)));
  T f0[N];
  rhs<T>(L.x, L.p, L.tc, bz, L.rate, L.ca, L.cb, f0);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    C.D[0][j] = L.x[j];
    C.D[1][j] = L.hc * f0[j];
#pragma unroll
    for (int i = 2; i < CAP + 3; ++i) C.D[i][j] = T(0);
  }
  L.tau = T(0);
  C.order = 1;
  C.neq = 0;
  C.nrej = 0;
}

template <typename T, int SOLVER, int CAP>
__device__ __forceinline__ void call_trial(const Args<T>& a, Lane<T>& L, BdfCall<T, CAP>& C) {
  const int MAXO = a.bdf_max_order;
  const T rtol = a.rtol, atol = a.atol;
  T(*D)[N] = C.D;
  const int order = C.order;
  // clip the step to the remaining span, rescaling the history
  const T ht = pm_min(L.hc, pm_max(L.target - L.tau, T(1e-14)));
  const T fac_clip = ht / pm_max(L.hc, T(1e-30));
  if (fac_clip < T(1)) {
    bdf_change_D<T, CAP>(D, order, fac_clip);
    C.neq = 0;
  }
  const T alpha_k = pm_max(bdf_at<BdfAlpha, T, 1, CAP>(order), T(1e-30));
  const T c = ht / alpha_k;
  T x_pred[N], psi[N], scales[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    x_pred[j] = T(0);
    psi[j] = T(0);
  }
#pragma unroll
  for (int i = 0; i <= CAP; ++i) {
    const T gi = T(BdfGamma::at(i));
#pragma unroll
    for (int j = 0; j < N; ++j) {
      x_pred[j] = keep_sel(i <= order, x_pred[j] + D[i][j], x_pred[j]);
      if (i >= 1) psi[j] = keep_sel(i <= order, psi[j] + gi * D[i][j], psi[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    psi[j] = psi[j] / alpha_k;
    scales[j] = atol + rtol * pm_abs(x_pred[j]);
  }
  const T t_new = L.tc + L.tau + ht;
  T Minv[N][N];
  newton_inverse<T>(x_pred, L.p, t_new, L.rate, L.ca, L.cb, c, Minv);
  T bz[NIN];
#pragma unroll
  for (int j = 0; j < NIN; ++j) bz[j] = T(0);
  T d[N], y[N], res[N], step[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    d[j] = T(0);
    y[j] = x_pred[j];
  }
#pragma unroll 1
  for (int nit = 0; nit < a.newton_iters; ++nit) {
    rhs<T>(y, L.p, t_new, bz, L.rate, L.ca, L.cb, res);
#pragma unroll
    for (int j = 0; j < N; ++j) res[j] = c * res[j] - psi[j] - d[j];
    matvec<T>(Minv, res, step);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      d[j] = d[j] + step[j];
      y[j] = y[j] + step[j];
    }
  }
  rhs<T>(y, L.p, t_new, bz, L.rate, L.ca, L.cb, res);
#pragma unroll
  for (int j = 0; j < N; ++j) res[j] = c * res[j] - psi[j] - d[j];

  const T err_norm = bdf_rms<T>(bdf_at<BdfErrorConst, T, 1, CAP>(order), d, scales);
  const T res_norm = bdf_rms<T>(T(1), res, scales);
  const bool finite = isfinite(err_norm) && all_finite(y);
  const bool converged = res_norm <= T(0.1);
  const bool accept = err_norm <= T(1) && converged && finite;

  bool do_adapt = false;
  int order_n = order;
  T factor;
  if (accept) {
    // D[k+2] = d - D[k+1]; D[k+1] = d; D[i] += D[i+1] downward: D[0] is
    // the new solution
    // (downward, so that D[k+2] reads the old D[k+1])
#pragma unroll
    for (int i = CAP + 2; i >= 2; --i) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        D[i][j] = keep_sel(i == order + 2, d[j] - D[i - 1][j],
                           keep_sel(i == order + 1, d[j], D[i][j]));
    }
#pragma unroll
    for (int i = CAP; i >= 0; --i) {
#pragma unroll
      for (int j = 0; j < N; ++j) D[i][j] = keep_sel(i <= order, D[i][j] + D[i + 1][j], D[i][j]);
    }
    const int neq_acc = C.neq + 1;
    do_adapt = neq_acc > order;
    factor = T(1);
    if (do_adapt) {
      // the error norms at order - 1, order, order + 1: D[order] and
      // D[order + 2] picked by selects
      T dm[N], dp[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        dm[j] = D[1][j];
        dp[j] = D[3][j];
      }
#pragma unroll
      for (int i = 2; i <= CAP; ++i) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          dm[j] = keep_sel(order == i, D[i][j], dm[j]);
          dp[j] = keep_sel(order == i, D[i + 2][j], dp[j]);
        }
      }
      const int kp = order + 1 < 5 ? order + 1 : 5;
      const T err_m = bdf_rms<T>(bdf_at<BdfErrorConst, T, 0, CAP - 1>(order - 1), dm, scales);
      const T err_p = bdf_rms<T>(
          bdf_at<BdfErrorConst, T, 2, (CAP + 1 < 5 ? CAP + 1 : 5)>(kp), dp, scales);
      T f_m = bdf_fac<T>(err_m, order, T(0));
      const T f_0 = bdf_fac<T>(pm_max(err_norm, T(1e-16)), order, T(1));
      T f_p = bdf_fac<T>(err_p, order, T(2));
      f_m = (order > 1 && isfinite(f_m)) ? f_m : T(-1);
      f_p = (order < MAXO && isfinite(f_p)) ? f_p : T(-1);
      const bool best_p = f_p > f_0 && f_p > f_m;
      const bool best_m = f_m > f_0 && !best_p;
      order_n = order + (best_p ? 1 : (best_m ? -1 : 0));
      order_n = order_n < 1 ? 1 : (order_n > MAXO ? MAXO : order_n);
      const T fac_best = best_p ? f_p : (best_m ? f_m : f_0);
      factor = pm_min(pm_max(T(0.9) * fac_best, T(0.2)), T(10));
    }
    // the quasi-constant policy grows h only after order + 1 accepts in a
    // row: an accept whose error is clearly small grows 1.4x at once
    const bool grow_now = !do_adapt && err_norm < T(0.25);
    if (grow_now) factor = T(1.4);
    C.neq = (!do_adapt && !grow_now) ? neq_acc : 0;
    C.nrej = 0;
    L.tau = L.tau + ht;
  } else {
    factor = (finite && converged)
                 ? pm_min(pm_max(T(0.9) * bdf_fac<T>(pm_max(err_norm, T(1e-16)),
                                                     order, T(1)),
                                 T(0.2)), T(1))
                 : T(0.25);
    // the third rejection in a row resets to order 1 at h / 4: it clears a
    // high-order history whose error estimates cannot be trusted
    if (C.nrej >= 2) {
      order_n = 1;
      factor = T(0.25);
      C.nrej = 0;
    } else {
      C.nrej = C.nrej + 1;
    }
    C.neq = 0;
  }
  C.order = order_n;
  if (factor != T(1)) bdf_change_D<T, CAP>(D, order_n, factor);
  L.hc = pm_max(ht * factor, T(1e-14));
  const bool done = L.tau >= L.thr;
  const bool stalled = (L.tau + L.hc) <= L.tau && !done;
  L.live = !done && !stalled;
  ++L.it;
}

template <typename T, int CAP>
__device__ __forceinline__ void call_end(const Args<T>& a, Lane<T>& L, BdfCall<T, CAP>& C) {
  if (!C.entered) return;
#pragma unroll
  for (int j = 0; j < N; ++j) L.x[j] = L.tau < L.thr ? T(NAN) : C.D[0][j];
  L.h = L.hc;
}

template <typename T, int CAP>
struct CallOf {
  using type = BdfCall<T, CAP>;
};
#endif  // PHARMSOL_ODE_SOLVER == 6
#endif  // PHARMSOL_ODE_SOLVER

// A bolus of `amt` into RHS input `in` at time t: x += f(x, b) - f(x, 0),
// the general engine's own semantics.
// (pre, fixed: the run's covariate-only terms, as rhs_run.)
template <typename T>
__device__ __forceinline__ void dose(T* x, const T* p, T t, int in, T amt,
                                     const T* rate, const T* ca,
                                     const T* cb, const T* pre = nullptr,
                                     bool fixed = false) {
  T bv[NIN], bz[NIN], dw[N], dz[N];
#pragma unroll
  for (int j = 0; j < NIN; ++j) {
    bv[j] = (j == in) ? amt : T(0);
    bz[j] = T(0);
  }
  rhs_run<T>(pre, fixed, x, p, t, bv, rate, ca, cb, dw);
  rhs_run<T>(pre, fixed, x, p, t, bz, rate, ca, cb, dz);
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = x[j] + (dw[j] - dz[j]);
}

#if !defined(PHARMSOL_ODE_SOLVER) && !defined(PHARMSOL_RHS_HAS_JVP)
// K2a, K2e: the adaptive march of one call over `target` time from tc (the
// JAX kernel's `integrate`, explicit tier), split into its start
// (call_begin), one trial (call_trial) and its end (call_end). Observation
// terms of the run's interior columns m0+1..m1-1 are added to ll in column
// order. The slope at the step's start (FSAL: the last stage of the accepted
// step) carries from trial to trial; the other stages live within a trial.
template <typename T>
struct RkCall {
  T k1[N];     // the slope at the step's start
  int mm;      // next interior column
  T Tj;        // its offset from the run's start
  bool live0;  // the call marches at all (then it hands its step on)
};

template <typename T>
__device__ __forceinline__ void rhs_lane(const Lane<T>& L, const T* x, T t, const T* b,
                                         T* dx) {
  rhs_run<T>(L.pre, L.fixed, x, L.p, t, b, L.rate, L.ca, L.cb, dx);
}

// The trial's RHS: with PRE, rhs_body on the run's covariate-only terms (a
// run without a slope), else rhs. A compile-time choice, so that each
// trial's code holds one RHS and no branch around the covariate terms.
template <bool PRE, typename T>
__device__ __forceinline__ void rhs_trial(const Lane<T>& L, const T* x, T t, const T* b,
                                          T* dx) {
#if PHARMSOL_RHS_NPRE > 0
  if (PRE) {
    rhs_body<T>(x, L.p, t, b, L.rate, L.ca, L.cb, L.pre, dx);
    return;
  }
#endif
  rhs<T>(x, L.p, t, b, L.rate, L.ca, L.cb, dx);
}

// The call's start: the zero-offset observations read the run's start
// state; the starting slope, which a call with no time to cover (or a lane
// that arrives non-finite) does not need; on the first run's first pass the
// Hairer-Norsett-Wanner II.4 starting step, floored at h0.
template <typename T>
__device__ __forceinline__ void call_begin(const Args<T>& a, Lane<T>& L, RkCall<T>& C) {
  const T rtol = a.rtol, atol = a.atol;
  T bz[NIN];
#pragma unroll
  for (int j = 0; j < NIN; ++j) bz[j] = T(0);
  L.thr = L.target - T(1e-6) * pm_max(L.target, T(1e-30));
  C.live0 = L.target > T(0) && all_finite(L.x);
  C.mm = L.m0 + 1;
  C.Tj = a.seg_dt[L.row + L.m0];
  while (C.mm < L.m1 && C.Tj <= T(0)) {
    L.ll += obs_term(a, L.row + C.mm, L.s, L.x);
    C.Tj = C.Tj + a.seg_dt[L.row + C.mm];
    ++C.mm;
  }
  const bool estimate_h = L.m0 == 0 && L.pass == 0;
  if (C.live0 || estimate_h) rhs_lane(L, L.x, L.tc, bz, C.k1);
  if (estimate_h) {
    T d0 = T(0), d1 = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const T sc = atol + rtol * pm_abs(L.x[j]);
      d0 = d0 + (L.x[j] / sc) * (L.x[j] / sc);
      d1 = d1 + (C.k1[j] / sc) * (C.k1[j] / sc);
    }
    d0 = pm_sqrt(d0 / T(N));
    d1 = pm_sqrt(d1 / T(N));
    const T h0a = (d0 > T(1e-5) && d1 > T(1e-5))
                      ? T(0.01) * d0 / pm_max(d1, T(1e-30)) : T(1e-6);
    T x1[N], f1[N];
#pragma unroll
    for (int j = 0; j < N; ++j) x1[j] = L.x[j] + h0a * C.k1[j];
    rhs_lane(L, x1, L.tc + h0a, bz, f1);
    T d2 = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const T sc = atol + rtol * pm_abs(L.x[j]);
      const T q = (f1[j] - C.k1[j]) / sc;
      d2 = d2 + q * q;
    }
    d2 = pm_sqrt(d2 / T(N)) / h0a;
    const T dmax = pm_max(d1, d2);
    const T h1 = dmax > T(1e-15)
                     ? pm_pow(T(0.01) / pm_max(dmax, T(1e-30)), T(0.2))
                     : pm_max(T(1e-6), h0a * T(1e3));
    const T h_est = pm_min(T(100) * h0a, h1);
    if (isfinite(h_est)) L.h = pm_max(h_est, a.h0);
  }
  L.tau = T(0);
  L.hc = pm_min(L.h, pm_max(L.target, T(1e-14)));
  L.live = C.live0;
  L.it = 0;
}

// One trial step of the embedded pair: six stages, the I-controller (growth
// in [0.2, 5]), and on an accept the dense-output captures of the interior
// observations the step crosses, from the tableau's quartic interpolant at
// T_eff = min(T, target - 1e-6 target).
template <typename T, int SOLVER, bool PRE>
__device__ __forceinline__ void call_trial(const Args<T>& a, Lane<T>& L, RkCall<T>& C) {
  using Tb = Tab<SOLVER>;
  const T rtol = a.rtol, atol = a.atol;
  T bz[NIN];
#pragma unroll
  for (int j = 0; j < NIN; ++j) bz[j] = T(0);
  T ks[NS][N];
#pragma unroll
  for (int j = 0; j < N; ++j) ks[0][j] = C.k1[j];
  const T ht = pm_min(L.hc, pm_max(L.target - L.tau, T(1e-14)));
#pragma unroll
  for (int i = 1; i < NS; ++i) {
    T xi[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      T acc = T(0);
      bool any = false;
#pragma unroll
      for (int l = 0; l < i; ++l) {
        if (Tb::a(i, l) != 0.0) {
          acc = any ? acc + ks[l][j] * T(Tb::a(i, l)) : ks[l][j] * T(Tb::a(i, l));
          any = true;
        }
      }
      xi[j] = L.x[j] + ht * acc;
    }
    rhs_trial<PRE>(L, xi, L.tc + L.tau + T(Tb::c(i)) * ht, bz, ks[i]);
  }
  T xn[N];
  T err2 = T(0);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T accb = T(0), acce = T(0);
    bool anyb = false, anye = false;
#pragma unroll
    for (int l = 0; l < NS; ++l) {
      if (Tb::b(l) != 0.0) {
        accb = anyb ? accb + ks[l][j] * T(Tb::b(l)) : ks[l][j] * T(Tb::b(l));
        anyb = true;
      }
      if (Tb::e(l) != 0.0) {
        acce = anye ? acce + ks[l][j] * T(Tb::e(l)) : ks[l][j] * T(Tb::e(l));
        anye = true;
      }
    }
    xn[j] = L.x[j] + ht * accb;
    const T scale = atol + rtol * pm_max(pm_abs(L.x[j]), pm_abs(xn[j]));
    const T q = (ht * acce) / scale;
    err2 = err2 + q * q;
  }
  const T ratio = pm_sqrt(err2 / T(N));
  const bool finite = isfinite(ratio) && all_finite(xn);
  const bool accept = ratio <= T(1) && finite;
  const T factor =
      finite ? pm_min(pm_max(T(0.9) * pm_pow(pm_max(ratio, T(1e-10)), T(-0.2)),
                             T(0.2)), T(5.0))
             : T(0.25);
  if (accept) {
    // dense-output captures of the interior observations this step crosses
    while (C.mm < L.m1) {
      const T te = pm_min(C.Tj, L.thr);
      if (!(te <= L.tau + ht)) break;
      const T th = (te - L.tau) / ht;
      T xt[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T acc = T(0);
#pragma unroll
        for (int l = 0; l < NS; ++l) {
          const T* P = a.dense + 4 * l;
          acc = acc + ks[l][j] * (P[0] + th * (P[1] + th * (P[2] + th * P[3])));
        }
        xt[j] = L.x[j] + ht * th * acc;
      }
      L.ll += obs_term(a, L.row + C.mm, L.s, xt);
      C.Tj = C.Tj + a.seg_dt[L.row + C.mm];
      ++C.mm;
    }
    L.tau = L.tau + ht;
#pragma unroll
    for (int j = 0; j < N; ++j) L.x[j] = xn[j];
    if (all_finite(ks[NS - 1])) {
#pragma unroll
      for (int j = 0; j < N; ++j) C.k1[j] = ks[NS - 1][j];
    }
  }
  L.hc = pm_max(ht * factor, T(1e-14));
  const bool done = L.tau >= L.thr;
  const bool stalled = (L.tau + L.hc) <= L.tau && !done;
  L.live = !done && !stalled;
  ++L.it;
}

// The call's end: a lane that stalls or runs out of trials is NaN, and so
// are the captures it never reached; a call that marched hands its step on.
template <typename T>
__device__ __forceinline__ void call_end(const Args<T>& a, Lane<T>& L, RkCall<T>& C) {
  if (L.tau < L.thr) {
#pragma unroll
    for (int j = 0; j < N; ++j) L.x[j] = T(NAN);
  }
  T xnan[N];
#pragma unroll
  for (int j = 0; j < N; ++j) xnan[j] = T(NAN);
  for (; C.mm < L.m1; ++C.mm) L.ll += obs_term(a, L.row + C.mm, L.s, xnan);
  if (C.live0) L.h = L.hc;
}
#endif  // the explicit tier

// The fa scale of bolus plane k at segment m (K2e; 1 without fa).
template <typename T>
__device__ __forceinline__ T fa_scale(const Args<T>& a, int k, int m,
                                      size_t rs) {
  if (a.f.n_fa == 0) return T(1);
  const int slot = a.f.fa_slots[k * a.M + m];
  return slot < 0 ? T(1) : a.f.fa[(size_t)slot * a.R * a.S + rs];
}

#if defined(PHARMSOL_RHS_HAS_JVP) && !defined(PHARMSOL_ODE_SOLVER)
// K2d: one thread per (row, support) cell, a warp on 32 supports of one row
// (see the layout above), one exact propagation per pass.
template <typename T, int SOLVER, bool FEAT>
__global__ void __launch_bounds__(256) fused_ode_kernel(const Args<T> a) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= a.S) return;
  T p[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) p[j] = a.params[(size_t)j * a.S + s];
  const size_t RM = (size_t)a.R * a.M;

  for (int r = blockIdx.y * blockDim.y + threadIdx.y; r < a.R;
       r += gridDim.y * blockDim.y) {
    const size_t row = (size_t)r * a.M;
    const size_t rs = (size_t)r * a.S + s;  // this cell in an [R, S] plane
    T x[N];
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = T(0);
    if (FEAT && a.f.init_mask != nullptr) {
      // occasion-0 rows start from init (t = 0), the others from zero
      const T im = a.f.init_mask[r];
#pragma unroll
      for (int j = 0; j < N; ++j)
        x[j] = im * (a.f.init_planes != nullptr
                         ? a.f.init_planes[(size_t)j * a.R * a.S + rs]
                         : a.f.init_rows[(size_t)j * a.S + s]);
    }
    T ll = T(0);
    T ca[NC], cb[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) ca[c] = cb[c] = T(0);
    // each bolus plane's pending (lagged) dose: amount and time to fire
    T pend_amt[NIN], pend_rem[NIN];
#pragma unroll
    for (int k = 0; k < NIN; ++k) pend_amt[k] = pend_rem[k] = T(0);

    for (int ri = 0; ri < a.n_runs; ++ri) {
      const int m0 = a.runs[ri], m1 = a.runs[ri + 1];
      const size_t i0 = row + m0;
      // 1. the observation at the run's start, before its dose
      ll += obs_term(a, i0, s, x);
      // the run's infusion rates, one per RHS input
      T rate[NIN];
#pragma unroll
      for (int j = 0; j < NIN; ++j) rate[j] = T(0);
      for (int k = 0; k < a.nr; ++k) {
        const T v = a.seg_rate[k * RM + i0];
        const int in = a.rate_in[k];
#pragma unroll
        for (int j = 0; j < NIN; ++j) rate[j] = (j == in) ? v : rate[j];
      }
      const T t0 = a.seg_t0[i0];
      if (FEAT && NCOV > 0) {
        // the run's covariates (a merged run's streams do not change)
#pragma unroll
        for (int c = 0; c < NCOV; ++c) {
          ca[c] = a.f.cov_a[c * RM + i0];
          cb[c] = a.f.cov_b != nullptr ? a.f.cov_b[c * RM + i0] : T(0);
        }
      }
      if (!FEAT || a.f.n_lag == 0) {
        // 2. boluses by the RHS difference, input by input (fa-scaled)
        for (int k = 0; k < a.nb; ++k) {
          T amt = a.seg_bolus[k * RM + i0];
          if (amt == T(0)) continue;
          if (FEAT) amt = amt * fa_scale(a, k, m0, rs);
          dose(x, p, t0, a.bolus_in[k], amt, rate, ca, cb);
        }
        // 3. the adaptive march over the run; its length summed as the JAX
        // kernel does
        T target = a.seg_dt[i0];
        for (int mm = m0 + 1; mm < m1; ++mm) target = target + a.seg_dt[row + mm];
        march_expm<T>(x, p, rate, ca, cb, t0, target);
        continue;
      }
      // K2e with lag: the split march of one segment (runs are single
      // segments). 2a. doses due at this breakpoint fire after its
      // observation
#pragma unroll
      for (int k = 0; k < NIN; ++k) {
        if (k >= a.nb) break;
        if (pend_amt[k] != T(0) && pend_rem[k] <= T(0)) {
          dose(x, p, t0, a.bolus_in[k], pend_amt[k], rate, ca, cb);
          pend_amt[k] = T(0);
        }
      }
      // 2b. arrivals park with their lag
#pragma unroll
      for (int k = 0; k < NIN; ++k) {
        if (k >= a.nb) break;
        const int slot = a.f.lag_slots[k * a.M + m0];
        if (slot < 0) continue;
        const T bol = a.seg_bolus[k * RM + i0];
        if (bol != T(0)) {
          pend_amt[k] = pend_amt[k] + bol * fa_scale(a, k, m0, rs);
          pend_rem[k] = a.f.lag[(size_t)slot * a.R * a.S + rs];
        }
      }
      // 3. one pass per bolus plane to the next earliest fire time, then to
      // the segment's end
      const T dt = a.seg_dt[i0];
      T elapsed = T(0);
#pragma unroll
      for (int pass = 0; pass < NIN; ++pass) {
        if (pass >= a.nb) break;
        bool will[NIN];
        T t_next = dt;
#pragma unroll
        for (int k = 0; k < NIN; ++k) {
          will[k] = k < a.nb && pend_amt[k] != T(0) && pend_rem[k] < dt;
          t_next = pm_min(t_next, will[k] ? pend_rem[k] : dt);
        }
        t_next = pm_max(t_next, elapsed);
        march_expm<T>(x, p, rate, ca, cb, t0 + elapsed, t_next - elapsed);
#pragma unroll
        for (int k = 0; k < NIN; ++k) {
          if (will[k] && pend_rem[k] <= t_next) {
            dose(x, p, t0 + t_next, a.bolus_in[k], pend_amt[k], rate, ca, cb);
            pend_amt[k] = T(0);
          }
        }
        elapsed = t_next;
      }
      march_expm<T>(x, p, rate, ca, cb, t0 + elapsed, dt - elapsed);
      if (dt > T(0)) {
#pragma unroll
        for (int k = 0; k < NIN; ++k)
          if (pend_amt[k] != T(0)) pend_rem[k] = pend_rem[k] - dt;
      }
    }
    a.out[(size_t)r * a.S + s] = ll;
  }
}

template <typename T, int SOLVER, bool FEAT>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  if (a.R <= 0 || a.S <= 0) return cudaSuccess;
  const dim3 block(128, 2);
  const unsigned gx = (unsigned)((a.S + block.x - 1) / block.x);
  unsigned gy = (unsigned)((a.R + block.y - 1) / block.y);
  if (gy > 65535u) gy = 65535u;
  fused_ode_kernel<T, SOLVER, FEAT><<<dim3(gx, gy), block, 0, stream>>>(a);
  return cudaGetLastError();
}
#endif  // K2d

#if !defined(PHARMSOL_RHS_HAS_JVP) || defined(PHARMSOL_ODE_SOLVER)
// The persistent grids' lanes (the explicit and implicit tiers).
// The cells of lane g in a grid of `lanes` lanes, in support-major order
// (cell c is row c mod R of support c / R, so that the 32 lanes of a warp
// start on neighbouring rows of one support, whose marches take the same
// branches more often than those of 32 supports of one row): pass k covers
// the cells [k lanes, (k + 1) lanes), one a lane, rotated by one warp a pass,
// so that a lane does not meet the same row in every pass where `lanes` is a
// multiple of R: cell k lanes + o, o = (g + 32 k) mod lanes
// (ops/fused_ode.py::implicit_lane_cell). The walk keeps the cell's row and
// support and steps by lanes + 32, or by 32 where o wraps, without a division.
struct CellWalk {
  long long c;             // the cell, support-major over [R, S]
  int row, support, o;     // its row and support; (g + 32 k) mod lanes
  int lanes, R;
  int q_far, r_far, q_near, r_near;  // lanes + 32 and 32 as supports and rows

  __device__ __forceinline__ void start(int g, int lanes_, int R_) {
    lanes = lanes_;
    R = R_;
    o = g;
    c = g;
    support = g / R;
    row = g - support * R;
    q_far = (lanes + 32) / R;
    r_far = lanes + 32 - q_far * R;
    q_near = 32 / R;
    r_near = 32 - q_near * R;
  }
  __device__ __forceinline__ void next() {
    const bool wrap = o + 32 >= lanes;
    o = wrap ? o + 32 - lanes : o + 32;
    c += wrap ? 32 : lanes + 32;
    support += wrap ? q_near : q_far;
    row += wrap ? r_near : r_far;
    if (row >= R) {
      row -= R;
      ++support;
    }
  }
};

template <typename T, bool FEAT>
__device__ __forceinline__ void start_cell(const Args<T>& a, Lane<T>& L, int r, int s) {
  L.s = s;
  L.row = (size_t)r * a.M;
  L.rs = (size_t)r * a.S + L.s;
#pragma unroll
  for (int j = 0; j < NP; ++j) L.p[j] = a.params[(size_t)j * a.S + L.s];
#pragma unroll
  for (int j = 0; j < N; ++j) L.x[j] = T(0);
  if (FEAT && a.f.init_mask != nullptr) {
    // occasion-0 rows start from init (t = 0), the others from zero
    const T im = a.f.init_mask[r];
#pragma unroll
    for (int j = 0; j < N; ++j)
      L.x[j] = im * (a.f.init_planes != nullptr
                         ? a.f.init_planes[(size_t)j * a.R * a.S + L.rs]
                         : a.f.init_rows[(size_t)j * a.S + L.s]);
  }
  L.ll = T(0);
  L.h = a.h0;
#pragma unroll
  for (int c = 0; c < NC; ++c) L.ca[c] = L.cb[c] = T(0);
#pragma unroll
  for (int k = 0; k < NIN; ++k) L.pend_amt[k] = L.pend_rem[k] = T(0);
  L.ri = -1;
  L.pass = 0;
  L.live = false;
  L.it = 0;
}

// With lag: the end of the segment's next pass, from its start (the earliest
// pending fire before the segment's end, not before what was marched), and
// which bolus planes may fire there.
template <typename T>
__device__ __forceinline__ T lag_next(const Args<T>& a, const Lane<T>& L, T dt, bool* will) {
  T t_next = dt;
#pragma unroll
  for (int k = 0; k < NIN; ++k) {
    will[k] = k < a.nb && L.pend_amt[k] != T(0) && L.pend_rem[k] < dt;
    t_next = pm_min(t_next, will[k] ? L.pend_rem[k] : dt);
  }
  return pm_max(t_next, L.elapsed);
}

// With lag: the march call of pass L.pass of the segment (one pass per bolus
// plane to the next fire time, the last to the segment's end).
template <typename T>
__device__ __forceinline__ void lag_call(const Args<T>& a, Lane<T>& L, T dt, int npass) {
  L.tc = L.t0 + L.elapsed;
  if (L.pass < npass) {
    bool will[NIN];
    L.target = lag_next(a, L, dt, will) - L.elapsed;
  } else {
    L.target = dt - L.elapsed;
  }
}

// The work between the lane's march call that ended (if any) and its next
// one, as the parent's per-row loop does it: with lag, the fires at the end
// of a pass; at a run's start the observation term (read before the dose),
// the run's rates and covariates, and the boluses by the RHS difference (fa-
// scaled; with lag the fires due at the breakpoint and the arrivals parked
// with their lag). Sets the next call's columns, start and length; false when
// the cell has no further call.
template <typename T, bool FEAT>
__device__ __forceinline__ bool next_call(const Args<T>& a, Lane<T>& L) {
  const bool lag = FEAT && a.f.n_lag > 0;
  const int npass = a.nb < NIN ? a.nb : NIN;
  const size_t RM = (size_t)a.R * a.M;
  if (lag && L.ri >= 0) {
    const T dt = a.seg_dt[L.row + L.m0];
    if (L.pass < npass) {
      // the pass that ended: the doses due at its end fire there (what the
      // pass's end was computed from has not changed)
      bool will[NIN];
      const T t_next = lag_next(a, L, dt, will);
#pragma unroll
      for (int k = 0; k < NIN; ++k) {
        if (will[k] && L.pend_rem[k] <= t_next) {
          dose(L.x, L.p, L.t0 + t_next, a.bolus_in[k], L.pend_amt[k], L.rate, L.ca, L.cb,
               L.pre, L.fixed);
          L.pend_amt[k] = T(0);
        }
      }
      L.elapsed = t_next;
      ++L.pass;
      lag_call(a, L, dt, npass);
      return true;
    }
    // the segment's last pass ended
    if (dt > T(0)) {
#pragma unroll
      for (int k = 0; k < NIN; ++k)
        if (L.pend_amt[k] != T(0)) L.pend_rem[k] = L.pend_rem[k] - dt;
    }
  }
  if (++L.ri >= a.n_runs) return false;
  L.m0 = a.runs[L.ri];
  L.m1 = a.runs[L.ri + 1];
  const size_t i0 = L.row + L.m0;
  // 1. the observation at the run's start, before its dose
  L.ll += obs_term(a, i0, L.s, L.x);
  // the run's infusion rates, one per RHS input
#pragma unroll
  for (int j = 0; j < NIN; ++j) L.rate[j] = T(0);
  for (int k = 0; k < a.nr; ++k) {
    const T v = a.seg_rate[k * RM + i0];
    const int in = a.rate_in[k];
#pragma unroll
    for (int j = 0; j < NIN; ++j) L.rate[j] = (j == in) ? v : L.rate[j];
  }
  L.t0 = a.seg_t0[i0];
  if (FEAT && NCOV > 0) {
    // the run's covariates (a merged run's streams do not change)
#pragma unroll
    for (int c = 0; c < NCOV; ++c) {
      L.ca[c] = a.f.cov_a[c * RM + i0];
      L.cb[c] = a.f.cov_b != nullptr ? a.f.cov_b[c * RM + i0] : T(0);
    }
  }
  // the explicit tier: the run's covariate-only RHS terms, once, where no
  // covariate has a slope (cov_a + 0 t == cov_a: rhs's own values)
  L.fixed = true;
#pragma unroll
  for (int c = 0; c < NCOV; ++c) L.fixed = L.fixed && L.cb[c] == T(0);
#if PHARMSOL_RHS_NPRE > 0
  if (L.fixed) rhs_pre<T>(L.p, L.t0, L.ca, L.cb, L.pre);
#endif
  if (!lag) {
    // 2. boluses by the RHS difference, input by input (fa-scaled)
    for (int k = 0; k < a.nb; ++k) {
      T amt = a.seg_bolus[k * RM + i0];
      if (amt == T(0)) continue;
      if (FEAT) amt = amt * fa_scale(a, k, L.m0, L.rs);
      dose(L.x, L.p, L.t0, a.bolus_in[k], amt, L.rate, L.ca, L.cb,
               L.pre, L.fixed);
    }
    // 3. the march over the run; its length summed as the JAX kernel does
    T target = a.seg_dt[i0];
    for (int mm = L.m0 + 1; mm < L.m1; ++mm) target = target + a.seg_dt[L.row + mm];
    L.tc = L.t0;
    L.target = target;
    return true;
  }
  // K2e with lag: the split march of one segment (runs are single
  // segments). 2a. doses due at this breakpoint fire after its observation
#pragma unroll
  for (int k = 0; k < NIN; ++k) {
    if (k < a.nb && L.pend_amt[k] != T(0) && L.pend_rem[k] <= T(0)) {
      dose(L.x, L.p, L.t0, a.bolus_in[k], L.pend_amt[k], L.rate, L.ca, L.cb,
               L.pre, L.fixed);
      L.pend_amt[k] = T(0);
    }
  }
  // 2b. arrivals park with their lag
#pragma unroll
  for (int k = 0; k < NIN; ++k) {
    const int slot = k < a.nb ? a.f.lag_slots[k * a.M + L.m0] : -1;
    if (slot >= 0) {
      const T bol = a.seg_bolus[k * RM + i0];
      if (bol != T(0)) {
        L.pend_amt[k] = L.pend_amt[k] + bol * fa_scale(a, k, L.m0, L.rs);
        L.pend_rem[k] = a.f.lag[(size_t)slot * a.R * a.S + L.rs];
      }
    }
  }
  // 3. one pass per bolus plane to the next earliest fire time, then to the
  // segment's end
  L.m1 = L.m0 + 1;
  L.elapsed = T(0);
  L.pass = 0;
  lag_call(a, L, a.seg_dt[i0], npass);
  return true;
}
#endif  // the persistent grids

#if !defined(PHARMSOL_ODE_SOLVER) && !defined(PHARMSOL_RHS_HAS_JVP)
// The explicit tier's kernel (K2a, K2e): the implicit tiers' persistent
// grid and lane loop (below), with the warp rejoined at every march call.
// A lane marches the cells CellWalk gives it (support-major: a warp on 32
// neighbouring rows of one support), one trial a pass; a lane whose call has
// ended waits until every lane of its warp has ended its own, and then they
// take their boundaries together (a call's end, the next call's start or the
// end of the cell, its psi written and the next cell started). The explicit
// calls are short and many (K2e: two a segment with lag, seven of its
// sixteen a cell without a trial), so a boundary costs a large share of a
// trial, and a warp whose lanes took them apart would pay one in almost
// every pass (chip_smoke.py::explicit_layout_costs); the rows of one
// support share its parameters, lag and grid, so their calls need nearly
// the same trials. Blocks of EXPLICIT_THREADS, as many as the card holds at
// once (fused_ode_explicit_occupancy). Every trial and every start and end
// of a call is the per-row kernel's arithmetic, in its order; a cell's psi
// does not depend on the lane that marched it.
//
// What bounds it: the trial's instructions (six RHS, the stage and error
// sums, the error norm's divisions and square root, the controller's pow)
// and in float64 the resident warps; a covariate's pow moves out of the
// stages into rhs_pre, once per run (rhs_run).
constexpr int EXPLICIT_THREADS = 128;

template <typename T, int SOLVER, bool FEAT>
__global__ void __launch_bounds__(EXPLICIT_THREADS) fused_ode_explicit_kernel(const Args<T> a) {
  const long long cells = (long long)a.R * a.S;
  CellWalk W;
  W.start(blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x, a.R);
  Lane<T> L;
  RkCall<T> C;
  // a lane without a cell stays in the loop, done, until its warp is done
  bool done = W.c >= cells;
  if (!done) start_cell<T, FEAT>(a, L, W.row, W.support);
  bool in_call = false;
  // One pass of this loop is one trial of the warp's march calls, or their
  // boundary: every lane's call ended (or the lane is done).
  for (;;) {
    const bool ended = !done && !(L.live && L.it < a.max_iters);
    if (__all_sync(0xffffffffu, ended || done) && ended) {
      if (in_call) call_end(a, L, C);
      in_call = next_call<T, FEAT>(a, L);
      if (in_call) {
        call_begin(a, L, C);
      } else {
        a.out[L.rs] = L.ll;
        W.next();
        done = W.c >= cells;
        if (!done) start_cell<T, FEAT>(a, L, W.row, W.support);
      }
    }
    if (__all_sync(0xffffffffu, done)) break;
    if (!done && L.live && L.it < a.max_iters) {
      // a run without a covariate slope: the trial without the covariate
      // terms (one path for the warp where its rows share their knots)
      if (NPRE > 0 && L.fixed) {
        call_trial<T, SOLVER, true>(a, L, C);
      } else {
        call_trial<T, SOLVER, false>(a, L, C);
      }
    }
  }
}

template <typename T, int SOLVER, bool FEAT>
cudaError_t explicit_occupancy(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fused_ode_explicit_kernel<T, SOLVER, FEAT>, EXPLICIT_THREADS, 0);
}

// The persistent grid: `blocks` blocks (<= 0: as many as the card holds at
// once), never more than the cells need.
template <typename T, int SOLVER, bool FEAT>
cudaError_t launch_explicit(const Args<T>& a, int blocks, cudaStream_t stream) {
  if (a.R <= 0 || a.S <= 0) return cudaSuccess;
  if (blocks <= 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = explicit_occupancy<T, SOLVER, FEAT>(&per_sm);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    blocks = sms * per_sm;
  }
  const long long need = ((long long)a.R * a.S + EXPLICIT_THREADS - 1) / EXPLICIT_THREADS;
  if (blocks > need) blocks = (int)need;
  fused_ode_explicit_kernel<T, SOLVER, FEAT><<<blocks, EXPLICIT_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool FEAT>
cudaError_t explicit_occupancy_for(int solver, int* blocks) {
  switch (solver) {
    case 0: return explicit_occupancy<T, 0, FEAT>(blocks);
    case 1: return explicit_occupancy<T, 1, FEAT>(blocks);
    default: return cudaErrorInvalidValue;
  }
}
#endif  // the explicit tier

#if defined(PHARMSOL_ODE_SOLVER)
// The implicit tiers' kernel (K2b, K2c). The explicit tiers' layout (a warp
// on 32 supports of one row, one march call per run for every lane) makes a
// warp wait for its slowest lane in every run: on the TMDD stiff cell 28% of
// bdf's lane-slots and 40% of kvaerno5's would idle. Here a lane marches its
// cells end to end in one loop, each pass one trial: a lane whose march call
// ends does that call's end and the next call's start (the run's observation
// term, rates, covariates and boluses, or the next pass of a lagged segment)
// before its next trial, and a lane whose cell ends writes its psi and takes
// its next cell (CellWalk) at once. The grid is persistent: as many blocks as
// the card holds at once (fused_ode_occupancy), IMPLICIT_THREADS threads
// each. Every trial and every start and end of a call is the same arithmetic
// as the twin's, in its order; a cell's psi does not depend on the lane that
// marched it.
//
// What bounds it: the warp issues the union of its lanes' paths, so a pass
// costs a trial plus every branch some lane takes (a rejection, an order
// change, a capture, a boundary). Lanes on neighbouring rows of one support
// take the same branches far more often than lanes on 32 supports, hence the
// support-major walk; the warp meets before each trial (__all_sync), or the
// lanes that took a boundary would run the trial apart from the others.
constexpr int IMPLICIT_THREADS = 128;

// No minimum of resident blocks: ptxas keeps D and the stage slopes in
// registers without a spill (K2c at the TMDD: 96 / 158 registers in float32 /
// float64, 5 / 3 blocks an SM); a bound that buys more warps spills them.
template <typename T, int SOLVER, bool FEAT, int CAP>
__global__ void __launch_bounds__(IMPLICIT_THREADS) fused_ode_implicit_kernel(const Args<T> a) {
  static_assert(SOLVER == PHARMSOL_ODE_SOLVER, "this library holds one implicit solver");
  const long long cells = (long long)a.R * a.S;
  CellWalk W;
  W.start(blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x, a.R);
  Lane<T> L;
  typename CallOf<T, CAP>::type C;
  // a lane without a cell stays in the loop, done, until its warp is done
  bool done = W.c >= cells;
  if (!done) start_cell<T, FEAT>(a, L, W.row, W.support);
  bool in_call = false;
  // One pass of this loop is one trial of the lane's march call, after at
  // most one boundary: the end of the call that stopped and the start of the
  // next (a run's or a lagged segment's pass), or the end of the cell, its
  // psi written and the next cell started (which then waits one pass).
  for (;;) {
    if (!done && !(L.live && L.it < a.max_iters)) {
      if (in_call) call_end(a, L, C);
      in_call = next_call<T, FEAT>(a, L);
      if (in_call) {
        call_begin(a, L, C);
      } else {
        a.out[L.rs] = L.ll;
        W.next();
        done = W.c >= cells;
        if (!done) start_cell<T, FEAT>(a, L, W.row, W.support);
      }
    }
    // The warp meets here: without it the lanes that took a boundary and
    // those that did not would each run the trial on their own, the trial's
    // code issued twice in a pass.
    if (__all_sync(0xffffffffu, done)) break;
    if (!done && L.live && L.it < a.max_iters) call_trial<T, SOLVER>(a, L, C);
  }
}

template <typename T, int SOLVER, bool FEAT, int CAP>
cudaError_t implicit_occupancy(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fused_ode_implicit_kernel<T, SOLVER, FEAT, CAP>, IMPLICIT_THREADS, 0);
}

// The persistent grid: `blocks` blocks (<= 0: as many as the card holds at
// once), never more than the cells need.
template <typename T, int SOLVER, bool FEAT, int CAP>
cudaError_t launch_implicit(const Args<T>& a, int blocks, cudaStream_t stream) {
  if (a.R <= 0 || a.S <= 0) return cudaSuccess;
  if (blocks <= 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = implicit_occupancy<T, SOLVER, FEAT, CAP>(&per_sm);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    blocks = sms * per_sm;
  }
  const long long need = ((long long)a.R * a.S + IMPLICIT_THREADS - 1) / IMPLICIT_THREADS;
  if (blocks > need) blocks = (int)need;
  fused_ode_implicit_kernel<T, SOLVER, FEAT, CAP><<<blocks, IMPLICIT_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// The instantiation for the BDF order cap: D holds CAP + 3 rows, CAP = 3 for
// caps 1-3 and 5 for caps 4-5 (the argument bdf_max_order stays the cap).
template <typename T, bool FEAT>
cudaError_t launch_solver(const Args<T>& a, int blocks, cudaStream_t stream) {
#if PHARMSOL_ODE_SOLVER == 6
  if (a.bdf_max_order > 3)
    return launch_implicit<T, PHARMSOL_ODE_SOLVER, FEAT, 5>(a, blocks, stream);
#endif
  return launch_implicit<T, PHARMSOL_ODE_SOLVER, FEAT, 3>(a, blocks, stream);
}

template <typename T, bool FEAT>
cudaError_t occupancy_for(int cap, int* blocks) {
#if PHARMSOL_ODE_SOLVER == 6
  if (cap > 3) return implicit_occupancy<T, PHARMSOL_ODE_SOLVER, FEAT, 5>(blocks);
#endif
  return implicit_occupancy<T, PHARMSOL_ODE_SOLVER, FEAT, 3>(blocks);
}
#endif  // PHARMSOL_ODE_SOLVER

template <typename T>
cudaError_t run(int solver, const void* const* p, const int* ints, void* out,
                int R, int S, int M, int nb, int nr, int n_out, int n_runs,
                double rtol, double atol, double h0, int max_iters,
                int newton_iters, int bdf_max_order, int blocks, cudaStream_t st,
                const void* const* feat = nullptr, int n_lag = 0,
                int n_fa = 0) {
  Args<T> a = {};
  a.seg_dt = (const T*)p[0];
  a.seg_bolus = (const T*)p[1];
  a.seg_rate = (const T*)p[2];
  a.obs_mask = (const T*)p[3];
  a.obs_value = (const T*)p[4];
  a.obs_sigma = (const T*)p[5];
  a.obs_cens = (const T*)p[6];
  a.obs_outeq = (const T*)p[7];
  a.seg_t0 = (const T*)p[8];
  a.params = (const T*)p[9];
  a.coef = (const T*)p[10];
  a.bias = (const T*)p[11];
  a.dense = (const T*)p[12];
  a.bolus_in = ints;
  a.rate_in = ints + nb;
  a.runs = ints + nb + nr;
  a.out = (T*)out;
  a.R = R; a.S = S; a.M = M; a.nb = nb; a.nr = nr; a.n_out = n_out;
  a.n_runs = n_runs; a.max_iters = max_iters;
  a.newton_iters = newton_iters; a.bdf_max_order = bdf_max_order;
  if (solver == 6 && (bdf_max_order < 1 || bdf_max_order > 5))
    return cudaErrorInvalidValue;
  a.rtol = (T)rtol; a.atol = (T)atol; a.h0 = (T)h0;
  if (feat == nullptr) {
    switch (solver) {
#if defined(PHARMSOL_ODE_SOLVER)
      case PHARMSOL_ODE_SOLVER: return launch_solver<T, false>(a, blocks, st);
#elif defined(PHARMSOL_RHS_HAS_JVP)
      case 2: return launch<T, 2, false>(a, st);
#else
      case 0: return launch_explicit<T, 0, false>(a, blocks, st);
      case 1: return launch_explicit<T, 1, false>(a, blocks, st);
#endif
      default: return cudaErrorInvalidValue;
    }
  }
  Feat<T>& f = a.f;
  f.cov_a = (const T*)feat[0];
  f.cov_b = (const T*)feat[1];
  f.lag = (const T*)feat[2];
  f.fa = (const T*)feat[3];
  f.init_rows = (const T*)feat[4];
  f.init_planes = (const T*)feat[5];
  f.init_mask = (const T*)feat[6];
  f.n_lag = n_lag;
  f.n_fa = n_fa;
  // the slot tables follow the run boundaries: lag's, then fa's
  const int* slots = ints + nb + nr + n_runs + 1;
  f.lag_slots = n_lag > 0 ? slots : nullptr;
  f.fa_slots = n_fa > 0 ? slots + (n_lag > 0 ? nb * M : 0) : nullptr;
  if ((NCOV > 0 && f.cov_a == nullptr) || (n_lag > 0 && f.lag == nullptr) ||
      (n_fa > 0 && f.fa == nullptr) ||
      ((f.init_rows != nullptr || f.init_planes != nullptr) !=
       (f.init_mask != nullptr)))
    return cudaErrorInvalidValue;
  switch (solver) {
#if defined(PHARMSOL_ODE_SOLVER)
    case PHARMSOL_ODE_SOLVER: return launch_solver<T, true>(a, blocks, st);
#elif defined(PHARMSOL_RHS_HAS_JVP)
    case 2: return launch<T, 2, true>(a, st);
#else
    case 0: return launch_explicit<T, 0, true>(a, blocks, st);
    case 1: return launch_explicit<T, 1, true>(a, blocks, st);
#endif
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch on `stream`. Pointers: seg_dt [R, M], seg_bolus [nb, R, M],
// seg_rate [nr, R, M] (or null with nr == 0), obs_mask, obs_value, obs_sigma,
// obs_cens (or null), obs_outeq (or null when n_out == 1), seg_t0: [R, M];
// params [NP, S]; coef [n_out, N, S]; bias [n_out, S] (or null); dense
// [7, 4]; ints: int32 [nb bolus inputs, nr rate inputs, n_runs + 1 run
// boundaries]; out [R, S]. All floating data float (is_f64 == 0) or double.
// newton_iters, bdf_max_order and blocks are read by the implicit tiers only
// (blocks: their persistent grid's blocks, <= 0 for as many as the card holds
// at once). Returns the cudaError_t of the launch (0 on success).
extern "C" int fused_ode_launch(int is_f64, int solver, const void* seg_dt,
                                const void* seg_bolus, const void* seg_rate,
                                const void* obs_mask, const void* obs_value,
                                const void* obs_sigma, const void* obs_cens,
                                const void* obs_outeq, const void* seg_t0,
                                const void* params, const void* coef,
                                const void* bias, const void* dense,
                                const void* ints, void* out, int R, int S,
                                int M, int nb, int nr, int n_out, int n_runs,
                                double rtol, double atol, double h0,
                                int max_iters, int newton_iters,
                                int bdf_max_order, int blocks, void* stream) {
  const void* p[13] = {seg_dt, seg_bolus, seg_rate, obs_mask, obs_value,
                       obs_sigma, obs_cens, obs_outeq, seg_t0, params, coef,
                       bias, dense};
  cudaStream_t st = (cudaStream_t)stream;
  const int* iv = (const int*)ints;
  cudaError_t err =
      is_f64 ? run<double>(solver, p, iv, out, R, S, M, nb, nr, n_out, n_runs,
                           rtol, atol, h0, max_iters, newton_iters,
                           bdf_max_order, blocks, st)
             : run<float>(solver, p, iv, out, R, S, M, nb, nr, n_out, n_runs,
                          rtol, atol, h0, max_iters, newton_iters,
                          bdf_max_order, blocks, st);
  return (int)err;
}

// K2e: the same launch with the feature tier. base: the 13 pointers of
// fused_ode_launch in its order; feat: cov_a [NCOV, R, M], cov_b [NCOV, R, M]
// (or null), lag [n_lag, R, S], fa [n_fa, R, S], init_rows [N, S],
// init_planes [N, R, S], init_mask [R], each null when off; ints as
// fused_ode_launch's, then the lag slot table [nb, M] when n_lag > 0 and
// the fa slot table [nb, M] when n_fa > 0. Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for an inconsistent feature set).
extern "C" int fused_ode_feature_launch(int is_f64, int solver,
                                        const void* const* base,
                                        const void* const* feat,
                                        const void* ints, void* out, int R,
                                        int S, int M, int nb, int nr,
                                        int n_out, int n_runs, int n_lag,
                                        int n_fa, double rtol, double atol,
                                        double h0, int max_iters,
                                        int newton_iters, int bdf_max_order,
                                        int blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* iv = (const int*)ints;
  cudaError_t err =
      is_f64 ? run<double>(solver, base, iv, out, R, S, M, nb, nr, n_out,
                           n_runs, rtol, atol, h0, max_iters, newton_iters,
                           bdf_max_order, blocks, st, feat, n_lag, n_fa)
             : run<float>(solver, base, iv, out, R, S, M, nb, nr, n_out,
                          n_runs, rtol, atol, h0, max_iters, newton_iters,
                          bdf_max_order, blocks, st, feat, n_lag, n_fa);
  return (int)err;
}

// The generated RHS and its Jacobian-vector product on n samples, one thread
// each, for checks against the closure: x, v [n, N], p [n, NP], t [n],
// rate [n, NIN], cov_a, cov_b [n, NCOV] (cov(t) = cov_a + cov_b t; unread
// without covariates) -> f, jv [n, N]. Held by the exact propagation tier's
// library; cudaErrorNotSupported from any other.
#if defined(PHARMSOL_RHS_HAS_JVP) && !defined(PHARMSOL_ODE_SOLVER)
template <typename T>
__global__ void rhs_jvp_probe_kernel(int n, const T* x, const T* p, const T* t,
                                     const T* rate, const T* cov_a,
                                     const T* cov_b, const T* v, T* f, T* jv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T bz[NIN], ca[NC], cb[NC];
#pragma unroll
  for (int j = 0; j < NIN; ++j) bz[j] = T(0);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    ca[c] = NCOV > 0 ? cov_a[(size_t)i * NC + c] : T(0);
    cb[c] = NCOV > 0 ? cov_b[(size_t)i * NC + c] : T(0);
  }
  rhs<T>(x + (size_t)i * N, p + (size_t)i * NP, t[i], bz, rate + (size_t)i * NIN,
         ca, cb, f + (size_t)i * N);
  rhs_jvp<T>(x + (size_t)i * N, p + (size_t)i * NP, t[i], bz,
             rate + (size_t)i * NIN, ca, cb, v + (size_t)i * N,
             jv + (size_t)i * N);
}
#endif

extern "C" int fused_ode_jvp_probe(int is_f64, int n, const void* x,
                                   const void* p, const void* t,
                                   const void* rate, const void* cov_a,
                                   const void* cov_b, const void* v, void* f,
                                   void* jv, void* stream) {
#if defined(PHARMSOL_RHS_HAS_JVP) && !defined(PHARMSOL_ODE_SOLVER)
  cudaStream_t st = (cudaStream_t)stream;
  const int block = 128, grid = (n + block - 1) / block;
  if (n <= 0) return (int)cudaSuccess;
  if (is_f64)
    rhs_jvp_probe_kernel<double><<<grid, block, 0, st>>>(
        n, (const double*)x, (const double*)p, (const double*)t,
        (const double*)rate, (const double*)cov_a, (const double*)cov_b,
        (const double*)v, (double*)f, (double*)jv);
  else
    rhs_jvp_probe_kernel<float><<<grid, block, 0, st>>>(
        n, (const float*)x, (const float*)p, (const float*)t,
        (const float*)rate, (const float*)cov_a, (const float*)cov_b,
        (const float*)v, (float*)f, (float*)jv);
  return (int)cudaGetLastError();
#else
  return (int)cudaErrorNotSupported;
#endif
}

#if !defined(PHARMSOL_ODE_SOLVER) && !defined(PHARMSOL_RHS_HAS_JVP)
// Resident blocks per SM of the explicit tier's kernel that a launch with
// these arguments runs (solver 0 dopri5, 1 tsit5), the count its persistent
// grid is sized from. Only the explicit tier's libraries hold it.
extern "C" int fused_ode_explicit_occupancy(int is_f64, int solver, int feat, int* blocks) {
  cudaError_t err =
      is_f64 ? (feat ? explicit_occupancy_for<double, true>(solver, blocks)
                     : explicit_occupancy_for<double, false>(solver, blocks))
             : (feat ? explicit_occupancy_for<float, true>(solver, blocks)
                     : explicit_occupancy_for<float, false>(solver, blocks));
  return (int)err;
}
#endif

#if defined(PHARMSOL_ODE_SOLVER)
// Resident blocks per SM of the implicit tier's kernel that a launch with
// these arguments runs (cap: bdf_max_order; read by K2c only), the count its
// persistent grid is sized from. Only the implicit tiers' libraries hold it.
extern "C" int fused_ode_occupancy(int is_f64, int feat, int cap, int* blocks) {
  cudaError_t err =
      is_f64 ? (feat ? occupancy_for<double, true>(cap, blocks)
                     : occupancy_for<double, false>(cap, blocks))
             : (feat ? occupancy_for<float, true>(cap, blocks)
                     : occupancy_for<float, false>(cap, blocks));
  return (int)err;
}
#endif

// The generated RHS this library was built with: {states, params, inputs}.
extern "C" void fused_ode_signature(int* out3) {
  out3[0] = N;
  out3[1] = NP;
  out3[2] = NIN;
}

extern "C" const char* fused_ode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
