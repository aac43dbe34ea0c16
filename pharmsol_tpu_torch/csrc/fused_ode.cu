// Fused population psi for ODE models, explicit Runge-Kutta tier, exact
// propagation tier and their feature tier, for Hopper (sm_90a).
//
// Replaces the TPU kernel pharmsol_tpu/ops/pallas_ode.py::psi_ode
// (_make_ode_kernel): K2a, the explicit `integrate` march (dopri5 and tsit5,
// merged dense output, RHS-difference boluses, several dose inputs, linear
// outputs, censoring); K2e, its feature tier (covariate lanes and
// LaneCov :417/:644-660, init :1614-1618, the lag/fa split march with slot
// tables :1665-1807); and K2d, the exact propagation of an affine autonomous
// RHS (`integrate_expm` :1152-1287, solver code 2, see march_expm below),
// with or without the feature tier. Plain PyTorch twin:
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
// Layout. One thread per (row, support) cell. threadIdx.x runs along the
// supports, so the parameter rows [P, S], the output coefficients and the psi
// writes [R, S] are coalesced, and the 32 threads of a warp share one row:
// their reads of the row's streams [R, M] are broadcasts. Blocks stride over
// rows in y; the ragged support edge is masked here. No padding of R, S or M,
// and M has no limit. States, the 7 FSAL stages, the step size and the
// controller live in registers; the tableaus are compile-time constants.
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
// its slowest lane; with lag the fire times differ per support too, so the
// lanes of a warp split their segments at different times. That and the
// float64 pow/log software routines (a covariate model's RHS calls pow in
// every stage) are the known costs of this first, untuned version (no
// shared-memory staging, no tuning of the block shape).
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

#ifdef PHARMSOL_RHS_HAS_JVP
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
#endif  // PHARMSOL_RHS_HAS_JVP

// A bolus of `amt` into RHS input `in` at time t: x += f(x, b) - f(x, 0),
// the general engine's own semantics.
template <typename T>
__device__ __forceinline__ void dose(T* x, const T* p, T t, int in, T amt,
                                     const T* rate, const T* ca,
                                     const T* cb) {
  T bv[NIN], bz[NIN], dw[N], dz[N];
#pragma unroll
  for (int j = 0; j < NIN; ++j) {
    bv[j] = (j == in) ? amt : T(0);
    bz[j] = T(0);
  }
  rhs<T>(x, p, t, bv, rate, ca, cb, dw);
  rhs<T>(x, p, t, bz, rate, ca, cb, dz);
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = x[j] + (dw[j] - dz[j]);
}

// The adaptive march of one run over `target` time from t0 (the JAX
// kernel's `integrate`, explicit tier). x and h are updated in place;
// observation terms of the run's interior columns m0+1..m1-1 are added to ll
// in column order. ca, cb: the run's covariates.
template <typename T, int SOLVER>
__device__ __forceinline__ void march(const Args<T>& a, T* x, T& h, T& ll,
                                      const T* p, const T* rate, const T* ca,
                                      const T* cb, T t0, T target,
                                      size_t row, int s, int m0, int m1,
                                      bool estimate_h) {
#ifdef PHARMSOL_RHS_HAS_JVP
  // K2d: one exact propagation; runs are single segments (expm never
  // merges), so there is no interior observation and no step to carry
  static_assert(SOLVER == 2, "a library with rhs_jvp holds the expm tier");
  march_expm<T>(x, p, rate, ca, cb, t0, target);
#else
  using Tb = Tab<SOLVER>;
  const T rtol = a.rtol, atol = a.atol;
  T bz[NIN];
#pragma unroll
  for (int j = 0; j < NIN; ++j) bz[j] = T(0);

  const T thr = target - T(1e-6) * pm_max(target, T(1e-30));
  const bool live0 = target > T(0) && all_finite(x);
  int mm = m0 + 1;                 // next interior column
  T Tj = a.seg_dt[row + m0];       // its offset from the run's start
  // zero-offset observations read the run's start state
  while (mm < m1 && Tj <= T(0)) {
    ll += obs_term(a, row + mm, s, x);
    Tj = Tj + a.seg_dt[row + mm];
    ++mm;
  }

  T ks[NS][N];
  rhs<T>(x, p, t0, bz, rate, ca, cb, ks[0]);
  if (estimate_h) {
    // Hairer-Norsett-Wanner II.4 starting step, floored at h0
    T d0 = T(0), d1 = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const T sc = atol + rtol * pm_abs(x[j]);
      d0 = d0 + (x[j] / sc) * (x[j] / sc);
      d1 = d1 + (ks[0][j] / sc) * (ks[0][j] / sc);
    }
    d0 = pm_sqrt(d0 / T(N));
    d1 = pm_sqrt(d1 / T(N));
    const T h0a = (d0 > T(1e-5) && d1 > T(1e-5))
                      ? T(0.01) * d0 / pm_max(d1, T(1e-30)) : T(1e-6);
    T x1[N], f1[N];
#pragma unroll
    for (int j = 0; j < N; ++j) x1[j] = x[j] + h0a * ks[0][j];
    rhs<T>(x1, p, t0 + h0a, bz, rate, ca, cb, f1);
    T d2 = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const T sc = atol + rtol * pm_abs(x[j]);
      const T q = (f1[j] - ks[0][j]) / sc;
      d2 = d2 + q * q;
    }
    d2 = pm_sqrt(d2 / T(N)) / h0a;
    const T dmax = pm_max(d1, d2);
    const T h1 = dmax > T(1e-15)
                     ? pm_pow(T(0.01) / pm_max(dmax, T(1e-30)), T(0.2))
                     : pm_max(T(1e-6), h0a * T(1e3));
    const T h_est = pm_min(T(100) * h0a, h1);
    if (isfinite(h_est)) h = pm_max(h_est, a.h0);
  }

  T tau = T(0);
  T hc = pm_min(h, pm_max(target, T(1e-14)));
  bool live = live0;
  for (int it = 0; it < a.max_iters && live; ++it) {
    const T ht = pm_min(hc, pm_max(target - tau, T(1e-14)));
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
        xi[j] = x[j] + ht * acc;
      }
      rhs<T>(xi, p, t0 + tau + T(Tb::c(i)) * ht, bz, rate, ca, cb, ks[i]);
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
      xn[j] = x[j] + ht * accb;
      const T scale = atol + rtol * pm_max(pm_abs(x[j]), pm_abs(xn[j]));
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
      while (mm < m1) {
        const T te = pm_min(Tj, thr);
        if (!(te <= tau + ht)) break;
        const T th = (te - tau) / ht;
        T xt[N];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          T acc = T(0);
#pragma unroll
          for (int l = 0; l < NS; ++l) {
            const T* P = a.dense + 4 * l;
            acc = acc + ks[l][j] * (P[0] + th * (P[1] + th * (P[2] + th * P[3])));
          }
          xt[j] = x[j] + ht * th * acc;
        }
        ll += obs_term(a, row + mm, s, xt);
        Tj = Tj + a.seg_dt[row + mm];
        ++mm;
      }
      tau = tau + ht;
#pragma unroll
      for (int j = 0; j < N; ++j) x[j] = xn[j];
      if (all_finite(ks[NS - 1])) {
#pragma unroll
        for (int j = 0; j < N; ++j) ks[0][j] = ks[NS - 1][j];
      }
    }
    hc = pm_max(ht * factor, T(1e-14));
    const bool done = tau >= thr;
    const bool stalled = (tau + hc) <= tau && !done;
    live = !done && !stalled;
  }
  if (tau < thr) {
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = T(NAN);
  }
  // captures an incomplete lane never reached
  T xnan[N];
#pragma unroll
  for (int j = 0; j < N; ++j) xnan[j] = T(NAN);
  for (; mm < m1; ++mm) ll += obs_term(a, row + mm, s, xnan);
  if (live0) h = hc;
#endif
}

// The fa scale of bolus plane k at segment m (K2e; 1 without fa).
template <typename T>
__device__ __forceinline__ T fa_scale(const Args<T>& a, int k, int m,
                                      size_t rs) {
  if (a.f.n_fa == 0) return T(1);
  const int slot = a.f.fa_slots[k * a.M + m];
  return slot < 0 ? T(1) : a.f.fa[(size_t)slot * a.R * a.S + rs];
}

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
    T h = a.h0;
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
        march<T, SOLVER>(a, x, h, ll, p, rate, ca, cb, t0, target, row, s, m0,
                         m1, m0 == 0);
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
        march<T, SOLVER>(a, x, h, ll, p, rate, ca, cb, t0 + elapsed,
                         t_next - elapsed, row, s, m0, m0 + 1,
                         m0 == 0 && pass == 0);
#pragma unroll
        for (int k = 0; k < NIN; ++k) {
          if (will[k] && pend_rem[k] <= t_next) {
            dose(x, p, t0 + t_next, a.bolus_in[k], pend_amt[k], rate, ca, cb);
            pend_amt[k] = T(0);
          }
        }
        elapsed = t_next;
      }
      march<T, SOLVER>(a, x, h, ll, p, rate, ca, cb, t0 + elapsed,
                       dt - elapsed, row, s, m0, m0 + 1, false);
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

template <typename T>
cudaError_t run(int solver, const void* const* p, const int* ints, void* out,
                int R, int S, int M, int nb, int nr, int n_out, int n_runs,
                double rtol, double atol, double h0, int max_iters,
                cudaStream_t st, const void* const* feat = nullptr,
                int n_lag = 0, int n_fa = 0) {
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
  a.rtol = (T)rtol; a.atol = (T)atol; a.h0 = (T)h0;
  if (feat == nullptr) {
    switch (solver) {
#ifdef PHARMSOL_RHS_HAS_JVP
      case 2: return launch<T, 2, false>(a, st);
#else
      case 0: return launch<T, 0, false>(a, st);
      case 1: return launch<T, 1, false>(a, st);
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
#ifdef PHARMSOL_RHS_HAS_JVP
    case 2: return launch<T, 2, true>(a, st);
#else
    case 0: return launch<T, 0, true>(a, st);
    case 1: return launch<T, 1, true>(a, st);
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
// Returns the cudaError_t of the launch (0 on success).
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
                                int max_iters, void* stream) {
  const void* p[13] = {seg_dt, seg_bolus, seg_rate, obs_mask, obs_value,
                       obs_sigma, obs_cens, obs_outeq, seg_t0, params, coef,
                       bias, dense};
  cudaStream_t st = (cudaStream_t)stream;
  const int* iv = (const int*)ints;
  cudaError_t err =
      is_f64 ? run<double>(solver, p, iv, out, R, S, M, nb, nr, n_out, n_runs,
                           rtol, atol, h0, max_iters, st)
             : run<float>(solver, p, iv, out, R, S, M, nb, nr, n_out, n_runs,
                          rtol, atol, h0, max_iters, st);
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
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* iv = (const int*)ints;
  cudaError_t err =
      is_f64 ? run<double>(solver, base, iv, out, R, S, M, nb, nr, n_out,
                           n_runs, rtol, atol, h0, max_iters, st, feat, n_lag,
                           n_fa)
             : run<float>(solver, base, iv, out, R, S, M, nb, nr, n_out,
                          n_runs, rtol, atol, h0, max_iters, st, feat, n_lag,
                          n_fa);
  return (int)err;
}

// The generated RHS and its Jacobian-vector product on n samples, one thread
// each, for checks against the closure: x, v [n, N], p [n, NP], t [n],
// rate [n, NIN], cov_a, cov_b [n, NCOV] (cov(t) = cov_a + cov_b t; unread
// without covariates) -> f, jv [n, N]. cudaErrorNotSupported from a library
// whose header has no rhs_jvp.
#ifdef PHARMSOL_RHS_HAS_JVP
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
#ifdef PHARMSOL_RHS_HAS_JVP
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

// The generated RHS this library was built with: {states, params, inputs}.
extern "C" void fused_ode_signature(int* out3) {
  out3[0] = N;
  out3[1] = NP;
  out3[2] = NIN;
}

extern "C" const char* fused_ode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
