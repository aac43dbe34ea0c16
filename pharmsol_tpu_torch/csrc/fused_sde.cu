// Fused population psi for SDE models: the bootstrap particle filter with
// adaptive Euler-Maruyama, for Hopper (sm_90a).
//
// Replaces the TPU kernel pharmsol_tpu/ops/pallas_sde.py::psi_sde
// (_make_sde_kernel): its base tier (K3a: per-input boluses into their
// destination states and infusions, init rows, censoring, several outputs
// with a bias, both em_control modes) and its feature tier (K3b: covariate
// lanes cov_for_seg :283-288, init planes :375-383, the lag/fa pending doses
// with their split march and slot tables :387-390, :445-538). Plain PyTorch
// twin: pharmsol_tpu_torch/ops/fused_sde.py::psi_sde_plain.
//
// The model's drift and diffusion are not written here: they are generated
// from the model's torch closures by pharmsol_tpu_torch/ops/rhs_codegen.py as
// `drift<T>(x, p, t, rateiv, cov_a, cov_b, dx)` and `diffusion<T>(p, t,
// cov_a, cov_b, g)` and included through PHARMSOL_SDE_RHS, so each model
// builds its own library. A covariate reads cov_a[i] (constant over the row)
// or cov_a[i] + cov_b[i] * t (affine within the segment).
//
// Two instantiations of one kernel template: FEAT = false is K3a, FEAT =
// true is K3b; both run the same segment loop and the same march, FEAT adds
// only the feature tier's reads (covariates, init planes, pending doses,
// slot tables). A library holds one tier: the base tier's ten
// instantiations (two dtypes, five particle counts per thread), or with
// -DPHARMSOL_SDE_FEAT=1 the feature tier's (ops/_build.py::sde_kind), so a
// model builds what it runs. K3b's inputs ride in one struct of pointers
// (Feat, null = off):
// - covariates: cov_a, cov_b [NCOV, R, M]: per segment column, the constant
//   value or the affine (a, b) of the segment;
// - init planes [N, R, S] (an init that reads a covariate), times init_mask;
// - lag, fa: plane stacks [n, R, S], selected per (bolus plane, segment) by
//   the slot tables [nb, M] of the int table (-1: no dose lands there;
//   static planes have slot k in every column).
// With lag, each bolus plane's pending dose (amount, time to fire) is held
// by every thread of the block alike: the fire times are the cell's, so
// every branch of the split march is uniform over the block and all threads
// reach the same barriers. The doses due at a breakpoint fire after its
// observation and before the arrivals; new doses park with their lag; one
// pass per bolus plane marches to the next earliest fire time (equal times
// fire together, strict rem < dt), each pass with the Euler-Maruyama
// controller restarted (the engine's per-support grid split at the shifted
// time), and the last pass runs to the segment's end; the trial count runs
// on across the passes of a segment (ops/philox.py). A zero fa parks a zero
// dose, which never fires, as in the JAX kernel.
//
// Layout. One block of 256 threads per (row, support) cell, a grid of R * S
// blocks, nothing padded. Thread t owns the particles [t * PPT, t * PPT +
// PPT) (PPT = 1, 2, 4, 8 or 16, the smallest that covers P), whose states it
// keeps in registers through the Euler-Maruyama march. Shared memory holds
// the cloud [n_states][P] and the cumulative weights [P] at an observation
// only, where particles move between threads: (n_states + 1) * P values,
// 24 KB for 2 states x 1000 particles in float64; above 48 KB the launch opts
// in to more, up to 227 KB.
//
// Per cell, for each segment m of the row:
// 1. at a valued observation (read before the dose): the weight q of every
//    particle (normal density, or the exact normal CDF of +-z for BLOQ/ALOQ),
//    a block sum, ll += log(max(sum q / P, tiny)), the weights normalised and
//    scanned into shared memory (an O(P) block scan), and stratified
//    resampling: particle j draws u_j = (j + U_j) / P and binary-searches the
//    cumulative weights (first index >= u_j, clamped to P - 1), then gathers
//    its new state from the shared copy of the cloud;
// 2. the segment's boluses added to their destination states;
// 3. the adaptive Euler-Maruyama march (the JAX kernel's em_march): each
//    trial advances every particle by the full step and by two half steps,
//    the max normalised error over particles and states is reduced over the
//    block, and accept, the new step (clamped rsqrt law) and the end of the
//    march are decided from that block-reduced value, so every thread takes
//    the same branch and reaches the same barriers. The march ends at tau >=
//    target - 1e-6 target, on a stall (tau + h == tau) or after 100000
//    trials; a cell that stopped short is NaN.
//
// Noise: Philox4x32-10 (Salmon et al. 2011, the Random123 constants) with
// Box-Muller normals, counters a pure function of (seed, row, support,
// segment, trial, draw slot, particle) as laid out in
// pharmsol_tpu_torch/ops/philox.py, so the twin draws the same numbers. One
// call gives four float32 or two float64 normals. They are independent per
// cell, as the JAX kernel's; noise='common' is not honoured here, as there.
//
// What bounds it. Not memory: a cell reads a few KB and writes one value.
// Per particle and trial the kernel issues three Philox calls of 10 rounds
// (a 32 x 32 -> 64-bit multiply pair and two 3-input XORs a round: integer
// work, at the card's INT32 rate the floor of the README model's trial),
// Box-Muller (a log, a sqrt and a sin or a cos per normal; software
// routines in float64, whose constants the loop materialises again in every
// trial), two drift and two diffusion evaluations and one IEEE division per
// state; then the block needs the maximum of the error before any thread
// can go on. So it is bound by the instructions it issues, and the design
// cuts them and keeps enough warps resident to hide their latency:
// - the generator marks the diffusion components that trace to a literal
//   zero (PHARMSOL_SDE_NOISY, ops/rhs_codegen.py::generate_sde): their
//   normals, their Box-Muller halves and their g * w terms are not formed,
//   and a Philox call whose group of states holds no noisy one is not made;
//   every other normal is the same number, and x + d h + 0 w and x + d h
//   differ at most in the sign of a zero (w is finite). A diffusion that is
//   zero only at run time (sigma = 0 on a support) draws as before;
// - the ten Philox round keys are computed once a launch on the host and
//   read from the kernel's parameters;
// - the launch bounds ask for three resident blocks an SM in float32 and two
//   in float64 up to four particles a thread (min_blocks), with no spill in
//   K3a;
// - each particle's normals are drawn where they are used, inside the
//   particle's step: the fewest values live at once. Drawing the next
//   trial's normals between an arrive and a wait of the block maximum (an
//   mbarrier) was built and measured, and lost in every cell and dtype: it
//   keeps every particle's normals and two-half-step states live across the
//   draw, which costs resident blocks, while the other resident blocks'
//   warps already fill the issue slots that a block's barrier leaves idle.
// PERF.md section 6 holds the measured registers, resident blocks, the trial
// loop's instruction mix and the times.
//
// Rounding. The block sums and the prefix sum run in a fixed order (thread,
// warp butterfly, warps in order), which the twin reproduces, and the build
// turns off the contraction of multiplies and adds into FMAs, so that every
// operation rounds as the twin's op-by-op PyTorch does: kernel and twin draw
// the same particles and agree to rounding, also where a resampling position
// falls next to a cumulative weight. The maximum needs no order.
//
// Build (plain C interface, loaded with ctypes; ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -fmad=false -I<dir> \
//        [-DPHARMSOL_SDE_FEAT=1] -DPHARMSOL_SDE_RHS='"sde_<key>.cuh"' \
//        -o libfused_sde_<hash>.so fused_sde.cu

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#ifndef PHARMSOL_SDE_FEAT
#define PHARMSOL_SDE_FEAT 0
#endif

#ifndef PHARMSOL_SDE_RHS
#error "define PHARMSOL_SDE_RHS as the generated drift/diffusion header (ops/_build.py)"
#endif
#include PHARMSOL_SDE_RHS

namespace {

constexpr int N = PHARMSOL_RHS_NSTATES;
constexpr int NP = PHARMSOL_RHS_NPARAMS;
constexpr int NIN = PHARMSOL_RHS_NINPUT;
constexpr int NCOV = PHARMSOL_RHS_NCOV;
constexpr int NC = NCOV > 0 ? NCOV : 1;  // register arrays of the covariates
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// The diffusion components that are not a literal zero (the generator's
// mask, ops/rhs_codegen.py::generate_sde): only these draw normals.
#ifndef PHARMSOL_SDE_NOISY
#error "the generated header must define PHARMSOL_SDE_NOISY (ops/rhs_codegen.py)"
#endif
static_assert(N <= 64, "the noise mask holds at most 64 states");

constexpr unsigned long long noisy_mask() {
  constexpr bool v[N] = PHARMSOL_SDE_NOISY;
  unsigned long long mask = 0;
  for (int i = 0; i < N; ++i) mask |= v[i] ? 1ull << i : 0ull;
  return mask;
}

constexpr unsigned long long NOISY_MASK = noisy_mask();  // a scalar: device code reads it

__host__ __device__ constexpr bool noisy(int i) { return i < N && ((NOISY_MASK >> i) & 1ull); }

// Resident blocks an SM that the launch bounds ask the register allocator
// for, up to four particles a thread: three in float32 (24 warps), two in
// float64 (16 warps, where K3b would take 158 registers and one block
// unasked); one above.
template <typename T>
__host__ __device__ constexpr int min_blocks(int ppt) {
  return ppt > 4 ? 1 : sizeof(T) == 4 ? 3 : 2;
}

// the Euler-Maruyama controller of pharmsol_tpu_torch/engine/sde.py
constexpr double EM_RTOL = 1e-2;
constexpr double EM_ATOL = 1e-2;
constexpr double EM_MAX_STEP = 0.1;
constexpr double EM_MIN_STEP = 1e-6;
constexpr double EM_SAFETY = 0.9;
constexpr int EM_MAX_ITERS = 100000;
constexpr uint32_t SLOT_RESAMPLE = 3;

// ---------------------------------------------------------------------------
// Philox4x32-10 and the uniforms and normals drawn from it (ops/philox.py)
// ---------------------------------------------------------------------------

struct U4 {
  uint32_t x, y, z, w;
};

// The ten round keys of a Philox key, computed once a launch on the host:
// they ride in the kernel's parameters, which the rounds read as operands.
struct Key {
  uint32_t k0[10], k1[10];
};

Key key_schedule(uint32_t k0, uint32_t k1) {
  Key key;
  for (int r = 0; r < 10; ++r) {
    key.k0[r] = k0 + (uint32_t)r * 0x9E3779B9u;
    key.k1[r] = k1 + (uint32_t)r * 0xBB67AE85u;
  }
  return key;
}

__device__ __forceinline__ U4 philox(U4 c, const Key& key) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = U4{hi1 ^ c.y ^ key.k0[r], lo1, hi0 ^ c.w ^ key.k1[r], lo0};
  }
  return c;
}

// The counter of (particle, segment, trial, slot, group) in a cell.
__device__ __forceinline__ U4 counter(int j, int m, int trial, uint32_t slot,
                                      int group, int s, int r) {
  return U4{(uint32_t)j + ((uint32_t)m << 16),
            (uint32_t)trial + (slot << 17) + ((uint32_t)group << 20),
            (uint32_t)s, (uint32_t)r};
}

template <typename T>
struct Fn;

template <>
struct Fn<float> {
  static constexpr int PER_CALL = 4;  // normals per Philox call
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
  static __device__ __forceinline__ float exp(float v) { return expf(v); }
  static __device__ __forceinline__ float log(float v) { return logf(v); }
  static __device__ __forceinline__ float sqrt(float v) { return sqrtf(v); }
  static __device__ __forceinline__ float erf(float v) { return erff(v); }
  static __device__ __forceinline__ float erfc(float v) { return erfcf(v); }
  // (0, 1] from the top 24 bits of one word
  static __device__ __forceinline__ float u24(uint32_t w) {
    return (float)((w >> 8) + 1u) * 5.9604644775390625e-08f;
  }
  static __device__ __forceinline__ float uniform(U4 w) { return u24(w.x); }
  // The normals of the states [base, base + 4) from one call, two
  // Box-Muller pairs: the cos half of a pair only for a noisy first state,
  // the sin half only for a noisy second, neither pair's log for two quiet
  // ones.
  static __device__ __forceinline__ void normals(U4 w, int base, float* z) {
    const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = base + 2 * q;
      if (!noisy(i) && !noisy(i + 1)) continue;
      const float rr = sqrtf(-2.0f * logf(u24(v[2 * q])));
      const float th = 6.283185307179586f * u24(v[2 * q + 1]);
      if (noisy(i)) z[i] = rr * cosf(th);
      if (noisy(i + 1)) z[i + 1] = rr * sinf(th);
    }
  }
};

template <>
struct Fn<double> {
  static constexpr int PER_CALL = 2;
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
  static __device__ __forceinline__ double exp(double v) { return ::exp(v); }
  static __device__ __forceinline__ double log(double v) { return ::log(v); }
  static __device__ __forceinline__ double sqrt(double v) { return ::sqrt(v); }
  static __device__ __forceinline__ double erf(double v) { return ::erf(v); }
  static __device__ __forceinline__ double erfc(double v) { return ::erfc(v); }
  // (0, 1] from 53 bits of two words
  static __device__ __forceinline__ double u53(uint32_t hi, uint32_t lo) {
    const uint64_t v = ((uint64_t)(hi >> 5) << 26) + (uint64_t)(lo >> 6) + 1ull;
    return (double)v * 1.1102230246251565404e-16;
  }
  static __device__ __forceinline__ double uniform(U4 w) { return u53(w.x, w.y); }
  // The normals of the states [base, base + 2) from one call, one
  // Box-Muller pair, each half only for a noisy state.
  static __device__ __forceinline__ void normals(U4 w, int base, double* z) {
    if (!noisy(base) && !noisy(base + 1)) return;
    const double rr = ::sqrt(-2.0 * ::log(u53(w.x, w.y)));
    const double th = 6.283185307179586 * u53(w.z, w.w);
    if (noisy(base)) z[base] = rr * ::cos(th);
    if (noisy(base + 1)) z[base + 1] = rr * ::sin(th);
  }
};

// max that propagates NaN from either side, as torch.maximum / jnp.maximum
template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}

// The standard normal CDF, accurate in both tails (the formula of
// jax.scipy.special.ndtr and engine/sde.py::ndtr).
template <typename T>
__device__ __forceinline__ T ndtr(T v) {
  const T w = v * T(0.70710678118654752440);
  const T z = w < T(0) ? -w : w;
  const T y = z < T(0.70710678118654752440) ? T(1) + Fn<T>::erf(w)
              : (w > T(0) ? T(2) - Fn<T>::erfc(z) : Fn<T>::erfc(z));
  return T(0.5) * y;
}

// ---------------------------------------------------------------------------
// Block-wide reductions. Every thread of the block returns the same value:
// the warp results are combined in the same order by every thread.
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T block_max(T v, T* buf) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = nanmax(v, __shfl_xor_sync(FULL, v, off));
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = buf[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = nanmax(r, buf[w]);
  return r;
}

template <typename T>
__device__ __forceinline__ T block_sum(T v, T* buf) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_xor_sync(FULL, v, off);
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = buf[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = r + buf[w];
  return r;
}

// Exclusive prefix sum of one value per thread, in thread order.
template <typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T o = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc = inc + o;
  }
  T excl = __shfl_up_sync(FULL, inc, 1);
  if (lane == 0) excl = T(0);
  if (lane == 31) buf[warp] = inc;
  __syncthreads();
  T base = T(0);
  for (int w = 0; w < warp; ++w) base = base + buf[w];
  return base + excl;
}

// K3b's feature inputs (null = off).
template <typename T>
struct Feat {
  const T* cov_a;        // [NCOV, R, M]
  const T* cov_b;        // [NCOV, R, M] or null (no affine covariate)
  const T* lag;          // [n_lag, R, S]
  const T* fa;           // [n_fa, R, S]
  const T* init_planes;  // [N, R, S] (with init_mask)
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
  const T* init;       // [N, S] or null
  const T* init_mask;  // [R] (with init)
  const T* coef;       // [n_out, N, S]
  const T* bias;       // [n_out, S] or null
  const int* dose_state;  // [nb] destination state of each bolus plane
  const int* rate_in;     // [nr] RHS input of each rate plane
  T* out;              // [R, S]
  int R, S, M, P, nb, nr, n_out, coupled;
  Key key;             // Philox round keys
};

// K3b's arguments: K3a's and the feature inputs.
template <typename T>
struct FeatArgs : Args<T> {
  Feat<T> f;
};

// The fa scale of bolus plane k at segment m (K3b; 1 without fa).
template <typename T>
__device__ __forceinline__ T fa_scale(const FeatArgs<T>& a, int k, int m, size_t rs) {
  if (a.f.n_fa == 0) return T(1);
  const int slot = a.f.fa_slots[k * a.M + m];
  return slot < 0 ? T(1) : a.f.fa[(size_t)slot * a.R * a.S + rs];
}

// The segment's infusion rate into each RHS input.
template <typename T>
__device__ __forceinline__ void segment_rates(const Args<T>& a, size_t idx, T (&rate)[NIN]) {
  const size_t RM = (size_t)a.R * a.M;
#pragma unroll
  for (int i = 0; i < NIN; ++i) rate[i] = T(0);
  for (int b = 0; b < a.nr; ++b) {
    const T v = a.seg_rate[(size_t)b * RM + idx];
    const int in = a.rate_in[b];
#pragma unroll
    for (int i = 0; i < NIN; ++i) rate[i] = (i == in) ? v : rate[i];
  }
}

// Add `amt` to state ds of every particle the thread owns.
template <int PPT, typename T>
__device__ __forceinline__ void add_dose(T (&x)[PPT][N], int ds, T amt) {
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[k][i] = (i == ds) ? x[k][i] + amt : x[k][i];
  }
}

// The normals of particle j's trial `trial` of segment m: one Philox call
// per draw slot and group of states that holds a noisy one (the counters of
// ops/philox.py), z[slot][state] for the noisy states.
template <typename T, typename A>
__device__ __forceinline__ void draw(const A& a, T (&z)[3][N], int j, int m, int trial, int r,
                                     int s) {
  constexpr int PC = Fn<T>::PER_CALL;
  constexpr int G = (N + PC - 1) / PC;  // Philox calls per slot
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    if (d == 2 && a.coupled) break;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      bool any = false;
#pragma unroll
      for (int q = 0; q < PC; ++q) any = any || noisy(g * PC + q);
      if (any)
        Fn<T>::normals(philox(counter(j, m, trial, (uint32_t)d, g, s, r), a.key), g * PC, z[d]);
    }
  }
}

// The adaptive Euler-Maruyama march (the JAX kernel's em_march) of the
// thread's particles over `target` from t0, the controller started afresh;
// `trial` numbers the segment's next trial and is advanced by the trials
// made. Each trial advances every particle by the full step and by two half
// steps (the noise terms of the noisy states only: a quiet state's are a
// literal 0 times a finite normal), the max normalised error over particles
// and states is reduced over the block (warp shuffles, then shared memory),
// and accept, the new step (clamped rsqrt law) and the end of the march are
// decided from that block-reduced value, so every thread takes the same
// branch and reaches the same barriers. The march ends at tau >= target -
// 1e-6 target, on a stall (tau + h == tau) or after 100000 trials; a cell
// that stopped short is NaN.
template <typename T, int PPT, typename A>
__device__ __forceinline__ void em_march(const A& a, T (&x)[PPT][N], const T* p,
                                         const T* rate, const T* ca, const T* cb,
                                         T t0, T target, int m, int& trial, int r,
                                         int s, T (&red_max)[2][WARPS], unsigned& parity) {
  if (!(target > T(0))) return;
  const int P = a.P;
  const int j0 = threadIdx.x * PPT;
  const T thr = target - T(1e-6) * (target > T(1e-30) ? target : T(1e-30));
  T tau = T(0);
  T h = T(EM_MAX_STEP);
  bool live = true;
  int it = 0;
  for (; it < EM_MAX_ITERS && live; ++it) {
    const T rem = target - tau;
    const T h_try = h < (rem > T(1e-14) ? rem : T(1e-14)) ? h
                    : (rem > T(1e-14) ? rem : T(1e-14));
    const T t_abs = t0 + tau;
    const T h_half = h_try * T(0.5);
    const T sq_h = Fn<T>::sqrt(h_half > T(0) ? h_half : T(0));
    const T sq = Fn<T>::sqrt(h_try > T(0) ? h_try : T(0));
    const T t_mid = t_abs + h_half;
    T g0[N], g1[N];
    diffusion<T>(p, t_abs, ca, cb, g0);
    diffusion<T>(p, t_mid, ca, cb, g1);
    T err = T(0);
    T y2[PPT][N];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int j = j0 + k;
#pragma unroll
      for (int i = 0; i < N; ++i) y2[k][i] = x[k][i];
      if (j >= P) continue;
      T z[3][N];  // the normals of the full step and of the two half steps
      draw<T>(a, z, j, m, trial + it, r, s);
      T d0[N], ym[N], d1[N], y1[N];
      drift<T>(x[k], p, t_abs, rate, ca, cb, d0);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        y1[i] = x[k][i] + d0[i] * h_try;
        ym[i] = x[k][i] + d0[i] * h_half;
        if (noisy(i)) {
          const T w_full = a.coupled ? (z[0][i] + z[1][i]) * sq_h : z[0][i] * sq;
          const T w1 = a.coupled ? z[0][i] * sq_h : z[1][i] * sq_h;
          y1[i] = y1[i] + g0[i] * w_full;
          ym[i] = ym[i] + g0[i] * w1;
        }
      }
      drift<T>(ym, p, t_mid, rate, ca, cb, d1);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        y2[k][i] = ym[i] + d1[i] * h_half;
        if (noisy(i))
          y2[k][i] = y2[k][i] + g1[i] * ((a.coupled ? z[1][i] : z[2][i]) * sq_h);
        const T xa = x[k][i] < T(0) ? -x[k][i] : x[k][i];
        const T diff = y1[i] - y2[k][i];
        const T e = (diff < T(0) ? -diff : diff) / (T(EM_ATOL) + T(EM_RTOL) * xa);
        err = nanmax(err, e);
      }
    }
    err = block_max(err, red_max[parity]);
    parity ^= 1u;
    const bool finite = isfinite(err);
    if (err <= T(1) && finite) {
      tau = tau + h_try;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
#pragma unroll
        for (int i = 0; i < N; ++i) x[k][i] = y2[k][i];
      }
    }
    T e_fl = finite ? err : T(1e4);
    e_fl = e_fl > T(1e-12) ? e_fl : T(1e-12);
    T hn = h_try * T(EM_SAFETY) * (T(1) / Fn<T>::sqrt(e_fl));
    hn = hn > T(EM_MIN_STEP) ? hn : T(EM_MIN_STEP);
    h = hn < T(EM_MAX_STEP) ? hn : T(EM_MAX_STEP);
    const bool done = tau >= thr;
    const bool stalled = (tau + h) <= tau && !done;
    live = !done && !stalled;
  }
  trial += it;
  if (tau < thr) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
#pragma unroll
      for (int i = 0; i < N; ++i) x[k][i] = T(NAN);
    }
  }
}

template <typename T, int PPT, bool FEAT>
__global__ void __launch_bounds__(THREADS, min_blocks<T>(PPT)) fused_sde_kernel(
    const std::conditional_t<FEAT, FeatArgs<T>, Args<T>> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cloud = reinterpret_cast<T*>(smem_raw);  // [N][P]
  T* cw = cloud + (size_t)N * a.P;             // [P]
  __shared__ T red_max[2][WARPS];              // double-buffered by trial
  __shared__ T red_sum[WARPS];
  __shared__ T red_scan[WARPS];

  const int r = (int)(blockIdx.x / (unsigned)a.S);
  const int s = (int)(blockIdx.x - (unsigned)r * (unsigned)a.S);
  const int P = a.P;
  const int j0 = threadIdx.x * PPT;
  const size_t row = (size_t)r * a.M;
  const size_t RM = (size_t)a.R * a.M;
  const T inv_P = T(1.0 / (double)P);
  const T tiny = Fn<T>::tiny();
  const T SQRT_2PI = T(2.5066282746310002);
  const size_t rs = (size_t)r * a.S + s;  // this cell in an [R, S] plane

  T p[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) p[k] = a.params[(size_t)k * a.S + s];

  // the initial cloud: init at t = 0 on the occasion init_mask marks
  T x[PPT][N];
  const T im = a.init != nullptr ? a.init_mask[r] : T(0);
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      x[k][i] = a.init != nullptr ? im * a.init[(size_t)i * a.S + s] : T(0);
  }
  if constexpr (FEAT) {
    if (a.f.init_planes != nullptr) {
      // an init that reads a covariate: one value per (row, support)
      const T im_p = a.init_mask[r];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
#pragma unroll
        for (int i = 0; i < N; ++i)
          x[k][i] = im_p * a.f.init_planes[(size_t)i * a.R * a.S + rs];
      }
    }
  }
  T ca[NC], cb[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) ca[c] = cb[c] = T(0);
  // each bolus plane's pending (lagged) dose: amount and time to fire, the
  // same in every thread of the block
  T pend_amt[NIN], pend_rem[NIN];
#pragma unroll
  for (int k = 0; k < NIN; ++k) pend_amt[k] = pend_rem[k] = T(0);

  T ll = T(0);
  unsigned parity = 0;  // selects red_max's buffer, trial by trial
  for (int m = 0; m < a.M; ++m) {
    const size_t idx = row + m;

    // 1. the observation, before the segment's dose
    if (a.obs_mask[idx] > T(0)) {
      const T sig = a.obs_sigma[idx];
      const T val = a.obs_value[idx];
      const T sc = a.obs_cens != nullptr ? a.obs_cens[idx] : T(0);
      const int oe = a.n_out > 1 ? (int)a.obs_outeq[idx] : 0;
      T q[PPT];
      T qs = T(0);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        q[k] = T(0);
        if (j0 + k < P) {
          T pred = T(0);
          if (oe >= 0 && oe < a.n_out) {
            const T* ck = a.coef + (size_t)oe * N * a.S + s;
            pred = ck[0] * x[k][0];
#pragma unroll
            for (int i = 1; i < N; ++i) pred = pred + ck[(size_t)i * a.S] * x[k][i];
            if (a.bias != nullptr) pred = pred + a.bias[(size_t)oe * a.S + s];
          }
          const T z = (val - pred) / sig;
          q[k] = sc == T(0) ? Fn<T>::exp(T(-0.5) * z * z) / (sig * SQRT_2PI)
                            : ndtr(sc * z);
          qs = qs + q[k];
        }
      }
      const T sum_q = block_sum(qs, red_sum);
      ll = ll + Fn<T>::log(nanmax(sum_q * inv_P, tiny));
      const T denom = nanmax(sum_q, tiny);
      T loc[PPT];
      T run = T(0);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (j0 + k < P) run = run + q[k] / denom;
        loc[k] = run;
      }
      const T base = block_exclusive_scan(run, red_scan);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int j = j0 + k;
        if (j < P) {
          cw[j] = base + loc[k];
#pragma unroll
          for (int i = 0; i < N; ++i) cloud[(size_t)i * P + j] = x[k][i];
        }
      }
      __syncthreads();
      // stratified resampling: u_j = (j + U_j) / P, first cw >= u_j
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int j = j0 + k;
        if (j < P) {
          const U4 w = philox(counter(j, m, 0, SLOT_RESAMPLE, 0, s, r), a.key);
          const T u = (T(j) + Fn<T>::uniform(w)) / T(P);
          int lo = 0, hi = P;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (cw[mid] < u) lo = mid + 1;
            else hi = mid;
          }
          const int src = lo < P - 1 ? lo : P - 1;
#pragma unroll
          for (int i = 0; i < N; ++i) x[k][i] = cloud[(size_t)i * P + src];
        }
      }
      __syncthreads();  // the cloud and cw are rewritten at the next observation
    }

    // 2. the segment's rates, start time and (K3b) covariates
    const T dt = a.seg_dt[idx];
    T rate[NIN];
    segment_rates(a, idx, rate);
    const T t0 = a.seg_t0[idx];
    int trial = 0;
    if constexpr (FEAT) {
      if (NCOV > 0) {
#pragma unroll
        for (int c = 0; c < NCOV; ++c) {
          ca[c] = a.f.cov_a[c * RM + idx];
          cb[c] = a.f.cov_b != nullptr ? a.f.cov_b[c * RM + idx] : T(0);
        }
      }
      if (a.f.n_lag > 0) {
        // K3b with lag (the JAX kernel's :475-538). 3a. doses due at this
        // breakpoint fire after its observation
#pragma unroll
        for (int b = 0; b < NIN; ++b) {
          if (b >= a.nb) break;
          if (pend_amt[b] != T(0) && pend_rem[b] <= T(0)) {
            add_dose<PPT>(x, a.dose_state[b], pend_amt[b]);
            pend_amt[b] = T(0);
          }
        }
        // 3b. arrivals park with their lag
#pragma unroll
        for (int b = 0; b < NIN; ++b) {
          if (b >= a.nb) break;
          const int slot = a.f.lag_slots[b * a.M + m];
          if (slot < 0) continue;
          const T bol = a.seg_bolus[(size_t)b * RM + idx];
          if (bol != T(0)) {
            pend_amt[b] = pend_amt[b] + bol * fa_scale(a, b, m, rs);
            pend_rem[b] = a.f.lag[(size_t)slot * a.R * a.S + rs];
          }
        }
        // 3c. the split march: one pass per bolus plane to the next
        // earliest fire time, and a last one to the segment's end
        T elapsed = T(0);
        for (int pass = 0; pass <= a.nb; ++pass) {
          const bool last = pass == a.nb;
          bool will[NIN];
          T t_next = dt;
#pragma unroll
          for (int b = 0; b < NIN; ++b) {
            will[b] = !last && b < a.nb && pend_amt[b] != T(0) && pend_rem[b] < dt;
            const T cand = will[b] ? pend_rem[b] : dt;
            t_next = cand < t_next ? cand : t_next;
          }
          t_next = t_next > elapsed ? t_next : elapsed;
          em_march<T, PPT>(a, x, p, rate, ca, cb, t0 + elapsed, t_next - elapsed, m, trial,
                           r, s, red_max, parity);
#pragma unroll
          for (int b = 0; b < NIN; ++b) {
            if (will[b] && pend_rem[b] <= t_next) {
              add_dose<PPT>(x, a.dose_state[b], pend_amt[b]);
              pend_amt[b] = T(0);
            }
          }
          elapsed = t_next;
        }
        if (dt > T(0)) {
#pragma unroll
          for (int b = 0; b < NIN; ++b)
            if (pend_amt[b] != T(0)) pend_rem[b] = pend_rem[b] - dt;
        }
        continue;
      }
    }
    // 3. the segment's boluses (K3b: fa-scaled) into their destination
    // states, and the adaptive Euler-Maruyama march of the segment
    for (int b = 0; b < a.nb; ++b) {
      T amt = a.seg_bolus[(size_t)b * RM + idx];
      if constexpr (FEAT) amt = amt * fa_scale(a, b, m, rs);
      add_dose<PPT>(x, a.dose_state[b], amt);
    }
    em_march<T, PPT>(a, x, p, rate, ca, cb, t0, dt, m, trial, r, s, red_max, parity);
  }
  if (threadIdx.x == 0) a.out[(size_t)r * a.S + s] = ll;
}

template <typename T, int PPT, bool FEAT, typename A>
cudaError_t launch_ppt(const A& a, cudaStream_t stream) {
  const size_t smem = (size_t)(N + 1) * a.P * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_sde_kernel<T, PPT, FEAT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const unsigned cells = (unsigned)((long long)a.R * a.S);
  fused_sde_kernel<T, PPT, FEAT><<<cells, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool FEAT, typename A>
cudaError_t launch(const A& a, cudaStream_t stream) {
  if (a.R <= 0 || a.S <= 0) return cudaSuccess;
  if ((long long)a.R * a.S > (long long)INT_MAX || a.P < 1 || a.P > THREADS * 16 ||
      a.M > (1 << 16) || a.M < 1)
    return cudaErrorInvalidValue;
  const int ppt = (a.P + THREADS - 1) / THREADS;
  if (ppt <= 1) return launch_ppt<T, 1, FEAT>(a, stream);
  if (ppt <= 2) return launch_ppt<T, 2, FEAT>(a, stream);
  if (ppt <= 4) return launch_ppt<T, 4, FEAT>(a, stream);
  if (ppt <= 8) return launch_ppt<T, 8, FEAT>(a, stream);
  return launch_ppt<T, 16, FEAT>(a, stream);
}

template <typename T>
cudaError_t run(const void* const* ptr, const int* ints, void* out, int R, int S,
                int M, int P, int nb, int nr, int n_out, int coupled,
                uint32_t k0, uint32_t k1, cudaStream_t stream,
                const void* const* feat = nullptr, int n_lag = 0, int n_fa = 0) {
  FeatArgs<T> a = {};
  a.seg_dt = (const T*)ptr[0];
  a.seg_bolus = (const T*)ptr[1];
  a.seg_rate = (const T*)ptr[2];
  a.obs_mask = (const T*)ptr[3];
  a.obs_value = (const T*)ptr[4];
  a.obs_sigma = (const T*)ptr[5];
  a.obs_cens = (const T*)ptr[6];
  a.obs_outeq = (const T*)ptr[7];
  a.seg_t0 = (const T*)ptr[8];
  a.params = (const T*)ptr[9];
  a.init = (const T*)ptr[10];
  a.init_mask = (const T*)ptr[11];
  a.coef = (const T*)ptr[12];
  a.bias = (const T*)ptr[13];
  a.dose_state = ints;
  a.rate_in = ints + nb;
  a.out = (T*)out;
  a.R = R; a.S = S; a.M = M; a.P = P; a.nb = nb; a.nr = nr; a.n_out = n_out;
  a.coupled = coupled;
  a.key = key_schedule(k0, k1);
  if (feat == nullptr) {
#if PHARMSOL_SDE_FEAT
    return cudaErrorInvalidValue;  // the base tier's library builds K3a
#else
    // K3a: closures that read a covariate need K3b's streams
    if (NCOV > 0) return cudaErrorInvalidValue;
    return launch<T, false>(static_cast<const Args<T>&>(a), stream);
#endif
  }
#if !PHARMSOL_SDE_FEAT
  return cudaErrorInvalidValue;  // the feature tier's library builds K3b
#else
  Feat<T>& f = a.f;
  f.cov_a = (const T*)feat[0];
  f.cov_b = (const T*)feat[1];
  f.lag = (const T*)feat[2];
  f.fa = (const T*)feat[3];
  f.init_planes = (const T*)feat[4];
  f.n_lag = n_lag;
  f.n_fa = n_fa;
  // the slot tables follow the rate inputs: lag's, then fa's
  const int* slots = ints + nb + nr;
  f.lag_slots = n_lag > 0 ? slots : nullptr;
  f.fa_slots = n_fa > 0 ? slots + (n_lag > 0 ? nb * M : 0) : nullptr;
  if ((NCOV > 0 && f.cov_a == nullptr) || (n_lag > 0 && f.lag == nullptr) ||
      (n_fa > 0 && f.fa == nullptr) || nb > NIN ||
      (f.init_planes != nullptr && (a.init != nullptr || a.init_mask == nullptr)))
    return cudaErrorInvalidValue;
  return launch<T, true>(a, stream);
#endif
}

template <typename T, int PPT, bool FEAT>
cudaError_t occupancy_ppt(int P, int* blocks) {
  const size_t smem = (size_t)(N + 1) * P * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_sde_kernel<T, PPT, FEAT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fused_sde_kernel<T, PPT, FEAT>,
                                                       THREADS, smem);
}

template <typename T, bool FEAT>
cudaError_t occupancy(int ppt, int P, int* blocks) {
  if (ppt <= 1) return occupancy_ppt<T, 1, FEAT>(P, blocks);
  if (ppt <= 2) return occupancy_ppt<T, 2, FEAT>(P, blocks);
  if (ppt <= 4) return occupancy_ppt<T, 4, FEAT>(P, blocks);
  if (ppt <= 8) return occupancy_ppt<T, 8, FEAT>(P, blocks);
  return occupancy_ppt<T, 16, FEAT>(P, blocks);
}

__global__ void philox_kernel(int n, const uint32_t* ctr, const Key key, uint32_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const U4 w = philox(U4{ctr[4 * i], ctr[4 * i + 1], ctr[4 * i + 2], ctr[4 * i + 3]}, key);
  out[4 * i] = w.x;
  out[4 * i + 1] = w.y;
  out[4 * i + 2] = w.z;
  out[4 * i + 3] = w.w;
}

}  // namespace

// Launch on `stream`. Pointers: seg_dt [R, M], seg_bolus [nb, R, M], seg_rate
// [nr, R, M] (or null with nr == 0), obs_mask, obs_value, obs_sigma,
// obs_cens (or null), obs_outeq (or null when n_out == 1), seg_t0: [R, M];
// params [NP, S]; init [N, S] and init_mask [R] (both or neither null); coef
// [n_out, N, S]; bias [n_out, S] (or null); ints: int32 [nb destination
// states, nr rate inputs]; out [R, S]. All floating data float (is_f64 == 0)
// or double. (k0, k1) is the Philox key. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int fused_sde_launch(int is_f64, const void* seg_dt, const void* seg_bolus,
                                const void* seg_rate, const void* obs_mask,
                                const void* obs_value, const void* obs_sigma,
                                const void* obs_cens, const void* obs_outeq,
                                const void* seg_t0, const void* params,
                                const void* init, const void* init_mask,
                                const void* coef, const void* bias, const void* ints,
                                void* out, int R, int S, int M, int P, int nb, int nr,
                                int n_out, int coupled, uint32_t k0, uint32_t k1,
                                void* stream) {
  const void* ptr[14] = {seg_dt, seg_bolus, seg_rate, obs_mask, obs_value,
                         obs_sigma, obs_cens, obs_outeq, seg_t0, params, init,
                         init_mask, coef, bias};
  cudaStream_t st = (cudaStream_t)stream;
  const int* iv = (const int*)ints;
  const cudaError_t err =
      is_f64 ? run<double>(ptr, iv, out, R, S, M, P, nb, nr, n_out, coupled, k0, k1, st)
             : run<float>(ptr, iv, out, R, S, M, P, nb, nr, n_out, coupled, k0, k1, st);
  return (int)err;
}

// K3b: the same launch with the feature tier. base: the 14 pointers of
// fused_sde_launch in its order (init may be null with init_planes set);
// feat: cov_a [NCOV, R, M], cov_b [NCOV, R, M] (or null), lag [n_lag, R, S],
// fa [n_fa, R, S], init_planes [N, R, S], each null when off; ints as
// fused_sde_launch's, then the lag slot table [nb, M] when n_lag > 0 and the
// fa slot table [nb, M] when n_fa > 0. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for an inconsistent feature set).
extern "C" int fused_sde_feature_launch(int is_f64, const void* const* base,
                                        const void* const* feat, const void* ints,
                                        void* out, int R, int S, int M, int P, int nb,
                                        int nr, int n_out, int coupled, int n_lag,
                                        int n_fa, uint32_t k0, uint32_t k1,
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* iv = (const int*)ints;
  const cudaError_t err =
      is_f64 ? run<double>(base, iv, out, R, S, M, P, nb, nr, n_out, coupled, k0, k1, st,
                           feat, n_lag, n_fa)
             : run<float>(base, iv, out, R, S, M, P, nb, nr, n_out, coupled, k0, k1, st,
                          feat, n_lag, n_fa);
  return (int)err;
}

// The raw Philox4x32-10 words of n counters [n, 4] under the key (k0, k1):
// a check of the kernel's generator against its twin, off the psi path.
extern "C" int fused_sde_philox(int n, const void* ctr, uint32_t k0, uint32_t k1,
                                void* out, void* stream) {
  if (n <= 0) return 0;
  philox_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      n, (const uint32_t*)ctr, key_schedule(k0, k1), (uint32_t*)out);
  return (int)cudaGetLastError();
}

// Blocks of the tier's kernel for P particles that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor with the launch's dynamic
// shared memory), into *blocks. Returns the cudaError_t.
extern "C" int fused_sde_occupancy(int is_f64, int P, int* blocks) {
  constexpr bool FEAT = PHARMSOL_SDE_FEAT != 0;
  *blocks = 0;
  if (P < 1 || P > THREADS * 16) return (int)cudaErrorInvalidValue;
  const int ppt = (P + THREADS - 1) / THREADS;
  return (int)(is_f64 ? occupancy<double, FEAT>(ppt, P, blocks)
                      : occupancy<float, FEAT>(ppt, P, blocks));
}

// The generated closures this library was built with: {states, params, inputs}.
extern "C" void fused_sde_signature(int* out3) {
  out3[0] = N;
  out3[1] = NP;
  out3[2] = NIN;
}

extern "C" const char* fused_sde_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
