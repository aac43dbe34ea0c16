// Fused population psi for the closed-form PK structures, for Hopper (sm_90a).
//
// One kernel body, fused_psi_feature_kernel<T, CODE, TIER>, in three tiers.
//
// K1a, TIER_K1A: replaces the TPU kernel
// pharmsol_tpu/ops/pallas_psi.py::psi_oral (_make_kernel, base tier:
// infusions, censoring, several outputs, output biases; all 12 structures).
//
// K1b, TIER_K1B: replaces the same TPU kernel's feature tier (_make_kernel
// with mult_mode row / segment / levels / planes, has_offsets, static
// has_lag / has_fa planes, has_init rows or planes; pallas_psi.py:583-606,
// :655-723, :762-782).
//
// K1c, TIER_K1C: the rest of that tier (pallas_psi.py:498-527, :725-758):
// lag and fa planes selected per dose
// segment by slot tables (lag_slots / fa_slots); lag_depth, lag with a seq
// chain deeper than one, where an int depth counter dc with its `applied`
// flag replays the engine's reset/carry rule on an event-code stream (1
// resets, 2 compounds, 0 is a bolus column whose event moved with its lag)
// and the segment where the dose fires runs a true split march: propagate to
// the fire at the pre-fire level, add the pending dose, reset to depth 1 and
// propagate the rest; lag_post, lag with a time-varying seq, where two slot
// streams select the pre-fire and the post-fire parameters from the same
// [L, n_base, R, S] plane tensor for the same split march. The TPU's lane
// masks become branches. K1b's instantiations do not compile any of this,
// and K1a's compile none of the feature code (the tier is a template
// parameter).
//
// Plain PyTorch twin of all three:
// pharmsol_tpu_torch/ops/fused_psi.py::psi_analytical_plain.
//
// Layout. threadIdx.x runs along the supports, so the parameter rows
// [n_params, S], the output coefficients [n_out, n_states, S], the psi writes
// [R, S] and the planes ([R, S] lag / fa / init planes, [L, n_micro, R, S]
// parameter planes, S fastest) are coalesced, and the 32 threads of a warp
// share one row: their reads of the row's segment streams [R, M] and of its
// per-row and per-segment factors are broadcasts. The kernel masks the
// ragged support edge itself: no padding of R, S or M, and M has no limit.
//
// Per support: the point prepared (CL remap, 2-cmt eigenvalues, the 3-cmt
// cubic with acos, which Mosaic lacked); per cell, for every segment
// 1. add the observation term, read before the dose;
// 2. add the bolus to the dose state (padded slots carry 0);
// 3. propagate the state, only where dt > 0.
// Censored terms use the exact log of the normal CDF through erfcx/erfc.
//
// K1b adds, per cell: the initial state init_mask[r] * init (rows
// [n_states, S] or planes [n_states, R, S]); effective parameters
// raw * mult + offset per row (prepared once per row, CL remap in the
// kernel) or per segment (prepared on every spanned segment); in levels /
// planes mode micro-constant tables selected by the segment's chain depth;
// fa scales the bolus; with lag the bolus waits in two registers (pend_amt,
// pend_rem) and fires inside the segment where its lag elapses (strict rem
// < dt), adding the dose vector propagated over dt - rem without infusion
// forcing (superposition; exact for these linear kernels).
//
// What bounds it. Arithmetic issue: per cell and segment (2-cmt oral) three
// exponentials beside ~40 fused multiply-adds; at 16384 x 512 with 10
// segments that is ~7e9 instructions against ~3.3e13 FP32
// lane-instructions/s on 132 SMs. Memory is minor: psi written once per
// cell, and stream bytes that the warp shares. In float64, exp and log are
// software routines on the FP64 pipes, which bound it.
//
// The design for that bound (measured against one thread a cell in
// PERF.md), all three tiers: a persistent grid of 128-thread blocks, as many
// as the card holds, each block a tile of 128 supports walking a share of
// the rows, so that what depends on the support alone is loaded or computed
// once per thread, not per cell: the prepared model (K1a, K1b's mode none),
// the first two output rows, a covariate-free lag or fa given as one row per
// support (row stride 0), and in levels mode the level models, prepared once
// per (level, support) by prepare_levels_kernel into a [L, NPREP, S] table
// and loaded at a change of depth; K1c's post-fire model goes into the same
// one model. The
// row's observation constants are hoisted out of the cell: the launch first
// computes, once per row, obs_const[r] (the sum of -log(2 pi) / 2 - log
// sigma over the row's uncensored observations) and obs_isig = 1 / sigma
// (observation_terms_kernel); the kernel starts a cell at obs_const[r] and
// multiplies by obs_isig, so no logarithm and no division remain per cell
// and observation. Registers are capped per tier, dtype and structure so
// that no instantiation spills (TierBlocks).
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfused_psi.so fused_psi.cu

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

template <typename T>
struct Fn;

template <>
struct Fn<float> {
  static __device__ __forceinline__ float exp(float x) { return expf(x); }
  static __device__ __forceinline__ float log(float x) { return logf(x); }
  static __device__ __forceinline__ float log1p(float x) { return log1pf(x); }
  static __device__ __forceinline__ float erfc(float x) { return erfcf(x); }
  static __device__ __forceinline__ float erfcx(float x) { return erfcxf(x); }
  static __device__ __forceinline__ float sqrt(float x) { return sqrtf(x); }
  static __device__ __forceinline__ float acos(float x) { return acosf(x); }
  static __device__ __forceinline__ float cos(float x) { return cosf(x); }
};

template <>
struct Fn<double> {
  static __device__ __forceinline__ double exp(double x) { return ::exp(x); }
  static __device__ __forceinline__ double log(double x) { return ::log(x); }
  static __device__ __forceinline__ double log1p(double x) { return ::log1p(x); }
  static __device__ __forceinline__ double erfc(double x) { return ::erfc(x); }
  static __device__ __forceinline__ double erfcx(double x) { return ::erfcx(x); }
  static __device__ __forceinline__ double sqrt(double x) { return ::sqrt(x); }
  static __device__ __forceinline__ double acos(double x) { return ::acos(x); }
  static __device__ __forceinline__ double cos(double x) { return ::cos(x); }
};

// log Phi(x), exact: the left tail through the scaled complementary error
// function, the right side through log1p.
template <typename T>
__device__ __forceinline__ T log_ndtr(T x) {
  const T inv_sqrt2 = T(0.70710678118654752440);
  if (x < T(0)) {
    return Fn<T>::log(T(0.5) * Fn<T>::erfcx(-x * inv_sqrt2)) - T(0.5) * x * x;
  }
  return Fn<T>::log1p(T(-0.5) * Fn<T>::erfc(x * inv_sqrt2));
}

template <typename T>
__device__ __forceinline__ T clampv(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Per-cell model: NCMT compartments, ORAL adds a depot (state 0), CL takes
// the clearance parameterization. States: [depot,] central, peripherals.
template <typename T, int NCMT, bool ORAL, bool CL>
struct Model {
  static constexpr int NS = NCMT + (ORAL ? 1 : 0);
  static constexpr int NP = (NCMT == 1 ? (CL ? 2 : 1)
                             : NCMT == 2 ? (CL ? 4 : 3)
                                         : (CL ? 6 : 5)) + (ORAL ? 1 : 0);
  // micro constants
  T ka, k[5];
  // prepared quantities
  T l[3], inv_denom, inv_ka_l[3], inv_ke, ss2, ss3, ratio;
  T P[3][9];

  // micro constants of the structure: NP less the volume of a CL remap
  static constexpr int NB = NP - (CL ? 1 : 0);

  // raw: the support's leading NP columns; CL columns are remapped to the
  // micro constants exactly as the *_cl_models.rs reparameterizations.
  // micro: raw holds the NB micro constants already (K1b's level tables).
  __device__ __forceinline__ void prepare(const T* raw, bool micro = false) {
    const bool cl = CL && !micro;
    if (NCMT == 1) {
      // [ke] | [cl, v] | [ka, ke] | [ka, cl, v]
      const int o = ORAL ? 1 : 0;
      ka = ORAL ? raw[0] : T(0);
      k[0] = cl ? raw[o] / raw[o + 1] : raw[o];
      inv_ke = T(1) / k[0];
      ratio = ORAL ? ka / (ka - k[0]) : T(0);
    } else if (NCMT == 2) {
      // k = [ke, kcp, kpc] from [ke, kcp, kpc] | [cl, q, vc, vp] |
      // [ke, ka, kcp, kpc] | [ka, cl, q, vc, vp]
      if (!ORAL && !cl) {
        k[0] = raw[0]; k[1] = raw[1]; k[2] = raw[2];
      } else if (!ORAL && cl) {
        k[0] = raw[0] / raw[2]; k[1] = raw[1] / raw[2]; k[2] = raw[1] / raw[3];
      } else if (!cl) {
        k[0] = raw[0]; ka = raw[1]; k[1] = raw[2]; k[2] = raw[3];
      } else {
        ka = raw[0];
        k[0] = raw[1] / raw[3]; k[1] = raw[2] / raw[3]; k[2] = raw[2] / raw[4];
      }
      T ke = k[0], kcp = k[1], kpc = k[2];
      T sum = ke + kcp + kpc;
      T disc = sum * sum - T(4) * ke * kpc;
      T sq = Fn<T>::sqrt(disc > T(0) ? disc : T(0));
      l[0] = (sum + sq) * T(0.5);
      l[1] = (sum - sq) * T(0.5);
      inv_denom = T(1) / (l[0] - l[1]);
      inv_ke = T(1) / ke;
      ss2 = kcp / (ke * kpc);
      if (ORAL) {
        inv_ka_l[0] = T(1) / (ka - l[0]);
        inv_ka_l[1] = T(1) / (ka - l[1]);
      }
    } else {
      // k = [k10, k12, k13, k21, k31] from the same columns, or
      // [cl, q1, q2, vc, vp1, vp2]; oral structures lead with ka
      const int o = ORAL ? 1 : 0;
      ka = ORAL ? raw[0] : T(0);
      if (cl) {
        T cl_ = raw[o], q1 = raw[o + 1], q2 = raw[o + 2];
        T vc = raw[o + 3], vp1 = raw[o + 4], vp2 = raw[o + 5];
        k[0] = cl_ / vc; k[1] = q1 / vc; k[2] = q2 / vc;
        k[3] = q1 / vp1; k[4] = q2 / vp2;
      } else {
#pragma unroll
        for (int i = 0; i < 5; ++i) k[i] = raw[o + i];
      }
      T k10 = k[0], k12 = k[1], k13 = k[2], k21 = k[3], k31 = k[4];
      // decay constants: trigonometric solution of the monic cubic
      T A = k10 + k12 + k13 + k21 + k31;
      T B = k10 * k21 + k10 * k31 + k12 * k31 + k13 * k21 + k21 * k31;
      T C = k10 * k21 * k31;
      T p = B - A * A / T(3);
      T q = T(-2) * A * A * A / T(27) + A * B / T(3) - C;
      T mp3 = -p / T(3);
      mp3 = mp3 > T(1e-30) ? mp3 : T(1e-30);
      T rt = Fn<T>::sqrt(mp3);
      T pm = p < T(-1e-30) ? p : T(-1e-30);
      T arg = clampv(T(3) * q / (T(2) * pm) / rt, T(-1), T(1));
      T phi = Fn<T>::acos(arg) / T(3);
      const T two_pi_3 = T(2.0943951023931954923);
      l[0] = T(2) * rt * Fn<T>::cos(phi) + A / T(3);
      l[1] = T(2) * rt * Fn<T>::cos(phi - two_pi_3) + A / T(3);
      l[2] = T(2) * rt * Fn<T>::cos(phi - T(2) * two_pi_3) + A / T(3);
      // Lagrange spectral projectors of the rate matrix
      T a11 = -(k10 + k12 + k13);
      T m11 = a11 * a11 + k21 * k12 + k31 * k13;
      T m12 = k21 * (a11 - k21);
      T m13 = k31 * (a11 - k31);
      T m21 = k12 * (a11 - k21);
      T m22 = k12 * k21 + k21 * k21;
      T m23 = k12 * k31;
      T m31 = k13 * (a11 - k31);
      T m32 = k13 * k21;
      T m33 = k13 * k31 + k31 * k31;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        T lk = l[j], lj = l[(j + 1) % 3], ll = l[(j + 2) % 3];
        T s = lj + ll, pr = lj * ll;
        T invd = T(1) / ((lj - lk) * (ll - lk));
        P[j][0] = (m11 + s * a11 + pr) * invd;
        P[j][1] = (m12 + s * k21) * invd;
        P[j][2] = (m13 + s * k31) * invd;
        P[j][3] = (m21 + s * k12) * invd;
        P[j][4] = (m22 + s * (-k21) + pr) * invd;
        P[j][5] = m23 * invd;
        P[j][6] = (m31 + s * k13) * invd;
        P[j][7] = m32 * invd;
        P[j][8] = (m33 + s * (-k31) + pr) * invd;
        if (ORAL) inv_ka_l[j] = T(1) / (ka - lk);
      }
      inv_ke = T(1) / k10;
      ss2 = k12 / (k10 * k21);
      ss3 = k13 / (k10 * k31);
    }
  }

  // The prepared fields that propagate reads, in a fixed order: K1b's and
  // K1c's level models are prepared once per (level, support) and kept in a
  // table of NPREP values each.
  static constexpr int NPREP = NCMT == 1 ? (ORAL ? 4 : 2)
                               : NCMT == 2 ? (ORAL ? 11 : 8)
                                           : (ORAL ? 37 : 33);
  template <class V>
  __device__ __forceinline__ void fields(V&& v) {
    if constexpr (NCMT == 1) {
      v(k[0]); v(inv_ke);
      if constexpr (ORAL) { v(ka); v(ratio); }
    } else if constexpr (NCMT == 2) {
      v(k[0]); v(k[1]); v(k[2]); v(l[0]); v(l[1]); v(inv_denom); v(inv_ke); v(ss2);
      if constexpr (ORAL) { v(ka); v(inv_ka_l[0]); v(inv_ka_l[1]); }
    } else {
      v(l[0]); v(l[1]); v(l[2]);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
#pragma unroll
        for (int q = 0; q < 9; ++q) v(P[j][q]);
      }
      v(inv_ke); v(ss2); v(ss3);
      if constexpr (ORAL) { v(ka); v(inv_ka_l[0]); v(inv_ka_l[1]); v(inv_ka_l[2]); }
    }
  }
  // field i at dst[i * stride]
  __device__ __forceinline__ void store(T* dst, size_t stride) {
    int i = 0;
    fields([&](T& x) { dst[(size_t)(i++) * stride] = x; });
  }
  __device__ __forceinline__ void load(const T* __restrict__ src, size_t stride) {
    int i = 0;
    fields([&](T& x) { x = src[(size_t)(i++) * stride]; });
  }

  // advance x over dt (> 0) with infusion rate `rate` into central
  __device__ __forceinline__ void propagate(T* x, T dt, T rate, bool has_inf) const {
    if (NCMT == 1) {
      T ke = k[0];
      T eke = Fn<T>::exp(-ke * dt);
      if (!ORAL) {
        if (has_inf) {
          T ss = rate * inv_ke;
          x[0] = ss + (x[0] - ss) * eke;
        } else {
          x[0] = x[0] * eke;
        }
      } else {
        T eka = Fn<T>::exp(-ka * dt);
        T nx1 = x[1] * eke + ratio * x[0] * (eke - eka);
        if (has_inf) nx1 = nx1 + rate * inv_ke * (T(1) - eke);
        x[0] = x[0] * eka;
        x[1] = nx1;
      }
    } else if (NCMT == 2) {
      constexpr int c = ORAL ? 1 : 0;
      T ke = k[0], kcp = k[1], kpc = k[2], l1 = l[0], l2 = l[1];
      T e1 = Fn<T>::exp(-l1 * dt);
      T e2 = Fn<T>::exp(-l2 * dt);
      T ss1 = T(0), ssp = T(0);
      T y1 = x[c], y2 = x[c + 1];
      if (has_inf) {
        ss1 = rate * inv_ke;
        ssp = rate * ss2;
        y1 = y1 - ss1;
        y2 = y2 - ssp;
      }
      T hom0 = ((l1 - kpc) * e1 + (kpc - l2) * e2) * y1 + kpc * (e2 - e1) * y2;
      T hom1 = kcp * (e2 - e1) * y1 + ((l1 - ke - kcp) * e1 + (ke + kcp - l2) * e2) * y2;
      T nx1, nx2;
      if (ORAL) {
        T eka = Fn<T>::exp(-ka * dt);
        T abs0 = (l1 - kpc) * inv_ka_l[0] * (e1 - eka) + (kpc - l2) * inv_ka_l[1] * (e2 - eka);
        T abs1 = kcp * (inv_ka_l[1] * (e2 - eka) - inv_ka_l[0] * (e1 - eka));
        T scale = ka * x[0] * inv_denom;
        nx1 = hom0 * inv_denom + abs0 * scale;
        nx2 = hom1 * inv_denom + abs1 * scale;
        x[0] = x[0] * eka;
      } else {
        nx1 = hom0 * inv_denom;
        nx2 = hom1 * inv_denom;
      }
      if (has_inf) {
        nx1 = nx1 + ss1;
        nx2 = nx2 + ssp;
      }
      x[c] = nx1;
      x[c + 1] = nx2;
    } else {
      constexpr int c = ORAL ? 1 : 0;
      T y1 = x[c], y2 = x[c + 1], y3 = x[c + 2];
      T nx1 = T(0), nx2 = T(0), nx3 = T(0);
      if (has_inf) {
        T ss1 = rate * inv_ke, ssa = rate * ss2, ssb = rate * ss3;
        y1 = y1 - ss1; y2 = y2 - ssa; y3 = y3 - ssb;
        nx1 = ss1; nx2 = ssa; nx3 = ssb;
      }
      T eka = ORAL ? Fn<T>::exp(-ka * dt) : T(0);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        T ek = Fn<T>::exp(-l[j] * dt);
        nx1 = nx1 + ek * (P[j][0] * y1 + P[j][1] * y2 + P[j][2] * y3);
        nx2 = nx2 + ek * (P[j][3] * y1 + P[j][4] * y2 + P[j][5] * y3);
        nx3 = nx3 + ek * (P[j][6] * y1 + P[j][7] * y2 + P[j][8] * y3);
        if (ORAL) {
          // depot forcing: ka*x0 * (ek - eka)/(ka - lk) * (P @ e1)
          T f = ka * x[0] * (ek - eka) * inv_ka_l[j];
          nx1 = nx1 + f * P[j][0];
          nx2 = nx2 + f * P[j][3];
          nx3 = nx3 + f * P[j][6];
        }
      }
      if (ORAL) x[0] = x[0] * eka;
      x[c] = nx1;
      x[c + 1] = nx2;
      x[c + 2] = nx3;
    }
  }
};

enum { MODE_NONE = 0, MODE_ROW = 1, MODE_SEGMENT = 2, MODE_LEVELS = 3, MODE_PLANES = 4 };

// The tiers of the one kernel body: K1a (no feature input), K1b, K1c.
enum { TIER_K1A = 0, TIER_K1B = 1, TIER_K1C = 2 };

// K1b's feature inputs: mult [R, NP] and offset, mult_seg [R, NP, M] and
// offset, levels [L, NB, S], planes [L, NB, R, S], depth [R, M] (1-based),
// lag and fa [R, S] or one row per support [1, S] (row stride S or 0; K1c's
// slot-selected stacks [n, R, S]), init rows [NS, S] or planes [NS, R, S],
// init mask [R]; nullptr is off. mode: 0 none, 1 row, 2 segment, 3 levels,
// 4 planes.
struct Features {
  const void* p[12];
  int mode, n_levels;
  int lag_row, fa_row;  // row strides of the lag and fa planes: S, or 0
};

// K1c's: K1b's, then the event codes [R, M], the post slots [R, M] and the
// int slot tables of the lag and fa planes [M] (-1: no dose there). K1b's
// kernel takes Features alone, so its parameters are laid out as before K1c.
struct K1cFeatures {
  Features b;
  const void* evcode;
  const void* postdepth;
  const int* lag_slots;
  const int* fa_slots;
};

// K1a's: none. Its instantiations read no feature pointer, and the mode and
// row strides are mode none's constants, so every branch on them folds away
// when the base tier compiles.
struct NoFeatures {
  static constexpr int mode = MODE_NONE, n_levels = 0, lag_row = 0, fa_row = 0;
};

template <int TIER>
using FeaturesOf = std::conditional_t<
    TIER == TIER_K1C, K1cFeatures, std::conditional_t<TIER == TIER_K1B, Features, NoFeatures>>;

// The kernel's streams (every tier): the segment streams [R, M], the observation
// terms (obs_isig [R, M], 1 / sigma; obs_const [R], each row's sum over its
// uncensored observations of -log(2 pi) / 2 - log sigma), the parameter rows
// [NP, S], the output rows, psi [R, S], and the prepared level models
// [L, NPREP, S] (levels mode); the launch fills the terms and the table
// first.
struct FeatureStreams {
  const void *seg_dt, *seg_bolus, *seg_rate, *obs_mask, *obs_value, *obs_isig,
      *obs_const, *obs_cens, *obs_outeq, *params, *coef, *bias;
  void* out;
  void* table;
  int R, S, M, n_out;
};

__host__ __device__ __forceinline__ const Features& base_of(const Features& f) { return f; }
__host__ __device__ __forceinline__ const Features& base_of(const K1cFeatures& f) {
  return f.b;
}
__host__ __device__ __forceinline__ const NoFeatures& base_of(const NoFeatures& f) { return f; }

// The micro constants of chain level d (1-based) of cell (r, s): levels
// [L, NB, S] or planes [L, NB, R, S] as the mode says.
template <typename T, int NB>
__device__ __forceinline__ void level_micro(T (&micro)[NB], int mode,
                                            const T* __restrict__ levels,
                                            const T* __restrict__ planes, int d, int r,
                                            int R, int S, int s) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const size_t lj = (size_t)(d - 1) * NB + j;
    micro[j] = mode == MODE_LEVELS ? levels[lj * S + s] : planes[(lj * R + r) * S + s];
  }
}

template <typename T, int CODE>
using ModelOf = Model<T, CODE / 4 + 1, (CODE % 2) == 1, ((CODE / 2) % 2) == 1>;

// The kernel's block: 128 supports of one row a pass, 32 to a warp.
constexpr int FEATURE_THREADS = 128;

// Blocks of 128 an SM that the register budget is set for, per tier, dtype
// and structure (__launch_bounds__: at most 65536 / (128 x blocks)
// registers a thread), chosen from the ptxas report (H100, nvcc 12.9) so
// that no instantiation spills. K1b and K1c: float32 at most 85 registers
// (3-compartment 170), float64 128 (the 2-compartment CL oral ones, code 7,
// spill 4-28 B there: 168), 3-compartment float64 255. K1a: float32 no cap
// (the compiler's own 31-90 registers spill nothing, and a cap of 64 ran
// the Short cell 9% slower), float64 1- and 2-compartment 102 (code 7 128;
// a cap of 85 ran slower), 3-compartment 255.
template <typename T, int CODE, int TIER>
struct TierBlocks {
  static constexpr int NCMT = CODE / 4 + 1;
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int value =
      TIER == TIER_K1A ? (F32 ? 1 : (NCMT == 3 ? 2 : CODE == 7 ? 4 : 5))
                       : (F32 ? (NCMT == 3 ? 3 : 6) : (NCMT == 3 ? 2 : CODE == 7 ? 3 : 4));
};

// Level models prepared once per (level, support): table [L, NPREP, S].
template <typename T, int CODE>
__global__ void __launch_bounds__(128) prepare_levels_kernel(const T* __restrict__ levels,
                                                             T* __restrict__ table, int S) {
  using Mdl = ModelOf<T, CODE>;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const int l = blockIdx.y;
  if (s >= S) return;
  T micro[Mdl::NB];
#pragma unroll
  for (int j = 0; j < Mdl::NB; ++j) micro[j] = levels[((size_t)l * Mdl::NB + j) * S + s];
  Mdl m;
  m.prepare(micro, true);
  m.store(table + (size_t)l * Mdl::NPREP * S + s, S);
}

// The observation terms of each row, once: isig [R, M] = 1 / sigma (1 where
// the mask is off) and cst [R], the sum of -log(2 pi) / 2 - log sigma over
// the row's uncensored observations, in the order of m.
template <typename T>
__global__ void __launch_bounds__(128) observation_terms_kernel(
    const T* __restrict__ mask, const T* __restrict__ sigma, const T* __restrict__ cens,
    T* __restrict__ isig, T* __restrict__ cst, int R, int M) {
  const T LOG_2PI = T(1.8378770664093454836);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  T c = T(0);
  for (int m = 0; m < M; ++m) {
    const size_t i = (size_t)r * M + m;
    const bool on = mask[i] > T(0);
    const T sig = on ? sigma[i] : T(1);
    isig[i] = T(1) / sig;
    if (on && (cens == nullptr || cens[i] == T(0)))
      c = c + (T(-0.5) * LOG_2PI - Fn<T>::log(sig));
  }
  cst[r] = c;
}

// Values per (row, segment) in the launch's scratch, before the rows'
// observation constants: K1a's float32 segment records (8), else 1 / sigma.
template <typename T, int TIER>
__host__ __device__ constexpr int per_segment() {
  return TIER == TIER_K1A && std::is_same<T, float>::value ? 8 : 1;
}

// K1a's float32 segment records, once per row: rec [R, M] of {dt, bolus,
// rate, value, 1 / sigma, censoring sign, outeq, mask} (two float4), and
// cst [R] as observation_terms_kernel computes it. A segment's values then
// arrive in two 16-byte loads issued together, none of them behind the
// observation's branch (in float32 the march waits on its loads; in float64
// the software exps hide them, and the records gained nothing there).
__global__ void __launch_bounds__(128) segment_records_kernel(
    const float* __restrict__ seg_dt, const float* __restrict__ seg_bolus,
    const float* __restrict__ seg_rate, const float* __restrict__ mask,
    const float* __restrict__ value, const float* __restrict__ sigma,
    const float* __restrict__ cens, const float* __restrict__ outeq, float4* __restrict__ rec,
    float* __restrict__ cst, int R, int M) {
  const float LOG_2PI = 1.8378770664093454836f;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float c = 0.0f;
  for (int m = 0; m < M; ++m) {
    const size_t i = (size_t)r * M + m;
    const bool on = mask[i] > 0.0f;
    const float sig = on ? sigma[i] : 1.0f;
    const float sc = cens != nullptr ? cens[i] : 0.0f;
    rec[2 * i] = float4{seg_dt[i], seg_bolus[i], seg_rate != nullptr ? seg_rate[i] : 0.0f,
                        value[i]};
    rec[2 * i + 1] = float4{1.0f / sig, sc, outeq != nullptr ? outeq[i] : 0.0f, mask[i]};
    if (on && sc == 0.0f) c = c + (-0.5f * LOG_2PI - logf(sig));
  }
  cst[r] = c;
}

// K1a, K1b and K1c, one kernel body, the tier a template parameter. A
// persistent grid: block (x, y) owns the 128 supports of tile x and walks
// rows y, y + gridDim.y, ...; a thread is one support and loads once, before
// its first row, what depends on the support alone: its prepared model (K1a,
// and K1b's mode none), its output rows (up to two outputs), its lag and fa
// where they are one row per support, and in levels mode where its prepared
// level models lie (a table). The 32 threads of a warp share a row, so the
// row streams stay broadcast reads. K1a's instantiations compile none of the
// feature code: its feature pointers are null constants and its mode is
// none (NoFeatures), and the lag, fa, init and level work sits behind
// `if constexpr (FEAT)`.
template <typename T, int CODE, int TIER>
__global__ void __launch_bounds__(FEATURE_THREADS, (TierBlocks<T, CODE, TIER>::value))
    fused_psi_feature_kernel(const FeatureStreams a, const FeaturesOf<TIER> fk) {
  using Mdl = ModelOf<T, CODE>;
  constexpr int NS = Mdl::NS;
  constexpr int NP = Mdl::NP;
  constexpr int NB = Mdl::NB;
  constexpr int NPREP = Mdl::NPREP;
  constexpr bool FEAT = TIER != TIER_K1A;
  constexpr bool K1C = TIER == TIER_K1C;
  // K1a in float32 reads its segments as records (segment_records_kernel)
  constexpr bool RECORDS = per_segment<T, TIER>() == 8;
  const auto& f = base_of(fk);
  const T* __restrict__ seg_dt = (const T*)a.seg_dt;
  const T* __restrict__ seg_bolus = (const T*)a.seg_bolus;
  const T* __restrict__ seg_rate = (const T*)a.seg_rate;
  const T* __restrict__ obs_mask = (const T*)a.obs_mask;
  const T* __restrict__ obs_value = (const T*)a.obs_value;
  const T* __restrict__ obs_isig = (const T*)a.obs_isig;
  const T* __restrict__ obs_const = (const T*)a.obs_const;
  const T* __restrict__ obs_cens = (const T*)a.obs_cens;
  const T* __restrict__ obs_outeq = (const T*)a.obs_outeq;
  const T* __restrict__ params = (const T*)a.params;
  const T* __restrict__ coef = (const T*)a.coef;
  const T* __restrict__ bias = (const T*)a.bias;
  T* __restrict__ out = (T*)a.out;
  // K1b's inputs (null in K1a's instantiation)
  const T* __restrict__ mult = nullptr;
  const T* __restrict__ offset = nullptr;
  const T* __restrict__ mult_seg = nullptr;
  const T* __restrict__ offset_seg = nullptr;
  const T* __restrict__ levels = nullptr;
  const T* __restrict__ planes = nullptr;
  const T* __restrict__ depth = nullptr;
  const T* __restrict__ lag = nullptr;
  const T* __restrict__ fa = nullptr;
  const T* __restrict__ init_rows = nullptr;
  const T* __restrict__ init_planes = nullptr;
  const T* __restrict__ init_mask = nullptr;
  if constexpr (FEAT) {
    mult = (const T*)f.p[0];
    offset = (const T*)f.p[1];
    mult_seg = (const T*)f.p[2];
    offset_seg = (const T*)f.p[3];
    levels = (const T*)f.p[4];
    planes = (const T*)f.p[5];
    depth = (const T*)f.p[6];
    lag = (const T*)f.p[7];
    fa = (const T*)f.p[8];
    init_rows = (const T*)f.p[9];
    init_planes = (const T*)f.p[10];
    init_mask = (const T*)f.p[11];
  }
  // K1c's own inputs (null in K1a's and K1b's instantiations)
  const T* __restrict__ evcode = nullptr;
  const T* __restrict__ postdepth = nullptr;
  const int* __restrict__ lag_slots = nullptr;
  const int* __restrict__ fa_slots = nullptr;
  if constexpr (K1C) {
    evcode = (const T*)fk.evcode;
    postdepth = (const T*)fk.postdepth;
    lag_slots = fk.lag_slots;
    fa_slots = fk.fa_slots;
  }
  const int R = a.R, S = a.S, M = a.M, n_out = a.n_out;
  [[maybe_unused]] const size_t RS = (size_t)R * S;

  const int s = blockIdx.x * FEATURE_THREADS + threadIdx.x;
  if (s >= S) return;
  const bool has_inf = seg_rate != nullptr;
  const bool has_cens = obs_cens != nullptr;
  const bool has_lag = lag != nullptr;

  // what depends on the support alone, kept across the rows (the raw
  // parameters only as the prepared model: row and segment mode read them
  // again where they scale them, so that no register holds them)
  Mdl mdl;
  if (f.mode == MODE_NONE) {
    T raw[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) raw[j] = params[(size_t)j * S + s];
    mdl.prepare(raw);
  }
  // levels mode: the prepared level models, this support's column of the
  // table [L, NPREP, S] that prepare_levels_kernel filled
  const T* lv = f.mode == MODE_LEVELS ? (const T*)a.table + s : nullptr;
  // the output rows of the first two outputs (a third reads per observation)
  const bool cf_kept = n_out <= 2;
  T cf[2][NS], bs[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
      cf[k][j] = (cf_kept && k < n_out) ? coef[((size_t)k * NS + j) * S + s] : T(0);
    bs[k] = (cf_kept && k < n_out && bias != nullptr) ? bias[(size_t)k * S + s] : T(0);
  }
  // lag and fa given as one row per support
  const T lag_s = (has_lag && f.lag_row == 0) ? lag[s] : T(0);
  const T fa_s = (fa != nullptr && f.fa_row == 0) ? fa[s] : T(1);

  for (int r = blockIdx.y; r < R; r += gridDim.y) {
    T x[NS];
    const T im = init_mask != nullptr ? init_mask[r] : T(0);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      x[i] = T(0);
      if (init_rows != nullptr) x[i] = im * init_rows[(size_t)i * S + s];
      if (init_planes != nullptr) x[i] = im * init_planes[((size_t)i * R + r) * S + s];
    }
    if (f.mode == MODE_ROW) {
      // each row's effective parameters, then the in-kernel CL remap
      T eff[NP];
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const size_t k = (size_t)r * NP + j;
        eff[j] = params[(size_t)j * S + s] * mult[k] + (offset != nullptr ? offset[k] : T(0));
      }
      mdl.prepare(eff);
    }
    int cur = 0;  // the chain level (or slot) the model holds (0: none)
    const T lag_rs = has_lag ? (f.lag_row != 0 ? lag[(size_t)r * S + s] : lag_s) : T(0);
    const T fa_rs = fa != nullptr ? (f.fa_row != 0 ? fa[(size_t)r * S + s] : fa_s) : T(1);
    // K1c: lag_depth's chain state (unused by K1a and K1b)
    [[maybe_unused]] int dc = 0;
    [[maybe_unused]] bool app = false;
    [[maybe_unused]] const bool split = K1C && (evcode != nullptr || postdepth != nullptr);
    T pend_amt = T(0), pend_rem = T(0);
    T ll = obs_const[r];
    const size_t row = (size_t)r * M;
    for (int m = 0; m < M; ++m) {
      const size_t i = row + m;
      // the segment's values: from its record (K1a, float32), else from the
      // streams where they are used
      [[maybe_unused]] float4 rec0, rec1;
      if constexpr (RECORDS) {
        rec0 = ((const float4*)a.obs_isig)[2 * i];
        rec1 = ((const float4*)a.obs_isig)[2 * i + 1];
      }
      auto dt_at = [&]() -> T { if constexpr (RECORDS) return rec0.x; else return seg_dt[i]; };
      auto bolus_at = [&]() -> T {
        if constexpr (RECORDS) return rec0.y; else return seg_bolus[i];
      };
      auto rate_at = [&]() -> T {
        if constexpr (RECORDS) return rec0.z; else return seg_rate[i];
      };
      auto value_at = [&]() -> T {
        if constexpr (RECORDS) return rec0.w; else return obs_value[i];
      };
      auto isig_at = [&]() -> T {
        if constexpr (RECORDS) return rec1.x; else return obs_isig[i];
      };
      auto cens_at = [&]() -> T {
        if constexpr (RECORDS) return rec1.y; else return obs_cens[i];
      };
      auto outeq_at = [&]() -> T {
        if constexpr (RECORDS) return rec1.z; else return obs_outeq[i];
      };
      auto mask_at = [&]() -> T {
        if constexpr (RECORDS) return rec1.w; else return obs_mask[i];
      };
      // 1. observation before dose: y_k = C_k . x (+ b_k); the row's
      // -log(2 pi) / 2 - log sigma terms are in ll's start
      if (mask_at() > T(0)) {
        int k = n_out > 1 ? (int)outeq_at() : 0;
        T pred = T(0);
        if (k >= 0 && k < n_out) {
          if (cf_kept) {
            auto out_k = [&](const T(&c)[NS], T b) {
              T y = c[0] * x[0];
#pragma unroll
              for (int j = 1; j < NS; ++j) y = y + c[j] * x[j];
              return y + b;
            };
            pred = k == 0 ? out_k(cf[0], bs[0]) : out_k(cf[1], bs[1]);
          } else {
            const T* ck = coef + (size_t)k * NS * S + s;
            pred = ck[0] * x[0];
#pragma unroll
            for (int j = 1; j < NS; ++j) pred = pred + ck[(size_t)j * S] * x[j];
            if (bias != nullptr) pred = pred + bias[(size_t)k * S + s];
          }
        }
        const T z = (value_at() - pred) * isig_at();
        const T sc = has_cens ? cens_at() : T(0);
        ll += (sc == T(0)) ? T(-0.5) * z * z : log_ndtr(sc * z);
      }
      // 2. the bolus (0 on padded slots) scaled by fa; with lag it waits
      const T bol = bolus_at();
      if constexpr (!FEAT) {
        x[0] = x[0] + bol;
      } else {
        T bol_eff = fa != nullptr ? bol * fa_rs : bol;
        bool lag_here = has_lag;
        T lag_m = lag_rs;
        if constexpr (K1C) {
          // slot tables pick each dose segment's plane (-1: no dose lands)
          if (fa != nullptr && fa_slots != nullptr) {
            const int sl = fa_slots[m];
            bol_eff = sl < 0 ? bol : bol * fa[(size_t)sl * RS + (size_t)r * S + s];
          }
          if (has_lag && lag_slots != nullptr) {
            const int sl = lag_slots[m];
            lag_here = sl >= 0;
            if (lag_here) lag_m = lag[(size_t)sl * RS + (size_t)r * S + s];
          }
        }
        if (has_lag) {
          if (lag_here && bol != T(0)) {
            pend_amt = bol_eff;
            pend_rem = lag_m;
          }
        } else {
          x[0] = x[0] + bol_eff;
        }
      }
      // 3. this segment's parameters, then propagate over its span
      const T dt = dt_at();
      if constexpr (K1C) {
        if (evcode != nullptr) {
          // lag_depth: the engine's reset/carry rule on the event codes
          const T code = evcode[i];
          const int span = dt > T(0) ? 1 : 0;
          if (code == T(1)) {
            dc = span;
            app = span != 0;
          } else if (code == T(2)) {
            dc += span;
            app = span != 0;
          } else {
            dc += (span != 0 && !app) ? 1 : 0;
            app = app || span != 0;
          }
        }
      }
      if (dt > T(0)) {
        if (f.mode == MODE_SEGMENT) {
          T eff[NP];
#pragma unroll
          for (int j = 0; j < NP; ++j) {
            const size_t k = ((size_t)r * NP + j) * M + m;
            eff[j] = params[(size_t)j * S + s] * mult_seg[k] +
                     (offset_seg != nullptr ? offset_seg[k] : T(0));
          }
          mdl.prepare(eff);
        } else if (f.mode >= MODE_LEVELS) {
          int d = (K1C && evcode != nullptr) ? dc : (int)depth[i];
          d = d < 1 ? 1 : (d > f.n_levels ? f.n_levels : d);
          if (d != cur) {
            if (lv != nullptr) {
              mdl.load(lv + (size_t)(d - 1) * NPREP * S, S);
            } else {
              T micro[NB];
              level_micro(micro, f.mode, levels, planes, d, r, R, S, s);
              mdl.prepare(micro, true);
            }
            cur = d;
          }
        }
        if constexpr (K1C) {
          if (split) {
            // the true split march (pallas_psi.py:725-758): the fire resets
            // the chain, so no superposition across it
            const T rate = has_inf ? rate_at() : T(0);
            const bool fire = pend_amt != T(0) && pend_rem < dt;
            if (!fire) {
              mdl.propagate(x, dt, rate, has_inf);
              pend_rem = pend_rem - dt > T(0) ? pend_rem - dt : T(0);
              continue;
            }
            if (pend_rem > T(0)) mdl.propagate(x, pend_rem, rate, has_inf);
            x[0] = x[0] + pend_amt;
            // the post-fire parameters, into the one model: depth 1
            // (lag_depth) or this column's post slot (lag_post), both in the
            // level (slot) space of the main model
            int dp = postdepth != nullptr ? (int)postdepth[i] : 1;
            dp = dp < 1 ? 1 : (dp > f.n_levels ? f.n_levels : dp);
            if (dp != cur) {
              if (lv != nullptr) {
                mdl.load(lv + (size_t)(dp - 1) * NPREP * S, S);
              } else {
                T micro[NB];
                level_micro(micro, f.mode, levels, planes, dp, r, R, S, s);
                mdl.prepare(micro, true);
              }
              cur = dp;
            }
            const T rest = dt - pend_rem;
            if (rest > T(0)) mdl.propagate(x, rest, rate, has_inf);
            if (evcode != nullptr) {
              dc = 1;
              app = true;
            }
            pend_amt = T(0);
            pend_rem = T(0);
            continue;
          }
        }
        mdl.propagate(x, dt, has_inf ? rate_at() : T(0), has_inf);
        if constexpr (FEAT) {
          if (has_lag) {
            if (pend_amt != T(0) && pend_rem < dt) {
              // the pending dose fires inside this segment
              T xd[NS];
#pragma unroll
              for (int j = 0; j < NS; ++j) xd[j] = T(0);
              xd[0] = pend_amt;
              mdl.propagate(xd, dt - pend_rem, T(0), false);
#pragma unroll
              for (int j = 0; j < NS; ++j) x[j] = x[j] + xd[j];
              pend_amt = T(0);
              pend_rem = T(0);
            } else {
              pend_rem = pend_rem - dt > T(0) ? pend_rem - dt : T(0);
            }
          }
        }
      }
    }
    out[(size_t)r * S + s] = ll;
  }
}

// Calls fn(std::integral_constant<int, code>) for the structure code.
template <int CODE = 0, typename Fn>
cudaError_t with_code(int code, Fn&& fn) {
  if constexpr (CODE < 12) {
    if (code == CODE) return fn(std::integral_constant<int, CODE>{});
    return with_code<CODE + 1>(code, fn);
  } else {
    return cudaErrorInvalidValue;
  }
}

// Resident blocks of 128 threads an SM of the tier's kernel.
template <typename T, int CODE, int TIER>
cudaError_t blocks_per_sm(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fused_psi_feature_kernel<T, CODE, TIER>, FEATURE_THREADS, 0);
}

template <typename T, int CODE, int TIER, typename F>
cudaError_t launch_tier(const FeatureStreams& a, const void* obs_sigma, const F& fk,
                        int blocks, cudaStream_t stream) {
  if (a.R <= 0 || a.S <= 0) return cudaSuccess;
  const int tiles = (a.S + FEATURE_THREADS - 1) / FEATURE_THREADS;
  if constexpr (per_segment<T, TIER>() == 8) {
    segment_records_kernel<<<(a.R + 127) / 128, 128, 0, stream>>>(
        (const float*)a.seg_dt, (const float*)a.seg_bolus, (const float*)a.seg_rate,
        (const float*)a.obs_mask, (const float*)a.obs_value, (const float*)obs_sigma,
        (const float*)a.obs_cens, (const float*)a.obs_outeq, (float4*)a.obs_isig,
        (float*)a.obs_const, a.R, a.M);
  } else {
    observation_terms_kernel<T><<<(a.R + 127) / 128, 128, 0, stream>>>(
        (const T*)a.obs_mask, (const T*)obs_sigma, (const T*)a.obs_cens, (T*)a.obs_isig,
        (T*)a.obs_const, a.R, a.M);
  }
  if constexpr (TIER != TIER_K1A) {
    const Features& f = base_of(fk);
    if (f.mode == MODE_LEVELS) {
      prepare_levels_kernel<T, CODE><<<dim3(tiles, f.n_levels), 128, 0, stream>>>(
          (const T*)f.p[4], (T*)a.table, a.S);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  int per_sm = 0;
  cudaError_t err = blocks_per_sm<T, CODE, TIER>(&per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (blocks <= 0) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    blocks = per_sm * sms;
  }
  // a block a tile of supports and a share of the rows
  int rows = blocks / tiles;
  rows = rows < 1 ? 1 : (rows > a.R ? a.R : rows);
  rows = rows > 65535 ? 65535 : rows;
  fused_psi_feature_kernel<T, CODE, TIER><<<dim3(tiles, rows), FEATURE_THREADS, 0, stream>>>(
      a, fk);
  return cudaGetLastError();
}

template <typename T, int TIER, typename F>
cudaError_t dispatch_tier(int code, const FeatureStreams& a, const void* obs_sigma,
                          const F& f, int blocks, cudaStream_t st) {
  return with_code(code, [&](auto c) {
    return launch_tier<T, decltype(c)::value, TIER>(a, obs_sigma, f, blocks, st);
  });
}

// per_segment of the tier (K1b's and K1c's are K1b's) and dtype
int per_segment_of(int is_f64, int tier) {
  if (tier == TIER_K1A)
    return is_f64 ? per_segment<double, TIER_K1A>() : per_segment<float, TIER_K1A>();
  return is_f64 ? per_segment<double, TIER_K1B>() : per_segment<float, TIER_K1B>();
}

// The streams of a launch: `terms` holds `per_seg` values per (row,
// segment), obs_isig [R, M] or K1a's float32 records, then obs_const [R];
// the launch fills them before the kernel reads them.
FeatureStreams streams_of(const void* seg_dt, const void* seg_bolus, const void* seg_rate,
                          const void* obs_mask, const void* obs_value, const void* obs_cens,
                          const void* obs_outeq, const void* params, const void* coef,
                          const void* bias, void* out, void* table, void* terms, int R, int S,
                          int M, int n_out, int is_f64, int per_seg) {
  const size_t RM = (size_t)R * M * per_seg * (is_f64 ? sizeof(double) : sizeof(float));
  return FeatureStreams{seg_dt,    seg_bolus, seg_rate,  obs_mask, obs_value, terms,
                        (const char*)terms + RM, obs_cens, obs_outeq, params, coef, bias,
                        out,       table,     R,         S,        M,         n_out};
}

}  // namespace

// K1a, launched on `stream`. Pointers: seg_dt, seg_bolus, seg_rate (or
// null), obs_mask, obs_value, obs_sigma, obs_cens (or null), obs_outeq (or
// null when n_out == 1): [R, M]; params [n_params, S]; coef [n_out,
// n_states, S]; bias [n_out, S] (or null); out [R, S]; `terms`,
// fused_psi_terms_size values that the launch fills first (float64: the
// observation terms obs_isig [R, M]; float32: the segment records [R, M, 8];
// then obs_const [R]); `blocks` of the persistent grid (0: as many as the
// card holds at once). All float (is_f64 == 0) or double. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int fused_psi_launch(int is_f64, int code, const void* seg_dt,
                                const void* seg_bolus, const void* seg_rate,
                                const void* obs_mask, const void* obs_value,
                                const void* obs_sigma, const void* obs_cens,
                                const void* obs_outeq, const void* params,
                                const void* coef, const void* bias, void* out, void* terms,
                                int R, int S, int M, int n_out, int blocks, void* stream) {
  if (terms == nullptr) return (int)cudaErrorInvalidValue;
  const FeatureStreams a = streams_of(seg_dt, seg_bolus, seg_rate, obs_mask, obs_value,
                                      obs_cens, obs_outeq, params, coef, bias, out, nullptr,
                                      terms, R, S, M, n_out, is_f64,
                                      per_segment_of(is_f64, TIER_K1A));
  const NoFeatures none;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      is_f64 ? dispatch_tier<double, TIER_K1A>(code, a, obs_sigma, none, blocks, st)
             : dispatch_tier<float, TIER_K1A>(code, a, obs_sigma, none, blocks, st);
  return (int)err;
}

// K1b and K1c: the same pointers as fused_psi_launch, with `table` (levels
// mode: the prepared level models [L, NPREP, S], which the launch fills;
// else null) before `terms`, then `features`, the 14 feature
// pointers of ops/fused_psi.py FEATURES (null = off) followed by the device
// int32 slot tables lag_slots and fa_slots [M] (null = none), and `ints` =
// {mode, number of levels or
// planes, row stride of the lag plane, of the fa plane (S, or 0 for one row
// per support)}; `blocks` as for K1a. Slot tables, an event code stream or a
// post slot stream select K1c, anything else K1b.
extern "C" int fused_psi_feature_launch(
    int is_f64, int code, const void* seg_dt, const void* seg_bolus,
    const void* seg_rate, const void* obs_mask, const void* obs_value,
    const void* obs_sigma, const void* obs_cens, const void* obs_outeq, const void* params,
    const void* coef, const void* bias, void* out, void* table, void* terms,
    const void* const* features, const int* ints, int R, int S, int M, int n_out, int blocks,
    void* stream) {
  if (terms == nullptr) return (int)cudaErrorInvalidValue;
  const FeatureStreams a = streams_of(seg_dt, seg_bolus, seg_rate, obs_mask, obs_value,
                                      obs_cens, obs_outeq, params, coef, bias, out, table,
                                      terms, R, S, M, n_out, is_f64,
                                      per_segment_of(is_f64, TIER_K1B));
  // features: mult, offset, mult_seg, offset_seg, levels, planes, depth,
  // evcode, postdepth, lag, fa, init_rows, init_planes, init_mask, lag_slots,
  // fa_slots (ops/fused_psi.py FEATURES, then the slot tables)
  K1cFeatures k;
  const int base[12] = {0, 1, 2, 3, 4, 5, 6, 9, 10, 11, 12, 13};
  for (int i = 0; i < 12; ++i) k.b.p[i] = features[base[i]];
  k.evcode = features[7];
  k.postdepth = features[8];
  k.lag_slots = (const int*)features[14];
  k.fa_slots = (const int*)features[15];
  k.b.mode = ints[0];
  k.b.n_levels = ints[1];
  k.b.lag_row = ints[2];
  k.b.fa_row = ints[3];
  if (k.b.mode < MODE_NONE || k.b.mode > MODE_PLANES) return (int)cudaErrorInvalidValue;
  if (k.b.lag_row != 0 && k.b.lag_row != S) return (int)cudaErrorInvalidValue;
  if (k.b.fa_row != 0 && k.b.fa_row != S) return (int)cudaErrorInvalidValue;
  if ((table != nullptr) != (k.b.mode == MODE_LEVELS)) return (int)cudaErrorInvalidValue;
  const bool k1c = k.evcode != nullptr || k.postdepth != nullptr ||
                   k.lag_slots != nullptr || k.fa_slots != nullptr;
  // event codes and post slots drive the level select; slot tables need
  // their planes, whole [n, R, S] stacks
  if ((k.evcode != nullptr || k.postdepth != nullptr) &&
      (k.b.mode < MODE_LEVELS || k.b.p[7] == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((k.lag_slots != nullptr && (k.b.p[7] == nullptr || k.b.lag_row == 0)) ||
      (k.fa_slots != nullptr && (k.b.p[8] == nullptr || k.b.fa_row == 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (k1c)
    err = is_f64 ? dispatch_tier<double, TIER_K1C>(code, a, obs_sigma, k, blocks, st)
                 : dispatch_tier<float, TIER_K1C>(code, a, obs_sigma, k, blocks, st);
  else
    err = is_f64 ? dispatch_tier<double, TIER_K1B>(code, a, obs_sigma, k.b, blocks, st)
                 : dispatch_tier<float, TIER_K1B>(code, a, obs_sigma, k.b, blocks, st);
  return (int)err;
}

// The values of a launch's `terms` scratch for the tier (0 K1a, 1 K1b,
// 2 K1c): R x (M x the values per segment + 1).
extern "C" long long fused_psi_terms_size(int is_f64, int tier, int R, int M) {
  return (long long)R * ((long long)M * per_segment_of(is_f64, tier) + 1);
}

// Resident blocks an SM of the tier's kernel (0 K1a, 1 K1b, 2 K1c) for the
// structure code.
extern "C" int fused_psi_occupancy(int is_f64, int code, int tier, int* blocks) {
  return (int)with_code(code, [&](auto c) -> cudaError_t {
    constexpr int C = decltype(c)::value;
    switch (tier) {
      case TIER_K1A:
        return is_f64 ? blocks_per_sm<double, C, TIER_K1A>(blocks)
                      : blocks_per_sm<float, C, TIER_K1A>(blocks);
      case TIER_K1B:
        return is_f64 ? blocks_per_sm<double, C, TIER_K1B>(blocks)
                      : blocks_per_sm<float, C, TIER_K1B>(blocks);
      case TIER_K1C:
        return is_f64 ? blocks_per_sm<double, C, TIER_K1C>(blocks)
                      : blocks_per_sm<float, C, TIER_K1C>(blocks);
      default:
        return cudaErrorInvalidValue;
    }
  });
}

// The prepared fields of one level model of the structure code (the level
// table's NPREP).
extern "C" int fused_psi_prep_fields(int code) {
  int n = -1;
  with_code(code, [&](auto c) {
    n = ModelOf<float, decltype(c)::value>::NPREP;
    return cudaSuccess;
  });
  return n;
}

extern "C" const char* fused_psi_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
