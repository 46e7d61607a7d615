// Per-chain arithmetic of one Euler–Maruyama Langevin micro-step for the 1-D
// chain ensemble, shared by the CUDA frame kernel (chain_kernel.cu) and its
// host build (chain_host.cpp), which the CPU tests drive through ctypes.
//
// Every function mirrors integrators/langevin.py expression by expression,
// in the same operand order, so the device kernel tracks the XLA path to
// rounding: Threefry-2x32 keyed as rng.py keys it, Box–Muller as
// rng.normal_pair, drift / ghosts / clamp / detector as make_frame_fn's
// substep.  Only the layout of sites over threads lives elsewhere.
#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define SQ_HD __host__ __device__ __forceinline__
#else
#define SQ_HD inline
#endif

namespace sq {

enum Bc : int32_t { kPeriodic = 0, kFixedBg = 1, kDirichlet = 2 };
enum ActionId : int32_t { kHarmonic = 0, kDoubleWell = 1, kAnharmonic = 2 };
enum StreamId : uint32_t { kFieldStream = 0, kCollectiveStream = 1 };

// Layout of the integer / float parameter vectors packed by
// kernels/chain_cuda.py:pack_params.
enum IParam : int {
  kNSites = 0, kLoops, kRounds, kAction, kBc, kBackground, kHasZm, kNumIParams
};
enum DParam : int {
  kInvDt2 = 0, kDt, kInvDt, kCAmp, kZmAmp, kUpper, kClamp, kAsymL, kAsymR,
  kTGhostL, kTGhostR, kP0, kP1, kP2, kP3, kP4, kP5, kP6, kNumDParams
};

struct ChainParams {
  int32_t n_sites, loops, rounds, action, bc, background, has_zm;
  float inv_dt2, dt, inv_dt, c_amp, zm_amp, upper, clamp;
  float asym_l, asym_r, t_ghost_l, t_ghost_r;
  // action constants, pre-rounded to float32 as XLA folds them:
  //   harmonic:    p0 = k
  //   double_well: p0 = eta, p1 = w, p2 = 12 V0, p3 = 4 V0, p4 = 1/eta^2,
  //                p5 = 1/eta^4, p6 = eta^2
  // A division by a constant is a multiplication by its float32 reciprocal,
  // as XLA's algebraic simplifier rewrites it ("A / Const => A * (1 / Const)").
  //   anharmonic:  p0 = mu^2, p1 = 4 lambda, p2 = 12 lambda
  float p[7];
};

inline ChainParams make_params(const int32_t* ip, const double* dp) {
  ChainParams P;
  P.n_sites = ip[kNSites];
  P.loops = ip[kLoops];
  P.rounds = ip[kRounds];
  P.action = ip[kAction];
  P.bc = ip[kBc];
  P.background = ip[kBackground];
  P.has_zm = ip[kHasZm];
  P.inv_dt2 = (float)dp[kInvDt2];
  P.dt = (float)dp[kDt];
  P.inv_dt = (float)dp[kInvDt];
  P.c_amp = (float)dp[kCAmp];
  P.zm_amp = (float)dp[kZmAmp];
  P.upper = (float)dp[kUpper];
  P.clamp = (float)dp[kClamp];
  P.asym_l = (float)dp[kAsymL];
  P.asym_r = (float)dp[kAsymR];
  P.t_ghost_l = (float)dp[kTGhostL];
  P.t_ghost_r = (float)dp[kTGhostR];
  for (int i = 0; i < 7; ++i) P.p[i] = (float)dp[kP0 + i];
  return P;
}

// --------------------------------------------------------- device math ---

// On the device, sqrt, division and tanh follow XLA's own GPU lowering of
// the same jnp operations, which differs from the CUDA math library's:
// sqrt.approx.f32, div.full.f32, and a clamped rational tanh evaluated
// with fused multiply-adds (measured equal bit for bit on an H100).  The
// library is compiled without FMA contraction (-fmad=false), as XLA emits
// its other multiplies and adds.  On the host they are the libm functions.

SQ_HD float sq_sqrtf(float x) {
#ifdef __CUDA_ARCH__
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
#else
  return sqrtf(x);
#endif
}

SQ_HD float sq_tanhf(float x) {
#ifdef __CUDA_ARCH__
  const float ax = fabsf(x);
  if (!(ax < 20.0f)) return copysignf(1.0f, x);
  if (ax < 0.0004f) return x;
  const float c = 7.99881172180175781f;
  const float xc = fminf(fmaxf(x, -c), c);
  const float x2 = xc * xc;
  float p = -2.76076847742355e-16f;
  p = fmaf(x2, p, 2.00018790482477e-13f);
  p = fmaf(x2, p, -8.60467152213735e-11f);
  p = fmaf(x2, p, 5.12229709037114e-08f);
  p = fmaf(x2, p, 1.48572235717979e-05f);
  p = fmaf(x2, p, 6.37261928875436e-04f);
  p = fmaf(x2, p, 4.89352455891786e-03f);
  p = xc * p;
  float q = 1.19825839466702e-06f;
  q = fmaf(x2, q, 1.18534705686654e-04f);
  q = fmaf(x2, q, 2.26843463243900e-03f);
  q = fmaf(x2, q, 4.89352518554385e-03f);
  float r;
  asm("div.full.f32 %0, %1, %2;" : "=f"(r) : "f"(p), "f"(q));
  return r;
#else
  return tanhf(x);
#endif
}

// ---------------------------------------------------------------- noise ---

SQ_HD uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32 with ROUNDS rounds (rng.threefry2x32).
template <int ROUNDS>
SQ_HD void threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                        uint32_t* o0, uint32_t* o1) {
  const uint32_t ks[3] = {k0, k1, 0x1BD11BDAu ^ k0 ^ k1};
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int i = 0; i < ROUNDS; ++i) {
    x0 += x1;
    x1 = rotl32(x1, rot[i % 8]);
    x1 ^= x0;
    if ((i + 1) % 4 == 0) {
      const int j = (i + 1) / 4;
      x0 += ks[j % 3];
      x1 += ks[(j + 1) % 3] + (uint32_t)j;
    }
  }
  *o0 = x0;
  *o1 = x1;
}

// uint32 -> float32 in (0, 1) from the top 24 bits (rng.uniform_from_bits).
SQ_HD float uniform_from_bits(uint32_t b) {
  return (float)(int32_t)(b >> 8) * 5.9604644775390625e-08f +
         2.98023223876953125e-08f;
}

// Both Box–Muller outputs of one Threefry draw (rng.normal_pair).
template <int ROUNDS>
SQ_HD void normal_pair(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                       float* z0, float* z1) {
  uint32_t b0, b1;
  threefry2x32<ROUNDS>(k0, k1, c0, c1, &b0, &b1);
  const float u1 = uniform_from_bits(b0);
  const float u2 = uniform_from_bits(b1);
  const float r = sq_sqrtf(-2.0f * logf(u1));
  const float theta = 6.283185307179586f * u2;
  *z0 = r * cosf(theta);
  *z1 = r * sinf(theta);
}

SQ_HD uint32_t stream_key(uint32_t stream, uint32_t chain) {
  return stream ^ (chain << 8);
}

// --------------------------------------------------------------- action ---

SQ_HD float x_cl(const ChainParams& P, float t, float om) {
  if (P.action == kDoubleWell) return P.p[0] * sq_tanhf(P.p[1] * (t - om));
  return 0.0f;
}

SQ_HD float ddV(const ChainParams& P, float x) {
  switch (P.action) {
    case kDoubleWell:
      return ((P.p[2] * x) * x * P.p[4] - P.p[3]) * P.p[4];
    case kAnharmonic:
      return P.p[0] + (P.p[2] * x) * x;
    default:
      return P.p[0];
  }
}

SQ_HD float dV(const ChainParams& P, float x) {
  switch (P.action) {
    case kDoubleWell:
      return (P.p[3] * x) * (x * x - P.p[6]) * P.p[5];
    case kAnharmonic:
      return P.p[0] * x + ((P.p[1] * x) * x) * x;
    default:
      return P.p[0] * x;
  }
}

// ------------------------------------------------------------ micro-step ---

// Ghost-site field values (make_frame_fn's ``ghosts``).
SQ_HD void ghosts(const ChainParams& P, float om, float* gl, float* gr) {
  if (P.bc != kFixedBg) {
    *gl = 0.0f;
    *gr = 0.0f;
  } else if (P.background) {
    *gl = P.asym_l - x_cl(P, P.t_ghost_l, om);
    *gr = P.asym_r - x_cl(P, P.t_ghost_r, om);
  } else {
    *gl = P.asym_l;
    *gr = P.asym_r;
  }
}

// Deterministic change Δτ·drift of one site.  ``curv`` is V''(x_cl) in the
// BACKGROUND formulation and unused in DIRECT.
SQ_HD float site_det(const ChainParams& P, float f, float up, float down,
                     float curv, float dtau) {
  const float lap = ((up + down) - 2.0f * f) * P.inv_dt2;
  const float drift = P.background ? lap - curv * f : lap - dV(P, f);
  return drift * dtau;
}

// Clamp and definitize the raw update (tau_kernel.cl:119-133 semantics).
SQ_HD float clamp_field(const ChainParams& P, float raw) {
  const float v = fminf(fmaxf(raw, -P.clamp), P.clamp);
  return isfinite(raw) ? v : P.clamp;
}

// Collective coordinate reflected into [0, upper].
SQ_HD float reflect(float om, float upper) {
  om = om > upper ? 2.0f * upper - om : om;
  return om < 0.0f ? -om : om;
}

// Per-chain noise amplitudes of a frame: the field's c·√(2Δτ/Δt) and the
// zero mode's C_zm·c·√(2Δτ).
SQ_HD float field_noise_amp(const ChainParams& P, float dtau) {
  return P.c_amp * sq_sqrtf(2.0f * dtau * P.inv_dt);
}

SQ_HD float zero_mode_amp(const ChainParams& P, float dtau) {
  return P.zm_amp * sq_sqrtf(2.0f * dtau);
}

// Site time t_i on the lattice (make_frame_fn's t_grid).
SQ_HD float site_time(const ChainParams& P, int i) {
  return (float)i * P.dt;
}

}  // namespace sq
