// CUDA frame kernel for the batched 1-D Langevin chain ensemble (sm_90a),
// called from JAX through the XLA FFI (kernels/chain_cuda.py).
//
// One launch runs a whole frame of ``loops`` Euler–Maruyama micro-steps.
// One warp owns one chain for the frame: lane l keeps the S = ceil(N/32)
// consecutive sites l*S .. l*S+S-1 in registers (N = 200 -> 7 per lane,
// padded to 224).  A micro-step reads its two cross-lane neighbours with
// __shfl_down_sync / __shfl_up_sync, broadcasts x_mid with __shfl_sync and
// reduces max|det|, max|x| and the finiteness flag across the warp.  The
// field and the four frame sums never leave registers until the frame ends,
// so device memory sees the chain state once per frame instead of once per
// micro-step.  Noise is Threefry-2x32 in registers, keyed by (seed, stream,
// global chain, global site, step) exactly as rng.py keys it.  The arithmetic
// is chain_math.h, shared with the host build that the CPU tests check.
//
// Accept/reject with rollback, the adaptive-Δτ controller and the merge into
// the running means stay in XLA after the call (integrators/langevin.py).
#include <cuda_runtime.h>

#include "chain_math.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxSitesPerLane = 16;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// a[j] for a runtime j without spilling the register array to local memory.
template <int S>
__device__ __forceinline__ float pick(const float (&a)[S], int j) {
  float v = 0.0f;
#pragma unroll
  for (int q = 0; q < S; ++q) v = q == j ? a[q] : v;
  return v;
}

template <int S, int R>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    chain_frame_kernel(const sq::ChainParams P,
                       const uint32_t* __restrict__ scalars, int n_chains,
                       const float* __restrict__ f_in,
                       const float* __restrict__ om_in,
                       const float* __restrict__ lrg_in,
                       const float* __restrict__ dtau_in,
                       float* __restrict__ f_out, float* __restrict__ om_out,
                       float* __restrict__ xs_out, float* __restrict__ xxs_out,
                       float* __restrict__ x2s_out,
                       float* __restrict__ x4s_out,
                       float* __restrict__ lrg_out,
                       int32_t* __restrict__ unst_out) {
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (c >= n_chains) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int N = P.n_sites;
  const int base = lane * S;
  const size_t off = (size_t)c * N;
  const uint32_t seed = scalars[0];
  const uint32_t step0 = scalars[1];
  const uint32_t chain = scalars[2] + (uint32_t)c;

  float f[S], t[S], xs[S], xxs[S], x2s[S], x4s[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int i = base + j;
    f[j] = i < N ? f_in[off + i] : 0.0f;
    t[j] = sq::site_time(P, i);
    xs[j] = xxs[j] = x2s[j] = x4s[j] = 0.0f;
  }
  float om = om_in[c];
  float lrg = lrg_in[c];
  const float dtau = dtau_in[c];
  const float namp = sq::field_noise_amp(P, dtau);
  const float oamp = sq::zero_mode_amp(P, dtau);
  const uint32_t kf = sq::stream_key(sq::kFieldStream, chain);
  const uint32_t ko = sq::stream_key(sq::kCollectiveStream, chain);
  const int mid_lane = (N / 2) / S, mid_j = (N / 2) % S;
  const int last_lane = (N - 1) / S, last_j = (N - 1) % S;
  const bool periodic = P.bc == sq::kPeriodic;
  const bool dirichlet = P.bc == sq::kDirichlet;
  bool unst = false;

  auto substep = [&](const float(&eta)[S], float eta_om) {
    float gl, gr;
    sq::ghosts(P, om, &gl, &gr);
    const float from_right = __shfl_down_sync(kFull, f[0], 1);
    const float from_left = __shfl_up_sync(kFull, f[S - 1], 1);
    float f_first = 0.0f, f_last = 0.0f;
    if (periodic) {
      f_first = __shfl_sync(kFull, f[0], 0);
      f_last = __shfl_sync(kFull, pick(f, last_j), last_lane);
    }
    float nf[S], x[S];
    float max_det = 0.0f, max_x = 0.0f;
    bool bad = false;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int i = base + j;
      const float bg = P.background ? sq::x_cl(P, t[j], om) : 0.0f;
      const float curv = P.background ? sq::ddV(P, bg) : 0.0f;
      float up = j + 1 < S ? f[j + 1] : from_right;
      float down = j > 0 ? f[j - 1] : from_left;
      if (i == N - 1) up = periodic ? f_first : gr;
      if (i == 0) down = periodic ? f_last : gl;
      const float det = sq::site_det(P, f[j], up, down, curv, dtau);
      const float raw = (f[j] + det) + namp * eta[j];
      float v = sq::clamp_field(P, raw);
      if (dirichlet && (i == 0 || i == N - 1)) v = 0.0f;
      x[j] = P.background ? f[j] + bg : f[j];
      if (i < N) {
        max_det = fmaxf(max_det, fabsf(det));
        bad |= !isfinite(raw);
        max_x = fmaxf(max_x, fabsf(P.background ? v + bg : v));
      } else {
        v = 0.0f;
      }
      nf[j] = v;
    }
    const float xmid = __shfl_sync(kFull, pick(x, mid_j), mid_lane);
    max_det = warp_max(max_det);
    max_x = warp_max(max_x);
    bad = __any_sync(kFull, bad);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (base + j < N) {
        const float x2 = x[j] * x[j];
        xs[j] += x[j];
        xxs[j] += x[j] * xmid;
        x2s[j] += x2;
        x4s[j] += x2 * x2;
      }
      f[j] = nf[j];
    }
    const bool tripped = max_det > lrg || bad;
    lrg = fmaxf(lrg, max_x);
    if (P.has_zm) om = sq::reflect(om + oamp * eta_om, P.upper);
    unst = tripped;
  };

  float e0[S], e1[S];
  auto draw = [&](uint32_t step, float* zo0, float* zo1) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      e0[j] = e1[j] = 0.0f;
      if (base + j < N)
        sq::normal_pair<R>(seed, kf, (uint32_t)(base + j), step, &e0[j],
                           &e1[j]);
    }
    *zo0 = *zo1 = 0.0f;
    if (P.has_zm) sq::normal_pair<R>(seed, ko, 0u, step, zo0, zo1);
  };

  // A chain whose frame diverged is frozen for the rest of the frame (the
  // XLA path keeps its old state step by step), so its loop can stop.
  for (int k = 0; k < P.loops / 2 && !unst; ++k) {
    float zo0, zo1;
    draw(step0 + 2u * (uint32_t)k, &zo0, &zo1);
    substep(e0, zo0);
    if (!unst) substep(e1, zo1);
  }
  if ((P.loops & 1) && !unst) {
    float zo0, zo1;
    draw(step0 + (uint32_t)(P.loops - 1), &zo0, &zo1);
    substep(e0, zo0);
  }

#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int i = base + j;
    if (i < N) {
      f_out[off + i] = f[j];
      xs_out[off + i] = xs[j];
      xxs_out[off + i] = xxs[j];
      x2s_out[off + i] = x2s[j];
      x4s_out[off + i] = x4s[j];
    }
  }
  if (lane == 0) {
    om_out[c] = om;
    lrg_out[c] = lrg;
    unst_out[c] = unst ? 1 : 0;
  }
}

template <int R>
__global__ void normal_pair_kernel(int64_t n, const uint32_t* __restrict__ k0,
                                   const uint32_t* __restrict__ k1,
                                   const uint32_t* __restrict__ c0,
                                   const uint32_t* __restrict__ c1,
                                   uint32_t* __restrict__ b0,
                                   uint32_t* __restrict__ b1,
                                   float* __restrict__ z0,
                                   float* __restrict__ z1) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  sq::threefry2x32<R>(k0[i], k1[i], c0[i], c1[i], &b0[i], &b1[i]);
  sq::normal_pair<R>(k0[i], k1[i], c0[i], c1[i], &z0[i], &z1[i]);
}

#define SQ_FRAME_ARGS                                                       \
  P, scalars, n_chains, f_in, om_in, lrg_in, dtau_in, f_out, om_out, xs,    \
      xxs, x2s, x4s, lrg_out, unst

template <int R>
void launch_frame(int S, dim3 grid, dim3 block, cudaStream_t stream,
                  const sq::ChainParams& P, const uint32_t* scalars,
                  int n_chains, const float* f_in, const float* om_in,
                  const float* lrg_in, const float* dtau_in, float* f_out,
                  float* om_out, float* xs, float* xxs, float* x2s,
                  float* x4s, float* lrg_out, int32_t* unst) {
  switch (S) {
#define SQ_CASE(s)                                                          \
  case s:                                                                   \
    chain_frame_kernel<s, R><<<grid, block, 0, stream>>>(SQ_FRAME_ARGS);    \
    break;
    SQ_CASE(1) SQ_CASE(2) SQ_CASE(3) SQ_CASE(4) SQ_CASE(5) SQ_CASE(6)
    SQ_CASE(7) SQ_CASE(8) SQ_CASE(9) SQ_CASE(10) SQ_CASE(11) SQ_CASE(12)
    SQ_CASE(13) SQ_CASE(14) SQ_CASE(15) SQ_CASE(16)
#undef SQ_CASE
  }
}

ffi::Error ChainFrameImpl(
    cudaStream_t stream, ffi::Buffer<ffi::U32> scalars_b,
    ffi::Buffer<ffi::F32> f_b, ffi::Buffer<ffi::F32> om_b,
    ffi::Buffer<ffi::F32> lrg_b, ffi::Buffer<ffi::F32> dtau_b,
    ffi::ResultBuffer<ffi::F32> f_r, ffi::ResultBuffer<ffi::F32> om_r,
    ffi::ResultBuffer<ffi::F32> xs_r, ffi::ResultBuffer<ffi::F32> xxs_r,
    ffi::ResultBuffer<ffi::F32> x2s_r, ffi::ResultBuffer<ffi::F32> x4s_r,
    ffi::ResultBuffer<ffi::F32> lrg_r, ffi::ResultBuffer<ffi::S32> unst_r,
    ffi::Span<const int32_t> iparams, ffi::Span<const double> dparams) {
  if (iparams.size() != sq::kNumIParams || dparams.size() != sq::kNumDParams)
    return ffi::Error::InvalidArgument("sq_chain_frame: bad parameter vectors");
  const sq::ChainParams P = sq::make_params(iparams.begin(), dparams.begin());
  const auto dims = f_b.dimensions();
  if (dims.size() != 2 || dims[1] != P.n_sites)
    return ffi::Error::InvalidArgument("sq_chain_frame: f must be (C, n_sites)");
  if (scalars_b.element_count() != 3)
    return ffi::Error::InvalidArgument("sq_chain_frame: scalars must be (3,)");
  const int n_chains = (int)dims[0];
  const int S = (P.n_sites + 31) / 32;
  if (S < 1 || S > kMaxSitesPerLane)
    return ffi::Error::InvalidArgument("sq_chain_frame: n_sites out of range");
  if (P.rounds != 20 && P.rounds != 13)
    return ffi::Error::InvalidArgument("sq_chain_frame: rounds must be 20 or 13");
  if (n_chains == 0) return ffi::Error::Success();
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n_chains + kWarpsPerBlock - 1) / kWarpsPerBlock);
  auto launch = P.rounds == 20 ? launch_frame<20> : launch_frame<13>;
  launch(S, grid, block, stream, P, scalars_b.typed_data(), n_chains,
         f_b.typed_data(), om_b.typed_data(), lrg_b.typed_data(),
         dtau_b.typed_data(), f_r->typed_data(), om_r->typed_data(),
         xs_r->typed_data(), xxs_r->typed_data(), x2s_r->typed_data(),
         x4s_r->typed_data(), lrg_r->typed_data(), unst_r->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error NormalPairImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> k0,
                          ffi::Buffer<ffi::U32> k1, ffi::Buffer<ffi::U32> c0,
                          ffi::Buffer<ffi::U32> c1,
                          ffi::ResultBuffer<ffi::U32> b0,
                          ffi::ResultBuffer<ffi::U32> b1,
                          ffi::ResultBuffer<ffi::F32> z0,
                          ffi::ResultBuffer<ffi::F32> z1, int32_t rounds) {
  const int64_t n = (int64_t)k0.element_count();
  if (k1.element_count() != (size_t)n || c0.element_count() != (size_t)n ||
      c1.element_count() != (size_t)n)
    return ffi::Error::InvalidArgument("sq_normal_pair: operand sizes differ");
  if (rounds != 20 && rounds != 13)
    return ffi::Error::InvalidArgument("sq_normal_pair: rounds must be 20 or 13");
  if (n == 0) return ffi::Error::Success();
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  auto kernel = rounds == 20 ? normal_pair_kernel<20> : normal_pair_kernel<13>;
  kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      n, k0.typed_data(), k1.typed_data(), c0.typed_data(), c1.typed_data(),
      b0->typed_data(), b1->typed_data(), z0->typed_data(), z1->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    SqChainFrame, ChainFrameImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::U32>>()  // seed, step, chain offset
        .Arg<ffi::Buffer<ffi::F32>>()  // f (C, N)
        .Arg<ffi::Buffer<ffi::F32>>()  // omega (C,)
        .Arg<ffi::Buffer<ffi::F32>>()  // lrg_vl (C,)
        .Arg<ffi::Buffer<ffi::F32>>()  // dtau (C,)
        .Ret<ffi::Buffer<ffi::F32>>()  // f (C, N)
        .Ret<ffi::Buffer<ffi::F32>>()  // omega (C,)
        .Ret<ffi::Buffer<ffi::F32>>()  // frame sum x (C, N)
        .Ret<ffi::Buffer<ffi::F32>>()  // frame sum x * x_mid (C, N)
        .Ret<ffi::Buffer<ffi::F32>>()  // frame sum x^2 (C, N)
        .Ret<ffi::Buffer<ffi::F32>>()  // frame sum x^4 (C, N)
        .Ret<ffi::Buffer<ffi::F32>>()  // lrg_vl (C,)
        .Ret<ffi::Buffer<ffi::S32>>()  // unstable (C,)
        .Attr<ffi::Span<const int32_t>>("iparams")
        .Attr<ffi::Span<const double>>("dparams"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    SqNormalPair, NormalPairImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Ret<ffi::Buffer<ffi::U32>>()
        .Ret<ffi::Buffer<ffi::U32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Attr<int32_t>("rounds"));
