// Host build of the chain-frame arithmetic (chain_math.h): one frame per
// chain, sites in a plain serial loop.  The CPU tests drive it through
// ctypes (kernels/chain_cuda.py:host_frame) against
// integrators/langevin.run_frames; the CUDA kernel runs the same functions
// with the sites of a chain spread over one warp.
#include <vector>

#include "chain_math.h"

namespace {

template <int R>
void frame_one_chain(const sq::ChainParams& P, uint32_t seed, uint32_t step0,
                     uint32_t chain, float* f, float* om_io, float* lrg_io,
                     float dtau, float* xs, float* xxs, float* x2s,
                     float* x4s, int32_t* unst_out) {
  const int N = P.n_sites;
  std::vector<float> nf(N), x(N), e0(N), e1(N);
  float om = *om_io;
  float lrg = *lrg_io;
  bool unst = false;
  const float namp = sq::field_noise_amp(P, dtau);
  const float oamp = sq::zero_mode_amp(P, dtau);
  const uint32_t kf = sq::stream_key(sq::kFieldStream, chain);
  const uint32_t ko = sq::stream_key(sq::kCollectiveStream, chain);

  auto substep = [&](const float* eta, float eta_om) {
    if (unst) return;  // a frozen chain keeps its state for the frame
    float gl, gr;
    sq::ghosts(P, om, &gl, &gr);
    float max_det = 0.0f, max_x = 0.0f;
    bool bad = false;
    for (int i = 0; i < N; ++i) {
      const float bg =
          P.background ? sq::x_cl(P, sq::site_time(P, i), om) : 0.0f;
      const float curv = P.background ? sq::ddV(P, bg) : 0.0f;
      const bool periodic = P.bc == sq::kPeriodic;
      const float up = i + 1 < N ? f[i + 1] : (periodic ? f[0] : gr);
      const float down = i > 0 ? f[i - 1] : (periodic ? f[N - 1] : gl);
      const float det = sq::site_det(P, f[i], up, down, curv, dtau);
      const float raw = (f[i] + det) + namp * eta[i];
      float v = sq::clamp_field(P, raw);
      if (P.bc == sq::kDirichlet && (i == 0 || i == N - 1)) v = 0.0f;
      max_det = fmaxf(max_det, fabsf(det));
      bad |= !isfinite(raw);
      x[i] = P.background ? f[i] + bg : f[i];
      max_x = fmaxf(max_x, fabsf(P.background ? v + bg : v));
      nf[i] = v;
    }
    const float xmid = x[N / 2];
    const bool tripped = max_det > lrg || bad;
    for (int i = 0; i < N; ++i) {
      const float x2 = x[i] * x[i];
      xs[i] += x[i];
      xxs[i] += x[i] * xmid;
      x2s[i] += x2;
      x4s[i] += x2 * x2;
      f[i] = nf[i];
    }
    lrg = fmaxf(lrg, max_x);
    if (P.has_zm) om = sq::reflect(om + oamp * eta_om, P.upper);
    unst = tripped;
  };

  auto draw = [&](uint32_t step, float* zo0, float* zo1) {
    for (int i = 0; i < N; ++i)
      sq::normal_pair<R>(seed, kf, (uint32_t)i, step, &e0[i], &e1[i]);
    *zo0 = *zo1 = 0.0f;
    if (P.has_zm) sq::normal_pair<R>(seed, ko, 0u, step, zo0, zo1);
  };

  for (int k = 0; k < P.loops / 2; ++k) {
    float zo0, zo1;
    draw(step0 + 2u * (uint32_t)k, &zo0, &zo1);
    substep(e0.data(), zo0);
    substep(e1.data(), zo1);
  }
  if (P.loops % 2) {
    float zo0, zo1;
    draw(step0 + (uint32_t)(P.loops - 1), &zo0, &zo1);
    substep(e0.data(), zo0);
  }
  *om_io = om;
  *lrg_io = lrg;
  *unst_out = unst ? 1 : 0;
}

}  // namespace

extern "C" int sq_chain_frame_host(
    const int32_t* ip, const double* dp, uint32_t seed, uint32_t step0,
    uint32_t chain0, int32_t n_chains, const float* f_in, const float* om_in,
    const float* lrg_in, const float* dtau_in, float* f_out, float* om_out,
    float* xs, float* xxs, float* x2s, float* x4s, float* lrg_out,
    int32_t* unst_out) {
  const sq::ChainParams P = sq::make_params(ip, dp);
  if (P.rounds != 20 && P.rounds != 13) return 1;
  const int N = P.n_sites;
  for (int c = 0; c < n_chains; ++c) {
    const size_t off = (size_t)c * N;
    for (int i = 0; i < N; ++i) {
      f_out[off + i] = f_in[off + i];
      xs[off + i] = xxs[off + i] = x2s[off + i] = x4s[off + i] = 0.0f;
    }
    om_out[c] = om_in[c];
    lrg_out[c] = lrg_in[c];
    auto run = P.rounds == 20 ? frame_one_chain<20> : frame_one_chain<13>;
    run(P, seed, step0, chain0 + (uint32_t)c, f_out + off, om_out + c,
        lrg_out + c, dtau_in[c], xs + off, xxs + off, x2s + off, x4s + off,
        unst_out + c);
  }
  return 0;
}

extern "C" int sq_threefry_host(int32_t rounds, int64_t n, const uint32_t* k0,
                                const uint32_t* k1, const uint32_t* c0,
                                const uint32_t* c1, uint32_t* o0,
                                uint32_t* o1) {
  if (rounds != 20 && rounds != 13) return 1;
  for (int64_t i = 0; i < n; ++i) {
    if (rounds == 20)
      sq::threefry2x32<20>(k0[i], k1[i], c0[i], c1[i], &o0[i], &o1[i]);
    else
      sq::threefry2x32<13>(k0[i], k1[i], c0[i], c1[i], &o0[i], &o1[i]);
  }
  return 0;
}
