"""Scheme.EXACT — the exact Ornstein–Uhlenbeck propagator for linearized
(BACKGROUND, frozen-ω) chains: zero integration bias at ANY Δτ, gated
against the Δτ→0 target covariance (where EM/Heun would be unstable or
biased), plus Δτ-independence and validation surfaces."""

import numpy as np
import pytest

from stochquant import actions
from stochquant.config import (
    BoundaryCondition,
    ChainConfig,
    Formulation,
    Scheme,
)
from stochquant.integrators import langevin
from stochquant.observables import exact


def _z(sim, theory, n_chains):
    est = sim.mean(0)
    se = sim.std(0) / np.sqrt(n_chains)
    return np.abs(est - theory) / (se + 1e-12)


def _run(cfg, act, burn, frames):
    s = langevin.init_chain_state(cfg, act)
    s, _ = langevin.run_frames(s, act, cfg, burn)
    s = langevin.reset_means(s)
    s, m = langevin.run_frames(s, act, cfg, frames)
    assert np.all(np.asarray(m["stable"]))
    # EXACT never adapts Δτ
    np.testing.assert_array_equal(
        np.asarray(s.dtau), np.full(cfg.n_chains, np.float32(cfg.dtau))
    )
    return s


def test_exact_scheme_hits_target_cov_at_huge_dtau():
    """Δτ·b_max ≈ 400 — EM/Heun/LM all explode (stability needs Δτ·b < 2);
    the exact propagator samples the continuum-τ Gaussian regardless.  Gate
    ⟨x²⟩ against diag(B⁻¹)/Δt and ⟨x⁴⟩ against 3σ⁴ per site."""
    cfg = ChainConfig(
        action="harmonic", n_sites=32, dt=0.1, dtau=2.0, n_chains=128,
        loops=20, seed=41, scheme=Scheme.EXACT,
        formulation=Formulation.BACKGROUND, bc=BoundaryCondition.PERIODIC,
    )
    act = actions.get("harmonic")
    B = exact.harmonic_drift_matrix(cfg.n_sites, cfg.dt, bc=cfg.bc)
    assert cfg.dtau * np.linalg.eigvalsh(B).max() > 100.0  # EM-impossible
    s = _run(cfg, act, burn=3, frames=40)
    sig2 = np.diag(exact.target_cov(B, cfg.dt))
    z2 = _z(np.asarray(s.x2_mean, np.float64), sig2, cfg.n_chains)
    z4 = _z(np.asarray(s.x4_mean, np.float64), 3.0 * sig2**2, cfg.n_chains)
    assert z2.max() < 6.0, z2.max()
    assert z4.max() < 6.0, z4.max()


def test_exact_scheme_is_dtau_independent():
    """The transition law is exact at every Δτ: two runs that differ only in
    Δτ (400× apart) must agree on the stationary ⟨x²⟩ within error bars."""
    base = dict(
        action="harmonic", n_sites=24, dt=0.2, n_chains=96, loops=20,
        seed=17, scheme=Scheme.EXACT, formulation=Formulation.BACKGROUND,
        bc=BoundaryCondition.PERIODIC,
    )
    act = actions.get("harmonic")
    res = {}
    for dtau in (0.01, 4.0):
        cfg = ChainConfig(**base, dtau=dtau)
        s = _run(cfg, act, burn=10, frames=40)
        res[dtau] = np.asarray(s.x2_mean, np.float64)
    B = exact.harmonic_drift_matrix(base["n_sites"], base["dt"], bc=BoundaryCondition.PERIODIC)
    sig2 = np.diag(exact.target_cov(B, base["dt"]))
    for dtau, x2 in res.items():
        z = _z(x2, sig2, base["n_chains"])
        assert z.max() < 6.0, (dtau, z.max())


def test_exact_scheme_double_well_frozen_omega_mean_and_cov():
    """Full BACKGROUND machinery at a Δτ far beyond EM stability: kink
    background, FIXED_BG ghost sources, per-chain frozen ω — mean must hit
    μ + x_cl and the covariance the unbiased B⁻¹/Δt (not the EM-biased
    one)."""
    import jax.numpy as jnp

    cfg = ChainConfig(
        action="double_well", n_sites=24, dt=0.05, dtau=1.0, n_chains=128,
        loops=20, seed=7, scheme=Scheme.EXACT,
        formulation=Formulation.BACKGROUND, bc=BoundaryCondition.FIXED_BG,
        parisi=False,
    )
    act = actions.get("double_well")
    om0 = 0.5 * (cfg.n_sites - 1) * cfg.dt

    t = np.arange(cfg.n_sites) * cfg.dt
    x_cl = np.asarray(act.x_cl(t, om0), np.float64)
    ddv = np.asarray(act.ddV(x_cl), np.float64)
    inv = act.mass / cfg.dt**2
    B = np.diag(2.0 * inv + ddv)
    i_ = np.arange(cfg.n_sites - 1)
    B[i_, i_ + 1] = -inv
    B[i_ + 1, i_] = -inv
    assert cfg.dtau * np.linalg.eigvalsh(B).max() > 100.0  # EM-impossible
    gl = act.boundary_asymptote(-1) - float(np.asarray(act.x_cl(-cfg.dt, om0)))
    gr = act.boundary_asymptote(+1) - float(
        np.asarray(act.x_cl(cfg.n_sites * cfg.dt, om0))
    )
    src = np.zeros(cfg.n_sites)
    src[0] = inv * gl
    src[-1] = inv * gr
    mu = np.linalg.solve(B, src)
    sig2 = np.diag(exact.target_cov(B, cfg.dt))

    s = langevin.init_chain_state(cfg, act)
    s = s._replace(omega=jnp.full((cfg.n_chains,), om0, jnp.float32))
    s, _ = langevin.run_frames(s, act, cfg, 3)
    s = langevin.reset_means(s)
    s, m = langevin.run_frames(s, act, cfg, 40)
    assert np.all(np.asarray(m["stable"]))
    mx = mu + x_cl
    x2t = sig2 + mx**2
    zx = _z(np.asarray(s.x_mean, np.float64), mx, cfg.n_chains)
    z2 = _z(np.asarray(s.x2_mean, np.float64), x2t, cfg.n_chains)
    assert zx.max() < 6.0, zx.max()
    assert z2.max() < 6.0, z2.max()


def test_exact_scheme_validation_surfaces():
    act = actions.get("double_well")
    bad_direct = ChainConfig(
        action="anharmonic", scheme=Scheme.EXACT,
        formulation=Formulation.DIRECT, bc=BoundaryCondition.PERIODIC,
    )
    with pytest.raises(ValueError, match="BACKGROUND"):
        langevin.make_frame_fn(actions.get("anharmonic"), bad_direct)
    bad_parisi = ChainConfig(
        action="double_well", scheme=Scheme.EXACT,
        formulation=Formulation.BACKGROUND, parisi=True,
    )
    with pytest.raises(ValueError, match="parisi"):
        langevin.make_frame_fn(act, bad_parisi)
    # the CUDA kernel refuses loudly
    from stochquant.kernels import chain_cuda

    good = ChainConfig(
        action="harmonic", n_sites=16, n_chains=2, loops=2,
        scheme=Scheme.EXACT, formulation=Formulation.BACKGROUND,
        bc=BoundaryCondition.PERIODIC,
    )
    s0 = langevin.init_chain_state(good, actions.get("harmonic"))
    with pytest.raises(ValueError, match="XLA path"):
        chain_cuda.chain_frame(s0, actions.get("harmonic"), good, host=True)


def test_exact_scheme_dirichlet_hits_target_cov():
    """r4 (ROADMAP item): Scheme.EXACT with DIRICHLET edges — the interior
    (N−2)-site propagator embedded with zero edge rows/cols.  Gate the
    interior ⟨x²⟩ against diag(B_int⁻¹)/Δt at an EM-impossible Δτ and
    assert the edges stay pinned at exactly 0."""
    cfg = ChainConfig(
        action="harmonic", n_sites=32, dt=0.1, dtau=2.0, n_chains=128,
        loops=20, seed=43, scheme=Scheme.EXACT,
        formulation=Formulation.BACKGROUND, bc=BoundaryCondition.DIRICHLET,
    )
    act = actions.get("harmonic")
    B = exact.harmonic_drift_matrix(cfg.n_sites, cfg.dt, bc=cfg.bc)
    assert cfg.dtau * np.linalg.eigvalsh(B).max() > 100.0  # EM-impossible
    s = _run(cfg, act, burn=3, frames=40)
    f = np.asarray(s.f)
    np.testing.assert_array_equal(f[:, 0], np.zeros(cfg.n_chains))
    np.testing.assert_array_equal(f[:, -1], np.zeros(cfg.n_chains))
    sig2 = np.diag(exact.target_cov(B, cfg.dt))
    x2 = np.asarray(s.x2_mean, np.float64)[:, 1:-1]
    z2 = _z(x2, sig2, cfg.n_chains)
    assert z2.max() < 6.0, z2.max()


def test_exact_scheme_free_field_2d_hits_target_phi2():
    """r4 (ROADMAP item): Scheme.EXACT for the 2-D FREE field — the exact
    OU propagator per Fourier mode.  At Δτ·B̂_max ≫ 1 (EM-impossible) the
    site-averaged ⟨φ²⟩ must hit (c²/aᴰ)·mean_k 1/B̂(k)."""
    from stochquant.actions import phi4
    from stochquant.config import FieldConfig
    from stochquant.integrators import field

    cfg = FieldConfig(
        action="free_field", shape=(16, 16), dtau=2.0, n_chains=64,
        loops=20, seed=11, scheme=Scheme.EXACT,
    )
    act = phi4.get_field("free_field")
    # B̂_max = 8/a² + m² = 9 → Δτ·B̂_max = 18 (EM stability needs < 2)
    s = field.init_field_state(cfg)
    s, _ = field.run_field_frames(s, act, cfg, 3)
    s = field.reset_field_means(s)
    s, m = field.run_field_frames(s, act, cfg, 30)
    assert np.all(np.asarray(m["stable"]))
    np.testing.assert_array_equal(
        np.asarray(s.dtau), np.full(cfg.n_chains, np.float32(cfg.dtau))
    )
    kx = 2.0 * np.pi * np.fft.fftfreq(16)
    bhat = (
        2.0 * (1.0 - np.cos(kx))[:, None]
        + 2.0 * (1.0 - np.cos(kx))[None, :]
        + 1.0
    )
    target = np.mean(1.0 / bhat)
    phi2 = np.asarray(s.phi2_mean, np.float64)
    z = _z(phi2, target, cfg.n_chains)
    assert z.max() < 6.0, (phi2.mean(), target, z.max())


def test_exact_scheme_free_field_validation():
    from stochquant.actions import phi4
    from stochquant.config import FieldConfig, Sweep
    from stochquant.integrators import field

    # r5: phi4 IS supported now (exponential integrator); only actions
    # without a declared Gaussian curvature are rejected
    class NoM2(phi4.FieldAction):
        def V(self, p):
            return p * p

    cfg_nom2 = FieldConfig(action="phi4", scheme=Scheme.EXACT)
    with pytest.raises(ValueError, match="m2"):
        field.make_field_frame_fn(NoM2(), cfg_nom2)
    # phi4 builds fine under EXACT since r5
    field.make_field_frame_fn(phi4.get_field("phi4"), cfg_nom2)
    bad_sweep = FieldConfig(
        action="free_field", scheme=Scheme.EXACT, sweep=Sweep.CHECKERBOARD
    )
    with pytest.raises(ValueError, match="SYNC"):
        field.make_field_frame_fn(phi4.get_field("free_field"), bad_sweep)
    # runtime routes EXACT to xla on a GPU too; an explicit cuda request
    # refuses
    from stochquant import runtime

    good = FieldConfig(action="free_field", shape=(8, 8), scheme=Scheme.EXACT)
    assert runtime.select_path("field", good, "auto", platform="gpu")[0] == "xla"
    with pytest.raises(ValueError, match="no CUDA kernel"):
        runtime.select_path("field", good, "cuda", platform="gpu")


# ---------------------------------------------------------------------------
# r5 (VERDICT r4 item 7): Scheme.EXACT for INTERACTING fields — the
# exponential (ETD1) integrator: exact OU propagation of the Gaussian part
# per rfftn mode + explicit φ₁-weighted treatment of dV_int.
# ---------------------------------------------------------------------------


def test_exact_interacting_reduces_to_free_at_zero_coupling():
    """λ = 0 through the interacting branch must reproduce the FreeField
    exact path bitwise (the ETD1 correction is exactly zero and the clamp
    is a no-op at these amplitudes) — a deterministic consistency anchor."""
    from stochquant.actions import phi4
    from stochquant.config import FieldConfig
    from stochquant.integrators import field

    cfg = FieldConfig(action="phi4", shape=(8, 8), n_chains=4, loops=6,
                      dtau=0.3, seed=5, grow_after=10**9,
                      scheme=Scheme.EXACT)
    s0 = field.init_field_state(cfg)
    a, ma = field.run_field_frames(s0, phi4.ScalarPhi4(m2=1.0, lam=0.0),
                                   cfg, 2)
    b, mb = field.run_field_frames(s0, phi4.FreeField(m2=1.0), cfg, 2)
    np.testing.assert_array_equal(np.asarray(a.phi), np.asarray(b.phi))
    np.testing.assert_array_equal(np.asarray(a.phi2_mean),
                                  np.asarray(b.phi2_mean))
    assert np.asarray(ma["stable"]).all() and np.asarray(mb["stable"]).all()


def test_exact_interacting_stable_where_em_diverges():
    """2-D φ⁴ at Δτ·B̂_max ≈ 4.5, far beyond EM's stability limit
    (Δτ·B̂_max < 2): EM trips its detector; the exponential integrator runs
    with stable_frac 1 and finite moments — the capability the scheme
    ladder exists for (the reference's plain EM, tau_kernel.cl:111-117,
    cannot touch this regime)."""
    from stochquant.actions import phi4
    from stochquant.config import FieldConfig
    from stochquant.integrators import field

    base = dict(action="phi4", shape=(8, 8), n_chains=4, loops=10,
                dtau=0.5, seed=3, grow_after=10**9)
    act = phi4.ScalarPhi4(m2=1.0, lam=0.5)
    em_cfg = FieldConfig(**base)
    ex_cfg = FieldConfig(**base, scheme=Scheme.EXACT)
    _, m_em = field.run_field_frames(
        field.init_field_state(em_cfg), act, em_cfg, 2
    )
    s_ex, m_ex = field.run_field_frames(
        field.init_field_state(ex_cfg), act, ex_cfg, 2
    )
    assert not np.asarray(m_em["stable"]).all()
    assert np.asarray(m_ex["stable"]).all()
    assert np.isfinite(np.asarray(s_ex.phi)).all()
    assert np.isfinite(np.asarray(s_ex.phi2_mean)).all()


def test_exact_interacting_nonlinear_trip_still_detected():
    """The Gaussian part cannot diverge, but the explicit dV_int remainder
    can: at a pathological coupling the |correction|-vs-lrg_vl detector
    must trip, reject the frame, and shrink Δτ (the EM recovery
    semantics, kept alive for the interacting EXACT path)."""
    from stochquant.actions import phi4
    from stochquant.config import FieldConfig
    from stochquant.integrators import field

    cfg = FieldConfig(action="phi4", shape=(8, 8), n_chains=2, loops=6,
                      dtau=2.0, seed=7, grow_after=10**9,
                      scheme=Scheme.EXACT)
    act = phi4.ScalarPhi4(m2=1.0, lam=4000.0)
    s0 = field.init_field_state(cfg)
    out, m = field.run_field_frames(s0, act, cfg, 1)
    assert not np.asarray(m["stable"]).any()
    np.testing.assert_array_equal(np.asarray(out.phi), np.asarray(s0.phi))
    np.testing.assert_allclose(
        np.asarray(out.dtau), cfg.dtau * cfg.shrink, rtol=1e-6
    )


@pytest.mark.slow
def test_exact_interacting_moments_match_fine_dtau_em():
    """Equilibrium ⟨φ²⟩ of 2-D φ⁴ (λ = 0.5): the exponential integrator at
    Δτ = 0.3 — where EM cannot run at all — must agree with a fine-Δτ EM
    reference (Δτ = 0.01) to the scheme's O(λΔτ) bias + statistics."""
    from stochquant.actions import phi4
    from stochquant.config import FieldConfig
    from stochquant.integrators import field

    act = phi4.ScalarPhi4(m2=1.0, lam=0.5)

    def run(scheme, dtau, frames, burn):
        cfg = FieldConfig(action="phi4", shape=(8, 8), n_chains=32,
                          loops=100, dtau=dtau, seed=11, grow_after=10**9,
                          scheme=scheme)
        s = field.init_field_state(cfg)
        s, m = field.run_field_frames(s, act, cfg, burn)
        assert np.asarray(m["stable"]).all()
        from stochquant.integrators.field import FieldState

        s = field.init_field_state(cfg)._replace(
            phi=s.phi, dtau=s.dtau, step=s.step
        )  # reset means, keep the equilibrated field
        s, m = field.run_field_frames(s, act, cfg, frames)
        assert np.asarray(m["stable"]).all()
        return float(np.asarray(s.phi2_mean).mean())

    # EM needs ~30x the steps per unit Langevin time at its fine Δτ; keep
    # the simulated time comparable instead of the step count
    ref = run(Scheme.EM, 0.01, frames=40, burn=15)
    ex = run(Scheme.EXACT, 0.3, frames=4, burn=2)
    assert abs(ex - ref) / abs(ref) < 0.10, (ex, ref)


def test_exact_interacting_rejects_negative_m2():
    """m² <= 0 (the broken-symmetry phase): B̂(k) crosses zero, so the
    'exact' Gaussian propagator would AMPLIFY the soft modes with the
    wrong noise branch and no detector trip — must refuse loudly
    (r5 review finding)."""
    from stochquant.actions import phi4
    from stochquant.config import FieldConfig
    from stochquant.integrators import field

    cfg = FieldConfig(action="phi4", shape=(8, 8), scheme=Scheme.EXACT)
    for act in (phi4.ScalarPhi4(m2=-1.0, lam=1.0), phi4.FreeField(m2=0.0)):
        with pytest.raises(ValueError, match="positive Gaussian curvature"):
            field.make_field_frame_fn(act, cfg)
