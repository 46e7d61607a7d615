"""Complex-Langevin gauge theory: holomorphic drifts, gauge cooling,
complex-β known answers (exact 2-D one-plaquette continuations).

Gates:
* algebra: expm_taylor ≡ scipy expm; inv22/inv33 ≡ exact inverse;
* reduction: complexified drift at unitary links + real β ≡ the compact
  groups' hermitian drift (actions/gauge.py);
* holomorphy: drift ≡ −∂S/∂θ via jax.grad for cu1 (complex step math);
* cooling: exactly gauge (plaquettes invariant), strictly decreases the
  unitarity norm, and recovers a unitary configuration from a random
  non-unitary gauge transform of one;
* physics: 2-D complex-β mean plaquette matches the analytic continuation
  I₁(β)/I₀(β) (cu1) / Weyl integrals (csu2) within statistical error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stochquant import rng
from stochquant.actions import gauge as gauge_mod
from stochquant.actions import gauge_complex as gc
from stochquant.integrators.gauge import (
    GaugeConfig,
    exact_plaquette_2d,
    init_gauge_state,
    resolve_gauge_action,
    run_gauge_frames,
)


def _random_su(n, shape, seed=0):
    """Haar-ish random SU(n) field via QR of a complex Gaussian."""
    r = np.random.default_rng(seed)
    a = r.normal(size=shape + (n, n)) + 1j * r.normal(size=shape + (n, n))
    q, rr = np.linalg.qr(a)
    d = np.diagonal(rr, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]
    det = np.linalg.det(q)
    q = q / det[..., None, None] ** (1.0 / n)
    return jnp.asarray(q.astype(np.complex64))


# ---------------------------------------------------------------- algebra


def test_expm_taylor_matches_scipy():
    from scipy.linalg import expm

    r = np.random.default_rng(1)
    a = 0.3 * (r.normal(size=(5, 3, 3)) + 1j * r.normal(size=(5, 3, 3)))
    got = np.asarray(gc.expm_taylor(jnp.asarray(a.astype(np.complex64))))
    want = np.stack([expm(m) for m in a])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [2, 3])
def test_inv_closed_form(n):
    r = np.random.default_rng(2)
    a = r.normal(size=(7, n, n)) + 1j * r.normal(size=(7, n, n))
    inv = gc.inv22 if n == 2 else gc.inv33
    got = np.asarray(inv(jnp.asarray(a.astype(np.complex64))))
    want = np.linalg.inv(a)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# ------------------------------------------------- reduction to real path


@pytest.mark.parametrize("group,cgroup", [("su2", "csu2"), ("su3", "csu3")])
def test_complex_drift_reduces_to_real_at_unitary_links(group, cgroup):
    """At unitary links and real β the holomorphic drift must equal the
    compact group's hermitian-projected drift.  SU(2)'s real path uses
    quaternions, so compare through the csu2 matrix rep against su3-style
    matrix algebra only for su3; for su2 compare action values instead."""
    beta = 1.3
    shape = (4, 4)
    u = _random_su(int(cgroup[-1]), (3, 2) + shape, seed=5)

    ca = gauge_mod.get_gauge(cgroup, beta=beta)
    hol = np.asarray(ca.drift(u, 2))

    if group == "su3":
        ra = gauge_mod.get_gauge("su3", beta=beta)
        herm = np.asarray(ra.drift(u, 2))
        np.testing.assert_allclose(hol, herm, rtol=0, atol=2e-4)
    else:
        # the quaternion path stores links differently; gate via the action
        # value: S_cSUN(U) real and equal to the Wilson action on SU(2)
        s = np.asarray(ca.action(u, 2))
        assert np.max(np.abs(s.imag)) < 1e-3
        # hermiticity of the drift at unitary links (M̃ = M† there)
        np.testing.assert_allclose(
            hol, np.conj(np.swapaxes(hol, -1, -2)), rtol=0, atol=2e-4
        )


def test_cu1_drift_is_holomorphic_gradient():
    """cu1 drift ≡ −∂S/∂θ: check via jax.grad of the complex action's real
    part with respect to (Re θ, Im θ) — for holomorphic S, ∂S/∂θ =
    ∂(Re S)/∂(Re θ) − i·∂(Re S)/∂(Im θ)."""
    beta = 0.9 + 0.4j
    a = gauge_mod.get_gauge("cu1", beta=beta.real, beta_im=beta.imag)
    r = np.random.default_rng(3)
    th = jnp.asarray(
        (r.normal(size=(2, 2, 6, 6)) + 1j * 0.1 * r.normal(size=(2, 2, 6, 6))).astype(
            np.complex64
        )
    )

    def s_real(tr, ti):
        return jnp.sum(jnp.real(a.action(tr + 1j * ti, 2)))

    gr = jax.grad(s_real, argnums=0)(jnp.real(th), jnp.imag(th))
    gi = jax.grad(s_real, argnums=1)(jnp.real(th), jnp.imag(th))
    want = -(gr - 1j * gi)  # −∂S/∂θ (holomorphic: Cauchy–Riemann)
    got = np.asarray(a.drift(th, 2))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


def test_csun_action_matches_real_wilson_on_su3():
    beta = 2.1
    u = _random_su(3, (2, 2, 5, 5), seed=7)
    ca = gauge_mod.get_gauge("csu3", beta=beta)
    ra = gauge_mod.get_gauge("su3", beta=beta)
    s_c = np.asarray(ca.action(u, 2))
    s_r = np.asarray(ra.action(u, 2))
    np.testing.assert_allclose(s_c.real, s_r, rtol=0, atol=5e-3)
    assert np.max(np.abs(s_c.imag)) < 5e-3


# ------------------------------------------------------------ gauge cooling


def _gauge_transform_su(u, eps, seed):
    """Apply a random non-unitary gauge transform G(x)=exp(h), h hermitian
    traceless O(eps): U_μ(x) ← G(x) U_μ(x) G(x+μ̂)⁻¹ — same gauge orbit."""
    n = u.shape[-1]
    r = np.random.default_rng(seed)
    nv = n * n - 1
    coef = eps * r.normal(size=(u.shape[0],) + u.shape[2:-2] + (nv,))
    t = gc._sun_generators(n)
    h = np.einsum("...a,aij->...ij", coef, t).astype(np.complex64)
    g = gc.expm_taylor(jnp.asarray(h))
    gi = gc.expm_taylor(jnp.asarray(-h))
    new = []
    for mu in range(u.shape[1]):
        gi_up = jnp.roll(gi, -1, axis=mu + 1)
        new.append(gc.mmul(gc.mmul(g, u[:, mu]), gi_up))
    return jnp.stack(new, axis=1)


@pytest.mark.parametrize("cgroup", ["csu2", "csu3"])
def test_cooling_recovers_unitarity_and_preserves_plaquette(cgroup):
    n = int(cgroup[-1])
    beta = 1.0
    a = gauge_mod.get_gauge(cgroup, beta=beta)
    u0 = _random_su(n, (2, 2, 6, 6), seed=11)
    u = _gauge_transform_su(u0, 0.3, seed=12)

    norm0 = float(jnp.max(a.unitarity_norm(u, 2)))
    plaq0 = np.asarray(a.mean_plaquette(u, 2))
    assert norm0 > 1e-2  # the transform really left the unitary manifold

    u_cool = a.cool(u, 2, rate=0.05, steps=60)
    norm1 = float(jnp.max(a.unitarity_norm(u_cool, 2)))
    plaq1 = np.asarray(a.mean_plaquette(u_cool, 2))

    assert norm1 < 0.05 * norm0  # cooling descends the gauge orbit
    # cooling is exactly gauge: holomorphic observables unchanged
    np.testing.assert_allclose(plaq1, plaq0, rtol=0, atol=5e-4)
    # and the config is gauge-equivalent to a unitary one, so cooling can
    # (nearly) reach norm 0
    assert norm1 < 1e-3


def test_cu1_cooling_gauge_invariance():
    a = gauge_mod.get_gauge("cu1", beta=1.0)
    r = np.random.default_rng(13)
    th = jnp.asarray(
        (r.normal(size=(2, 2, 8, 8)) + 0.3j * r.normal(size=(2, 2, 8, 8))).astype(
            np.complex64
        )
    )
    plaq0 = np.asarray(a.mean_plaquette(th, 2))
    norm0 = float(jnp.max(a.unitarity_norm(th, 2)))
    th_c = a.cool(th, 2, rate=0.1, steps=50)
    plaq1 = np.asarray(a.mean_plaquette(th_c, 2))
    norm1 = float(jnp.max(a.unitarity_norm(th_c, 2)))
    np.testing.assert_allclose(plaq1, plaq0, rtol=0, atol=1e-4)
    assert norm1 < norm0  # random Im θ has gauge + physical parts; the
    # gauge part (the lattice-divergence piece) is removed


# ------------------------------------------------------- physics (known answer)


@pytest.mark.slow
def test_cu1_complex_beta_matches_analytic_continuation():
    """2-D complexified U(1) at β = 1 + 0.5i: CL mean plaquette must match
    I₁(β)/I₀(β) continued to complex β."""
    beta = 1.0 + 0.5j
    cfg = GaugeConfig(
        group="cu1",
        beta=beta.real,
        beta_im=beta.imag,
        shape=(8, 8),
        n_chains=64,
        dtau=5e-3,
        loops=100,
        frames=60,
        seed=3,
        drift_cap=20.0,
        cooling_rate=0.05,
    )
    action = resolve_gauge_action(cfg)
    state = init_gauge_state(cfg, action)
    # thermalize, then measure
    state, _ = run_gauge_frames(state, action, cfg, 20)
    from stochquant.integrators.gauge import reset_gauge_means

    state, metrics = run_gauge_frames(reset_gauge_means(state), action, cfg, cfg.frames)
    vals = np.asarray(state.plaq_mean)
    est = complex(vals.mean())
    err = float(vals.real.std() + vals.imag.std()) / np.sqrt(len(vals)) + 1e-3
    want = exact_plaquette_2d("cu1", beta)
    assert abs(est - want) < 6.0 * err, (est, want, err)
    # cooling keeps the run near the unitary manifold
    assert float(np.asarray(metrics["unitarity_norm"])[-1].max()) < 0.5


@pytest.mark.slow
def test_csu2_complex_beta_matches_weyl_integral():
    beta = 1.2 + 0.4j
    cfg = GaugeConfig(
        group="csu2",
        beta=beta.real,
        beta_im=beta.imag,
        shape=(6, 6),
        n_chains=48,
        dtau=2e-3,
        loops=100,
        frames=80,
        seed=5,
        drift_cap=20.0,
        cooling_rate=0.05,
        cooling_steps=1,
    )
    action = resolve_gauge_action(cfg)
    state = init_gauge_state(cfg, action)
    state, _ = run_gauge_frames(state, action, cfg, 30)
    from stochquant.integrators.gauge import reset_gauge_means

    state, metrics = run_gauge_frames(reset_gauge_means(state), action, cfg, cfg.frames)
    vals = np.asarray(state.plaq_mean)
    est = complex(vals.mean())
    err = float(vals.real.std() + vals.imag.std()) / np.sqrt(len(vals)) + 2e-3
    want = exact_plaquette_2d("csu2", beta)
    assert abs(est - want) < 6.0 * err, (est, want, err)
    assert float(np.asarray(metrics["unitarity_norm"])[-1].max()) < 0.5


@pytest.mark.slow
def test_complex_group_real_beta_reduces_to_compact_answer():
    """csu3 with real β and cooling stays (statistically) on the compact
    answer — a cheap smoke gate that the full CL machinery at Im β = 0
    reproduces the real-path physics."""
    beta = 2.0
    cfg = GaugeConfig(
        group="csu3",
        beta=beta,
        shape=(4, 4),
        n_chains=32,
        dtau=2e-3,
        loops=60,
        frames=40,
        seed=9,
        cooling_rate=0.05,
    )
    action = resolve_gauge_action(cfg)
    state = init_gauge_state(cfg, action)
    state, _ = run_gauge_frames(state, action, cfg, 20)
    from stochquant.integrators.gauge import reset_gauge_means

    state, _ = run_gauge_frames(reset_gauge_means(state), action, cfg, cfg.frames)
    vals = np.asarray(state.plaq_mean)
    est = complex(vals.mean())
    err = float(vals.real.std()) / np.sqrt(len(vals)) + 2e-3
    want = exact_plaquette_2d("su3", beta)
    assert abs(est.real - want) < 6.0 * err, (est, want, err)
    assert abs(est.imag) < 6.0 * err
