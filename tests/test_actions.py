"""Action library tests: hand-derived derivatives vs autodiff, drift vs
−δS/δφ, and reference-constant parity (SURVEY.md §4 unit tests)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stochquant import actions
from stochquant.actions import phi4


QM_NAMES = ["harmonic", "double_well", "anharmonic", "poeschl_teller"]


@pytest.mark.parametrize("name", QM_NAMES)
def test_dV_matches_autodiff(name):
    act = actions.get(name)
    xs = jnp.linspace(-2.0, 2.0, 41)
    grad_v = jnp.vectorize(jax.grad(act.V))(xs)
    np.testing.assert_allclose(act.dV(xs), grad_v, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", QM_NAMES)
def test_ddV_matches_autodiff(name):
    act = actions.get(name)
    xs = jnp.linspace(-2.0, 2.0, 41)
    dd = jnp.vectorize(jax.grad(jax.grad(act.V)))(xs)
    np.testing.assert_allclose(act.ddV(xs), dd, rtol=1e-5, atol=1e-6)


def test_double_well_reference_constants():
    """Parity with tau_kernel.cl: V'' (:190-195), kink (:184-189),
    zero-mode const (:196-200) at the reference's η=.8, V₀=2, m=1."""
    dw = actions.get("double_well")
    assert dw.eta == 0.8 and dw.v0 == 2.0 and dw.mass == 1.0
    x = 0.37
    expect_ddv = (12.0 * 2.0 * x * x / 0.64 - 4.0 * 2.0) / 0.64
    np.testing.assert_allclose(float(dw.ddV(jnp.float64(x))), expect_ddv, rtol=1e-6)
    t, w = 1.3, 0.4
    expect_kink = 0.8 * math.tanh(math.sqrt(2.0 * 2.0 / 1.0) * (t - w) / 0.8)
    np.testing.assert_allclose(float(dw.x_cl(jnp.float64(t), w)), expect_kink, rtol=1e-6)
    expect_const = math.sqrt(3.0) * 2 ** (-5 / 4) * 2.0 ** (-1 / 4) / math.sqrt(0.8)
    np.testing.assert_allclose(dw.zero_mode_const(), expect_const, rtol=1e-12)
    assert dw.boundary_asymptote(+1) == 0.8
    assert dw.boundary_asymptote(-1) == -0.8


def test_harmonic_matches_reference_curvature():
    ho = actions.get("harmonic")
    # tau_kernel.cl:206-209: V'' ≡ 2
    np.testing.assert_allclose(np.asarray(ho.ddV(jnp.linspace(-1, 1, 5))), 2.0)
    assert float(ho.x_cl(jnp.float32(1.0), 0.0)) == 0.0
    assert ho.zero_mode_const() == 0.0


def test_action_drift_consistency_periodic():
    """Interior EM drift = −(1/Δt)·∂S/∂x_i for the full lattice action."""
    act = actions.get("anharmonic")
    dt = 0.25
    x = jnp.asarray(np.random.default_rng(0).normal(size=(12,)), jnp.float64)
    grad_S = jax.grad(lambda y: act.action(y, dt, periodic=True))(x)
    lap = (jnp.roll(x, 1) + jnp.roll(x, -1) - 2 * x) * act.mass / dt**2
    drift = lap - act.dV(x)
    np.testing.assert_allclose(np.asarray(drift), -np.asarray(grad_S) / dt, rtol=1e-9)


def test_fluctuation_action_drift_consistency():
    """Background-formulation drift (tau_kernel.cl:111-117) is the exact
    gradient of the quadratic fluctuation action."""
    act = actions.get("double_well")
    dt, omega = 0.1, 0.6
    n = 10
    t = jnp.arange(n, dtype=jnp.float64) * dt
    f = jnp.asarray(np.random.default_rng(1).normal(size=(n,)) * 0.1, jnp.float64)
    gl = -act.eta - act.x_cl(jnp.float64(-dt), omega)
    gr = act.eta - act.x_cl(jnp.float64(n * dt), omega)
    grad_S = jax.grad(
        lambda y: act.fluctuation_action(y, t, omega, dt, f_left=gl, f_right=gr)
    )(f)
    up = jnp.concatenate([f[1:], jnp.asarray([gr])])
    dn = jnp.concatenate([jnp.asarray([gl]), f[:-1]])
    lap = (up + dn - 2 * f) * act.mass / dt**2
    drift = lap - act.ddV(act.x_cl(t, omega)) * f
    np.testing.assert_allclose(np.asarray(drift), -np.asarray(grad_S) / dt, rtol=1e-9)


def test_phi4_drift_matches_autodiff():
    for name in ["phi4", "free_field"]:
        fa = phi4.get_field(name)
        rng_np = np.random.default_rng(2)
        for shape, a in [((6, 6), 1.0), ((4, 4, 4), 0.7)]:
            p = jnp.asarray(rng_np.normal(size=shape), jnp.float64)
            ndim = len(shape)
            grad_S = jax.grad(lambda y: fa.action(y, a, ndim))(p)
            drift = fa.drift(p, a, ndim)
            np.testing.assert_allclose(
                np.asarray(drift), -np.asarray(grad_S) / a**ndim, rtol=1e-8, atol=1e-10
            )


def test_registry_and_potid_map():
    assert set(actions.POT_ID_TO_NAME.values()) <= set(actions.names())
    assert actions.NAME_TO_POT_ID["double_well"] == 3
    with pytest.raises(KeyError):
        actions.get("nope")


def test_complex_actions():
    cg = actions.get_complex("complex_gaussian", sigma_re=2.0, sigma_im=1.0)
    z = jnp.complex64(0.3 + 0.2j)
    np.testing.assert_allclose(
        np.asarray(cg.dS(z)), np.asarray((2 + 1j) * (0.3 + 0.2j)), rtol=1e-6
    )
    cq = actions.get_complex("complex_quartic")
    # dS is the holomorphic derivative of S
    eps = 1e-4
    num = (np.asarray(cq.S(z + eps)) - np.asarray(cq.S(z - eps))) / (2 * eps)
    np.testing.assert_allclose(np.asarray(cq.dS(z)), num, rtol=1e-2)
