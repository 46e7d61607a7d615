"""Physics regressions: quantitative end-to-end gates replacing the
reference's plot-eyeballing validation (SURVEY.md §4)."""

import numpy as np
import pytest

from stochquant import actions
from stochquant.config import BoundaryCondition, ChainConfig, Formulation
from stochquant.integrators import langevin
from stochquant.observables import analysis


@pytest.mark.slow
def test_harmonic_energy_gap_matches_lattice_dispersion():
    """E₁−E₀ from the correlator decay vs the exact lattice dispersion
    sinh(Δt·E/2)·2/Δt = ω₀ (… leading finite-Δt form)."""
    cfg = ChainConfig(
        action="harmonic",
        n_sites=64,
        dt=0.25,
        dtau=0.01,
        n_chains=512,
        loops=200,
        bc=BoundaryCondition.PERIODIC,
        formulation=Formulation.DIRECT,
        seed=1,
        grow_after=10**9,
    )
    act = actions.get(cfg.action)
    state = langevin.init_chain_state(cfg, act)
    state, _ = langevin.run_frames(state, act, cfg, 30)
    state = langevin.reset_means(state)
    state, metrics = langevin.run_frames(state, act, cfg, 120)
    assert np.asarray(metrics["stable"])[-1].all()

    corr = np.asarray(langevin.connected_correlator(state), np.float64)
    mean = corr.mean(axis=0)
    err = corr.std(axis=0) / np.sqrt(cfg.n_chains)
    fit = analysis.energy_gap_from_correlator(mean, cfg.dt, corr_err=err)
    e_lat = 2.0 / cfg.dt * np.arcsinh(0.5 * cfg.dt * act.omega0)
    assert abs(fit.gap - e_lat) < 5 * fit.gap_err + 0.01, (fit.gap, e_lat, fit.gap_err)


@pytest.mark.slow
def test_double_well_kink_profile():
    """Background-formulation double well: ⟨x(t)⟩ averaged over chains
    reproduces the kink shape — asymptotes ±η at the edges, with the central
    transition washed out by the wandering collective coordinate ω."""
    cfg = ChainConfig(
        action="double_well",
        n_sites=64,
        dt=0.25,
        dtau=2e-3,
        n_chains=128,
        loops=500,
        seed=42,
        grow_after=10**9,
    )
    act = actions.get(cfg.action)
    state = langevin.init_chain_state(cfg, act)
    state, _ = langevin.run_frames(state, act, cfg, 10)
    state = langevin.reset_means(state)
    state, metrics = langevin.run_frames(state, act, cfg, 30)
    assert np.asarray(metrics["stable"])[-1].all()

    xmean = np.asarray(state.x_mean, np.float64).mean(axis=0)
    eta = act.eta
    # asymptotic plateaus at ±η (within fluctuation width)
    assert abs(xmean[:4].mean() + eta) < 0.25, xmean[:4]
    assert abs(xmean[-4:].mean() - eta) < 0.25, xmean[-4:]
    # antisymmetric about the center up to statistics
    assert abs(xmean[0] + xmean[-1]) < 0.3
    # omega stayed inside the lattice
    om = np.asarray(state.omega)
    assert np.all((om >= 0) & (om <= (cfg.n_sites - 1) * cfg.dt))


def _run_anharmonic(cfg, burn, measure):
    act = actions.get(cfg.action)
    state = langevin.init_chain_state(cfg, act)
    state, _ = langevin.run_frames(state, act, cfg, burn)
    state = langevin.reset_means(state)
    state, metrics = langevin.run_frames(state, act, cfg, measure)
    assert np.asarray(metrics["stable"])[-1].all()
    return act, state


def test_anharmonic_x2_matches_transfer_matrix():
    """Config-2 physics gate (BASELINE.json:8): λφ⁴ chain ⟨x²⟩ against the
    exact fp64 lattice transfer-matrix value (observables/exact.py), with
    cross-chain errors.  LM scheme keeps the stationary Δτ bias at O(Δτ²)
    so the comparison is statistics-limited."""
    from stochquant.config import Scheme
    from stochquant.observables import exact

    cfg = ChainConfig(
        action="anharmonic", n_sites=64, dt=0.25, dtau=0.01, n_chains=64,
        loops=200, bc=BoundaryCondition.PERIODIC,
        formulation=Formulation.DIRECT, scheme=Scheme.LM, seed=6,
        grow_after=10**9,
    )
    act, state = _run_anharmonic(cfg, 20, 100)

    x2 = np.asarray(state.x2_mean, np.float64)
    per_chain = x2.mean(axis=1)
    mean, err = per_chain.mean(), per_chain.std() / np.sqrt(cfg.n_chains)

    x2_exact, _, _ = exact.transfer_matrix_moments(
        lambda x: np.asarray(act.V(x)), cfg.n_sites, cfg.dt
    )
    # grid-convergence of the oracle itself
    x2_fine, _, _ = exact.transfer_matrix_moments(
        lambda x: np.asarray(act.V(x)), cfg.n_sites, cfg.dt,
        n_grid=1200, x_max=5.0,
    )
    assert abs(x2_exact - x2_fine) < 1e-8
    assert abs(mean - x2_exact) < 6 * err + 2e-3, (mean, x2_exact, err)


@pytest.mark.slow
def test_config2_full_scale_x2_and_gap():
    """BASELINE config 2 at its stated scale: N=1024 λφ⁴ chain (chains
    reduced to stay CPU-feasible; the transfer-matrix oracle is exact at any
    N).  Gates ⟨x²⟩ AND the correlator's energy gap via the
    translation-averaged spectrum correlator."""
    from stochquant.config import Scheme
    from stochquant.observables import exact

    cfg = ChainConfig(
        action="anharmonic", n_sites=1024, dt=0.25, dtau=0.01, n_chains=32,
        loops=200, bc=BoundaryCondition.PERIODIC,
        formulation=Formulation.DIRECT, scheme=Scheme.LM, seed=7,
        accumulate_spectrum=True, grow_after=10**9,
    )
    act, state = _run_anharmonic(cfg, 20, 120)

    x2 = np.asarray(state.x2_mean, np.float64)
    per_chain = x2.mean(axis=1)
    mean, err = per_chain.mean(), per_chain.std() / np.sqrt(cfg.n_chains)
    x2_exact, _, gap_exact = exact.transfer_matrix_moments(
        lambda x: np.asarray(act.V(x)), cfg.n_sites, cfg.dt
    )
    assert abs(mean - x2_exact) < 6 * err + 2e-3, (mean, x2_exact, err)

    # energy gap from the translation-averaged two-point function: every
    # site pair contributes (far better statistics than the reference's
    # single midpoint column, tau_kernel.cl:144)
    corr = np.asarray(langevin.translation_averaged_correlator(state), np.float64)
    mean_c = corr.mean(axis=0)
    err_c = corr.std(axis=0) / np.sqrt(cfg.n_chains)
    # spectrum correlator is separation-indexed (mid=0); the gap here is
    # large (ξ ≈ 2 sites) so fit the short-distance window before the noise
    # floor, skipping the Δ=0 contact term
    fit = analysis.energy_gap_from_correlator(
        mean_c, cfg.dt, mid=0, fit_range=(1, 8), corr_err=err_c
    )
    assert abs(fit.gap - gap_exact) < 5 * fit.gap_err + 0.05, (
        fit.gap, gap_exact, fit.gap_err
    )


def test_anharmonic_schwinger_dyson_identity():
    """Lattice Schwinger–Dyson (virial) identity ⟨x_i·∂S/∂x_i⟩ = 1 per site:
    the kinetic part comes from the translation-averaged correlator
    (2C(0) − 2C(1)) and the potential part needs the new ⟨x⁴⟩ moment —
    an independent stationarity gate on the sampled distribution."""
    from stochquant.config import Scheme

    cfg = ChainConfig(
        action="anharmonic", n_sites=64, dt=0.25, dtau=0.01, n_chains=64,
        loops=200, bc=BoundaryCondition.PERIODIC,
        formulation=Formulation.DIRECT, scheme=Scheme.LM, seed=8,
        accumulate_spectrum=True, grow_after=10**9,
    )
    act = actions.get(cfg.action)
    state = langevin.init_chain_state(cfg, act)
    state, _ = langevin.run_frames(state, act, cfg, 20)
    state = langevin.reset_means(state)
    state, metrics = langevin.run_frames(state, act, cfg, 100)
    assert np.asarray(metrics["stable"])[-1].all()

    corr = np.asarray(
        langevin.translation_averaged_correlator(state), np.float64
    )  # (C, N), C(Δ)
    x4 = np.asarray(state.x4_mean, np.float64).mean(axis=1)  # (C,)
    c0 = corr[:, 0]
    c1 = corr[:, 1]
    sd = (act.mass / cfg.dt) * (2.0 * c0 - 2.0 * c1) + cfg.dt * (
        act.mu2 * c0 + 4.0 * act.lam * x4
    )
    mean, err = sd.mean(), sd.std() / np.sqrt(cfg.n_chains)
    assert abs(mean - 1.0) < 6 * err + 5e-3, (mean, err)


@pytest.mark.slow
def test_field_binder_cumulant_gaussian_phase():
    """Free field: M is exactly Gaussian, so ⟨M⁴⟩ = 3⟨M²⟩² and the Binder
    cumulant U = 1 − ⟨M⁴⟩/(3⟨M²⟩²) must vanish within statistics."""
    from stochquant.actions import phi4 as phi4_mod
    from stochquant.integrators import field as field_mod

    from stochquant.config import FieldConfig

    cfg = FieldConfig(
        action="free_field", shape=(16, 16), dtau=0.02, n_chains=64,
        loops=100, seed=9, grow_after=10**9,
    )
    act = phi4_mod.get_field(cfg.action)
    state = field_mod.init_field_state(cfg)
    state, _ = field_mod.run_field_frames(state, act, cfg, 10)
    state = field_mod.reset_field_means(state)
    state, metrics = field_mod.run_field_frames(state, act, cfg, 60)
    assert np.asarray(metrics["stable"])[-1].all()

    u = np.asarray(field_mod.binder_cumulant(state), np.float64)
    mean, err = u.mean(), u.std() / np.sqrt(cfg.n_chains)
    assert abs(mean) < 6 * err + 0.02, (mean, err)
