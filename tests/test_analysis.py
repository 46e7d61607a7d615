"""Analysis routine tests: autocorrelation time on an AR(1) with known τ,
jackknife errors, and energy-gap extraction on synthetic + harmonic data."""

import numpy as np

from stochquant.observables import analysis


def test_autocorr_time_ar1():
    rng = np.random.default_rng(0)
    rho = 0.9
    n = 200000
    x = np.empty(n)
    x[0] = 0
    eps = rng.normal(size=n)
    for i in range(1, n):
        x[i] = rho * x[i - 1] + eps[i]
    tau = analysis.autocorr_time(x)
    expect = (1 + rho) / (2 * (1 - rho))  # = 9.5 for rho=0.9
    assert abs(tau - expect) / expect < 0.25, (tau, expect)


def test_autocorr_time_white_noise():
    x = np.random.default_rng(1).normal(size=50000)
    tau = analysis.autocorr_time(x)
    assert 0.3 < tau < 0.8


def test_binned_jackknife_matches_naive_for_iid():
    x = np.random.default_rng(2).normal(loc=3.0, size=40000)
    mean, err = analysis.binned_jackknife(x, bin_size=1)
    assert abs(mean - 3.0) < 5 * err
    naive = x.std(ddof=1) / np.sqrt(len(x))
    assert abs(err - naive) / naive < 0.1


def test_jackknife_inflates_error_for_correlated_series():
    rng = np.random.default_rng(3)
    rho = 0.95
    n = 100000
    x = np.empty(n)
    x[0] = 0
    eps = rng.normal(size=n)
    for i in range(1, n):
        x[i] = rho * x[i - 1] + np.sqrt(1 - rho**2) * eps[i]
    _, err_auto = analysis.binned_jackknife(x)  # autocorrelation-aware
    _, err_naive = analysis.binned_jackknife(x, bin_size=1)
    assert err_auto > 3 * err_naive  # τ_int ≈ 19.5 → ~6x inflation


def test_energy_gap_synthetic_exponential():
    n, dt, gap = 64, 0.25, 1.3
    mid = n // 2
    t = np.abs(np.arange(n) - mid) * dt
    corr = 0.7 * np.exp(-gap * t)
    fit = analysis.energy_gap_from_correlator(corr, dt)
    assert abs(fit.gap - gap) < 1e-6
    assert abs(fit.amplitude - 0.7) < 1e-6


def test_energy_gap_harmonic_oscillator_em():
    """End-to-end: gap from the exact EM covariance row of the harmonic chain
    must approach ω₀=√2 (continuum E₁−E₀) for fine Δt."""
    from stochquant.config import BoundaryCondition
    from stochquant.observables import exact

    N, dt = 128, 0.1
    B = exact.harmonic_drift_matrix(N, dt, k=2.0, bc=BoundaryCondition.PERIODIC)
    sigma = exact.target_cov(B, dt)
    corr = sigma[:, N // 2]
    fit = analysis.energy_gap_from_correlator(corr, dt)
    assert abs(fit.gap - np.sqrt(2.0)) < 0.05, fit


def test_cross_chain_error():
    v = np.random.default_rng(5).normal(loc=1.5, size=256)
    mean, err = analysis.cross_chain_error(v)
    assert abs(mean - 1.5) < 5 * err
