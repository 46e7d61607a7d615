"""End-to-end physics demo: extract the energy gap E₁−E₀ of the harmonic
oscillator from the connected correlator and compare to ω₀ = √(k/m).

This is the measurement the reference performs by letting a human read the
slope of the streamed log|C(t)| off a live plot (taumain.py:51-89); here the
whole chain — simulate → correlator → autocorrelation-aware errors →
weighted log-linear fit — is automated.

Run (CPU ok):  JAX_PLATFORMS=cpu python examples/energy_gap.py
"""

import numpy as np

from stochquant import actions
from stochquant.config import BoundaryCondition, ChainConfig, Formulation
from stochquant.integrators import langevin
from stochquant.observables import analysis


def main():
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
    state, _ = langevin.run_frames(state, act, cfg, 30)   # thermalize
    state = langevin.reset_means(state)
    state, metrics = langevin.run_frames(state, act, cfg, 120)
    assert np.asarray(metrics["stable"])[-1].all()

    corr = np.asarray(langevin.connected_correlator(state), np.float64)
    mean = corr.mean(axis=0)
    err = corr.std(axis=0) / np.sqrt(cfg.n_chains)
    fit = analysis.energy_gap_from_correlator(mean, cfg.dt, corr_err=err)

    omega0 = act.omega0
    print(f"fitted gap  E1-E0 = {fit.gap:.4f} ± {fit.gap_err:.4f}")
    print(f"continuum   omega0 = {omega0:.4f}")
    # finite-Δt lattice dispersion: sinh(Δt·E)/Δt = ω₀·sqrt(1+(Δt·ω₀/2)²)
    e_lat = 2.0 / cfg.dt * np.arcsinh(0.5 * cfg.dt * omega0)
    print(f"lattice     E(dt)  = {e_lat:.4f}   (leading finite-dt prediction)")
    dev = abs(fit.gap - e_lat)
    print(f"deviation: {dev:.4f}  ({dev / max(fit.gap_err, 1e-9):.1f} sigma)")


if __name__ == "__main__":
    main()
