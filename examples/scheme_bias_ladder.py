#!/usr/bin/env python
"""Integration-bias ladder: EM vs Heun vs LM vs EXACT on the harmonic chain.

For quadratic actions every scheme's stationary covariance is known in
closed form (observables/exact.py), so the finite-Δτ bias of each
integrator can be read off directly instead of estimated by Monte Carlo:

- EM    : Var = [Δt·b·(1 − Δτ·b/2)]⁻¹ — O(Δτ) bias, stable for Δτ·b < 2
- Heun  : O(Δτ²) bias, same stability bound
- LM    : exact *covariance* at any stable Δτ (higher moments biased)
- EXACT : the exact OU transition — zero bias at ANY Δτ, no stability bound
          (Scheme.EXACT, r3: batched dense matmuls)

The script prints the predicted site-averaged ⟨x²⟩ relative bias per scheme
across Δτ, then runs a short EXACT-scheme simulation at Δτ·b_max ≈ 80 —
a step size where every other scheme diverges instantly — and checks the
sampled ⟨x²⟩ against the Δτ→0 target within Monte-Carlo error.

Run: python examples/scheme_bias_ladder.py   (CPU-friendly, ~1 min)
"""

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

from stochquant import actions  # noqa: E402
from stochquant.config import (  # noqa: E402
    BoundaryCondition,
    ChainConfig,
    Formulation,
    Scheme,
)
from stochquant.integrators import langevin  # noqa: E402
from stochquant.observables import exact  # noqa: E402


def main():
    N, dt = 32, 0.2
    B = exact.harmonic_drift_matrix(N, dt, bc=BoundaryCondition.PERIODIC)
    b_max = float(np.linalg.eigvalsh(B).max())
    target = float(np.diag(exact.target_cov(B, dt)).mean())
    print(f"harmonic chain N={N}, dt={dt}: b_max={b_max:.2f}, "
          f"target <x^2> = {target:.6f}\n")

    print(f"{'dtau*b_max':>10} | {'EM bias':>10} | {'Heun bias':>10} | "
          f"{'LM bias':>10} | {'EXACT bias':>10}")
    for frac in (0.05, 0.2, 0.5, 1.0, 1.9):
        dtau = frac / b_max
        row = [f"{frac:>10.2f}"]
        for cov_fn in (exact.em_stationary_cov, exact.heun_stationary_cov,
                       exact.lm_stationary_cov):
            v = float(np.diag(cov_fn(B, dt, dtau)).mean())
            row.append(f"{v / target - 1.0:>+10.2%}")
        row.append(f"{0.0:>+10.2%}")  # EXACT: zero by construction
        print(" | ".join(row))

    dtau = 80.0 / b_max
    print(f"\nEXACT scheme at dtau = {dtau:.3f} (dtau*b_max = 80 — every "
          "other scheme explodes):")
    cfg = ChainConfig(
        action="harmonic", n_sites=N, dt=dt, dtau=dtau, n_chains=256,
        loops=20, seed=11, scheme=Scheme.EXACT,
        formulation=Formulation.BACKGROUND, bc=BoundaryCondition.PERIODIC,
    )
    act = actions.get("harmonic")
    s = langevin.init_chain_state(cfg, act)
    s, _ = langevin.run_frames(s, act, cfg, 2)   # burn (mixes in ~1 step)
    s = langevin.reset_means(s)
    s, m = langevin.run_frames(s, act, cfg, 30)
    assert np.all(np.asarray(m["stable"]))
    est = np.asarray(s.x2_mean, np.float64).mean()
    se = np.asarray(s.x2_mean, np.float64).mean(1).std() / np.sqrt(cfg.n_chains)
    print(f"  sampled <x^2> = {est:.6f} +/- {se:.6f}")
    print(f"  target        = {target:.6f}  "
          f"(z = {(est - target) / se:+.2f})")


if __name__ == "__main__":
    main()
