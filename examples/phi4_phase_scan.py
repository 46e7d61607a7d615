"""2-D φ⁴ phase structure: scan m² through the symmetry-breaking transition
and watch ⟨|M|⟩ and the susceptibility χ (config 3 observables).

Run (CPU):  JAX_PLATFORMS=cpu python examples/phi4_phase_scan.py
"""

import numpy as np

from stochquant.actions import phi4
from stochquant.config import FieldConfig, Sweep
from stochquant.integrators import field


def main():
    lam = 6.0
    L = 24
    cfg = FieldConfig(
        action="phi4",
        shape=(L, L),
        dtau=0.02,
        n_chains=16,
        loops=200,
        seed=11,
        grow_after=10**9,
        sweep=Sweep.CHECKERBOARD,
    )
    print(f"{'m^2':>7} | {'<|M|>':>8} | {'chi':>9} | {'<phi^2>':>8}")
    for m2 in [1.0, 0.0, -0.5, -1.0, -1.5, -2.0, -3.0]:
        act = phi4.get_field("phi4", m2=m2, lam=lam)
        state = field.init_field_state(cfg)
        state, _ = field.run_field_frames(state, act, cfg, 25)
        state = field.reset_field_means(state)
        state, metrics = field.run_field_frames(state, act, cfg, 50)
        absmag = float(np.asarray(state.absmag_mean).mean())
        chi = float(np.asarray(field.susceptibility(state, L * L)).mean())
        p2 = float(np.asarray(state.phi2_mean).mean())
        print(f"{m2:>7.2f} | {absmag:>8.4f} | {chi:>9.3f} | {p2:>8.4f}")
    print("\nbroken phase (m^2 << 0): <|M|> -> sqrt(-6 m^2/lam); "
          "chi peaks near the transition")


if __name__ == "__main__":
    main()
