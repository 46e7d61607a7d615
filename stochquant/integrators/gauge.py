"""Langevin integrator for lattice gauge fields (U(1) / SU(2) / SU(3) Wilson).

Stochastic quantization of gauge theory à la Parisi–Wu, on the same frame
machinery as the scalar integrators (micro-step scan inside one jitted
frame, per-chain drift-norm step control, frame-level accept/reject with
adaptive base Δτ, on-line running-mean observables — the generalization
of the reference's divergence-detector + adaptive-Δτ loop,
``tauhost.c:523-545``).

Update per micro-step (generators T_a = σ_a/2, ⟨η_aη_b⟩ = 2δ_ab):

    U(1):        θ ← wrap( θ + Δτ_eff·F(θ) + √(2Δτ_eff)·η )
    SU(2)/SU(3): U ← exp(i Σ_a ω_a T_a) U,  ω_a = Δτ_eff·f_a + √(2Δτ_eff)·η_a

(all group specifics live behind the :class:`GaugeAction` interface —
``drift`` / ``noise_to_tangent`` / ``apply_update`` / ``drift_norm``)

with Δτ_eff = Δτ·min(1, d₀/max‖drift‖).  Compact variables can't run away,
so instability here means non-finite values only (drift spikes are handled
by the step control).

Observables: running mean plaquette ⟨(1/N)ReTr U_p⟩ per chain (the 2-D
exact values I₁/I₀ and I₂/I₁ gate the tests), plus max drift norm.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from stochquant import rng
from stochquant.actions import gauge as gauge_mod
from stochquant.integrators import accum

__all__ = [
    "GaugeConfig",
    "GaugeState",
    "init_gauge_state",
    "make_gauge_frame_fn",
    "run_gauge_frames",
    "reset_gauge_means",
    "exact_plaquette_2d",
]

@dataclasses.dataclass(frozen=True)
class GaugeConfig:
    """Wilson-action gauge run on a periodic D-dim lattice."""

    group: str = "u1"                    # gauge registry: "u1" | "su2" | "su3"
                                         # + complexified "cu1"|"csu2"|"csu3"
    beta: float = 1.0
    beta_im: float = 0.0                 # Im β — complexified groups only
    cooling_rate: float = 0.0            # gauge-cooling step ε (0 = off)
    cooling_steps: int = 1               # cooling iterations per micro-step
    shape: Tuple[int, ...] = (16, 16)
    n_chains: int = 64
    dtau: float = 2e-3
    loops: int = 100
    frames: int = 100
    seed: int = 0
    drift_cap: float = 20.0
    shrink: float = 0.95
    grow_after: int = 10
    dtau_max: Optional[float] = None
    hot_start: bool = False              # random links instead of identity
    measure_loops: bool = False          # per-frame Polyakov loop + final
                                         # Wilson-loop table in the metrics
    mesh_axes: Optional[Tuple[Optional[str], ...]] = None
    # per-lattice-dim mesh axis names for gauge domain decomposition
    # (parallel/gauge_halo.py): links sharded over the mesh with 1-site
    # halos exchanged per micro-step (lattices beyond one device's memory)
    mesh_chain_axis: Optional[str] = None

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def to_json(self) -> str:
        import json

        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "GaugeConfig":
        import json

        from stochquant.config import drop_removed_fields

        d = drop_removed_fields(json.loads(s))
        d["shape"] = tuple(d["shape"])
        if d.get("mesh_axes") is not None:
            d["mesh_axes"] = tuple(d["mesh_axes"])
        return cls(**d)


class GaugeState(NamedTuple):
    links: jax.Array       # u1 angles (C,D,*L) | su2 quats (C,4,D,*L) |
                           # su3 matrices (C,D,*L,3,3) complex
    plaq_mean: jax.Array   # (C,) running ⟨(1/N)ReTr U_p⟩
    drift_max: jax.Array   # (C,) max drift norm seen
    runs: jax.Array        # (C, 2) uint32 (lo, hi) 64-bit pair (accum.init_runs)
    dtau: jax.Array        # (C,)
    stab_cnt: jax.Array    # (C,) int32
    step: jax.Array        # () uint32


def resolve_gauge_action(cfg: GaugeConfig) -> gauge_mod.GaugeAction:
    params = {"beta": cfg.beta}
    if cfg.beta_im:
        params["beta_im"] = cfg.beta_im
    return gauge_mod.get_gauge(cfg.group, **params)


def init_gauge_state(cfg: GaugeConfig, action=None) -> GaugeState:
    action = action or resolve_gauge_action(cfg)
    C = cfg.n_chains
    links = action.init_links(action.state_shape(C, cfg.ndim, cfg.shape))
    if cfg.hot_start:
        eta = rng.normal_for_shape(
            cfg.seed, rng.Stream.INIT, 0,
            action.noise_shape(C, cfg.ndim, cfg.shape),
        )
        links = action.hot_start(links, eta)
    zeros = jnp.zeros((C,), jnp.float32)
    return GaugeState(
        links=links,
        plaq_mean=jnp.zeros((C,), jnp.dtype(action.obs_dtype)),
        drift_max=zeros,
        runs=accum.init_runs(C),
        dtau=jnp.full((C,), cfg.dtau, jnp.float32),
        stab_cnt=jnp.zeros((C,), jnp.int32),
        step=jnp.uint32(1),
    )


def make_gauge_frame_fn(action: gauge_mod.GaugeAction, cfg: GaugeConfig):
    C = cfg.n_chains
    ndim = cfg.ndim
    cap = jnp.float32(cfg.drift_cap)
    noise_shape = action.noise_shape(C, ndim, cfg.shape)
    cooling = cfg.cooling_rate > 0.0 and hasattr(action, "cool")

    def frame(state: GaugeState):
        def substep(carry, eta):
            links, ps, dmax, unstable = carry

            f = action.drift(links, ndim)
            dnorm = action.drift_norm(f)

            scale = jnp.minimum(1.0, cap / jnp.maximum(dnorm, 1e-30))
            dtau_eff = (state.dtau * scale).reshape((C,) + (1,) * (f.ndim - 1))
            omega = dtau_eff * f + jnp.sqrt(2.0 * dtau_eff).astype(
                f.dtype
            ) * action.noise_to_tangent(eta)

            new_links = action.apply_update(links, omega)
            if cooling:
                # gauge cooling after every Langevin step (SSS; exactly
                # gauge, so holomorphic observables are untouched)
                new_links = action.cool(
                    new_links, ndim, cfg.cooling_rate, cfg.cooling_steps
                )

            bad = ~jnp.all(
                jnp.isfinite(new_links), axis=tuple(range(1, new_links.ndim))
            )

            # observable samples the pre-update links (same convention as
            # the scalar integrators); frame-local sample SUM, merged per
            # frame in the epilogue (two-level accumulation, accum.py)
            plaq = action.mean_plaquette(links, ndim)
            ps_n = ps + plaq
            dmax_n = jnp.maximum(dmax, dnorm)

            u = unstable.reshape((C,) + (1,) * (new_links.ndim - 1))
            links = jnp.where(u, links, new_links)
            keep = lambda new, old: jnp.where(unstable, old, new)
            ps = keep(ps_n, ps)
            dmax = keep(dmax_n, dmax)
            unstable = unstable | bad
            return (links, ps, dmax, unstable)

        def pair_step(carry, _):
            *vals, step = carry
            e0, e1 = rng.normal_pair_for_shape(
                cfg.seed, rng.Stream.FIELD, step, noise_shape
            )
            vals = substep(tuple(vals), e0)
            vals = substep(vals, e1)
            return (*vals, step + 2), None

        init = (
            state.links, jnp.zeros_like(state.plaq_mean), state.drift_max,
            jnp.zeros((C,), bool), state.step,
        )
        carry, _ = lax.scan(pair_step, init, None, length=cfg.loops // 2)
        if cfg.loops % 2:
            *vals, step = carry
            e0, _ = rng.normal_pair_for_shape(
                cfg.seed, rng.Stream.FIELD, step, noise_shape
            )
            vals = substep(tuple(vals), e0)
            carry = (*vals, step + 1)
        links, ps, dmax, unstable, step_end = carry

        n_new = accum.runs_after(state.runs, cfg.loops)
        pm = accum.merge_frame_sum(state.plaq_mean, ps, cfg.loops, n_new)
        accept = ~unstable
        au = accept.reshape((C,) + (1,) * (links.ndim - 1))
        sel = lambda new, old: jnp.where(accept, new, old)
        grow = accept & (state.stab_cnt >= cfg.grow_after)
        dtau = jnp.where(
            grow,
            state.dtau / cfg.shrink,
            jnp.where(accept, state.dtau, state.dtau * cfg.shrink),
        )
        if cfg.dtau_max is not None:
            dtau = jnp.minimum(dtau, jnp.float32(cfg.dtau_max))
        new_state = GaugeState(
            links=jnp.where(au, links, state.links),
            plaq_mean=sel(pm, state.plaq_mean),
            drift_max=sel(dmax, state.drift_max),
            runs=accum.bump_runs(state.runs, cfg.loops, accept),
            dtau=dtau,
            stab_cnt=jnp.where(
                accept,
                jnp.where(state.stab_cnt >= cfg.grow_after, 0, state.stab_cnt + 1),
                0,
            ),
            step=step_end,
        )
        metrics = {
            "stable": accept,
            "dtau": dtau,
            "drift_max": dmax,
            # distance from the unitary submanifold (0 for compact groups;
            # the complex-Langevin health metric gauge cooling controls)
            "unitarity_norm": action.unitarity_norm(new_state.links, ndim),
        }
        return new_state, metrics

    return frame


@partial(jax.jit, static_argnames=("action", "cfg", "n_frames"))
def run_gauge_frames(state: GaugeState, action, cfg: GaugeConfig, n_frames: int):
    frame = make_gauge_frame_fn(action, cfg)
    return lax.scan(lambda s, _: frame(s), state, None, length=n_frames)


def reset_gauge_means(state: GaugeState) -> GaugeState:
    z = jnp.zeros_like(state.plaq_mean)
    return state._replace(plaq_mean=z, runs=jnp.zeros_like(state.runs))


def exact_plaquette_2d(group: str, beta):
    """Exact 2-D mean plaquette ⟨(1/N)ReTr U_p⟩ — or its analytic
    continuation ⟨(1/2N)(Tr U_p + Tr U_p⁻¹)⟩ for the complexified groups
    ("cu1"/"csu2"/"csu3" with complex β).

    In 2-D the plaquettes decouple (finite-volume corrections are
    exponentially small), so the answer is a one-plaquette group integral:
    I₁(β)/I₀(β) for U(1), I₂(β)/I₁(β) for SU(2) (character expansion), and
    for SU(3) the Weyl-measure eigenvalue integral

        ⟨(1/3)Σᵢcos θᵢ⟩ under dθ₁dθ₂ |Δ(e^{iθ})|² e^{(β/3)Σᵢ cos θᵢ},
        θ₃ = −θ₁−θ₂,

    evaluated numerically (trapezoid on a 512² periodic grid, accurate far
    below statistical test resolution; cross-checked against the SU(2)
    Bessel form by the tests).  For complex β the same integrals hold with
    a complex weight — the partition function is entire in β, so the
    trapezoid evaluation IS the analytic continuation (complex-Langevin
    expectation values must converge to it; tests/test_gauge_complex.py)."""
    if group in ("u1", "cu1"):
        if group == "u1":
            from scipy.special import iv

            return float(iv(1, beta) / iv(0, beta))
        return _bessel_ratio_complex(beta)
    if group in ("su2", "csu2"):
        if group == "su2":
            from scipy.special import iv

            return float(iv(2, beta) / iv(1, beta))
        return _weyl_plaquette_sun(2, complex(beta))
    if group in ("su3", "csu3"):
        v = _weyl_plaquette_sun(3, complex(beta) if group == "csu3" else beta)
        return v if group == "csu3" else float(np.real(v))
    raise KeyError(group)


def _bessel_ratio_complex(beta: complex) -> complex:
    """I₁(β)/I₀(β) for complex β via the integral representation
    I_n(β) = (1/π)∫₀^π e^{β cos θ} cos(nθ) dθ (periodic trapezoid —
    spectrally accurate)."""
    t = np.linspace(0.0, 2.0 * np.pi, 4096, endpoint=False)
    w = np.exp(beta * np.cos(t))
    return complex(np.sum(w * np.cos(t)) / np.sum(w))


def _weyl_plaquette_sun(n: int, beta, grid: int = 512):
    """⟨(1/N)ReTr U⟩ under dU e^{(β/N)ReTr U} on SU(N), N ∈ {2, 3}, via
    Weyl integration over the eigenvalue angles (periodic trapezoid grid).
    Complex β gives the analytic continuation (complex weight, same grid)."""
    t = np.linspace(0.0, 2.0 * np.pi, grid, endpoint=False)
    if n == 2:
        th = t  # θ, eigenvalues e^{±iθ}
        tr = 2.0 * np.cos(th)
        meas = np.sin(th) ** 2
        w = meas * np.exp((beta / 2.0) * (tr - 2.0))
        val = np.sum(tr / 2.0 * w) / np.sum(w)
    elif n == 3:
        t1 = t[:, None]
        t2 = t[None, :]
        t3 = -(t1 + t2)
        tr = np.cos(t1) + np.cos(t2) + np.cos(t3)
        # |Δ|² = Π_{i<j} |e^{iθ_i} − e^{iθ_j}|² = Π 4sin²((θ_i−θ_j)/2)
        d = (
            np.sin((t1 - t2) / 2.0) ** 2
            * np.sin((t1 - t3) / 2.0) ** 2
            * np.sin((t2 - t3) / 2.0) ** 2
        )
        w = d * np.exp((beta / 3.0) * (tr - 3.0))
        val = np.sum(tr / 3.0 * w) / np.sum(w)
    else:
        raise NotImplementedError(n)
    return complex(val) if np.iscomplexobj(np.asarray(beta)) else float(np.real(val))
