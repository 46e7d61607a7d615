"""Complex Langevin for complex-action models (BASELINE.json config 5).

For a holomorphic action S(z) the CL update complexifies the variable
z = x + iy and evolves

    z ← z − Δτ_eff·∂S/∂z + √(2·Δτ_eff)·η,   η real N(0,1),

whose stationary expectation values of holomorphic observables reproduce the
complex-weight averages ∫O·e^{−S} (when the process stays bounded).  Two
safety mechanisms the literature requires, built here on the same machinery
as the real integrators:

* **per-step drift-norm control**: Δτ_eff = Δτ·min(1, d₀/‖∂S‖) caps the
  step whenever the drift spikes (runaway excursions into the imaginary
  direction) — the reference's numerical-fault-tolerance story (divergence
  detector + shrink, tauhost.c:523-545) generalized to complex dynamics;
* **frame-level accept/reject + adaptive base Δτ**: identical semantics to
  the real-field frames (rollback, ×shrink on trip, growth after
  `grow_after` stable frames).

State is stored as separate real/imag float arrays (elementwise real math
on both planes; no complex dtypes in the update).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from stochquant import rng
from stochquant.actions.complex_actions import ComplexAction
from stochquant.integrators import accum

__all__ = [
    "ComplexLangevinConfig",
    "CLState",
    "init_cl_state",
    "run_cl_frames",
]


@dataclasses.dataclass(frozen=True)
class ComplexLangevinConfig:
    action: str = "complex_gaussian"
    n_chains: int = 1024
    dtau: float = 1e-3
    loops: int = 100
    frames: int = 100
    seed: int = 0
    noise_amp: float = 1.0
    drift_cap: float = 10.0     # d₀: |drift|·Δτ above this rescales the step
    clamp: float = 100.0        # |z| excursion treated as a runaway
    shrink: float = 0.95
    grow_after: int = 10
    dtau_max: Optional[float] = None
    action_params: tuple = ()   # ((name, value), ...) for the registry

    def to_json(self) -> str:
        import json

        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ComplexLangevinConfig":
        import json

        d = json.loads(s)
        d["action_params"] = tuple(tuple(p) for p in d.get("action_params", ()))
        return cls(**d)


class CLState(NamedTuple):
    zr: jax.Array        # (C,) Re z
    zi: jax.Array        # (C,) Im z
    z2r_mean: jax.Array  # (C,) running Re⟨z²⟩
    z2i_mean: jax.Array  # (C,) running Im⟨z²⟩
    zr_mean: jax.Array   # (C,) running Re⟨z⟩
    zi_mean: jax.Array   # (C,) running Im⟨z⟩
    drift_max: jax.Array  # (C,) max |∂S| seen this run (the CL health metric)
    runs: jax.Array
    dtau: jax.Array
    stab_cnt: jax.Array
    step: jax.Array


def init_cl_state(cfg: ComplexLangevinConfig) -> CLState:
    C = cfg.n_chains
    z = rng.normal_for_shape(cfg.seed, rng.Stream.INIT, 0, (C, 1))[:, 0]
    zeros = jnp.zeros((C,), jnp.float32)
    return CLState(
        zr=jnp.sqrt(jnp.float32(2.0 * cfg.dtau)) * z,
        zi=zeros,
        z2r_mean=zeros,
        z2i_mean=zeros,
        zr_mean=zeros,
        zi_mean=zeros,
        drift_max=zeros,
        runs=accum.init_runs(C),
        dtau=jnp.full((C,), cfg.dtau, jnp.float32),
        stab_cnt=jnp.zeros((C,), jnp.int32),
        step=jnp.uint32(1),
    )


def make_cl_frame_fn(action: ComplexAction, cfg: ComplexLangevinConfig):
    C = cfg.n_chains
    chain_ids = jnp.arange(C, dtype=jnp.uint32)
    c_amp = jnp.float32(cfg.noise_amp)
    cap = jnp.float32(cfg.drift_cap)
    clamp = jnp.float32(cfg.clamp)

    def frame(state: CLState):
        def micro(carry, _):
            zr, zi, z2r, z2i, zrm, zim, dmax, unstable, step = carry

            z = zr + 1j * zi.astype(jnp.complex64)
            ds = action.dS(z)
            dsr = jnp.real(ds).astype(jnp.float32)
            dsi = jnp.imag(ds).astype(jnp.float32)
            dnorm = jnp.sqrt(dsr * dsr + dsi * dsi)

            # drift-norm step control: keep |drift|·Δτ_eff ≤ drift_cap·Δτ
            scale = jnp.minimum(1.0, cap / jnp.maximum(dnorm, 1e-30))
            dtau_eff = state.dtau * scale

            eta = rng.normal(
                cfg.seed, rng.Stream.FIELD, chain_ids, jnp.uint32(0), step
            )
            amp = c_amp * jnp.sqrt(2.0 * dtau_eff)
            zr2 = zr - dtau_eff * dsr + amp * eta
            zi2 = zi - dtau_eff * dsi

            bad = (
                ~jnp.isfinite(zr2)
                | ~jnp.isfinite(zi2)
                | (jnp.sqrt(zr2 * zr2 + zi2 * zi2) > clamp)
            )

            # holomorphic observables of the pre-update variable — frame
            # sums, merged per frame (two-level accumulation, accum.py)
            re_z2 = zr * zr - zi * zi
            im_z2 = 2.0 * zr * zi
            z2r_n = z2r + re_z2
            z2i_n = z2i + im_z2
            zrm_n = zrm + zr
            zim_n = zim + zi
            dmax_n = jnp.maximum(dmax, dnorm)

            keep = lambda new, old: jnp.where(unstable, old, new)
            zr = keep(zr2, zr)
            zi = keep(zi2, zi)
            z2r = keep(z2r_n, z2r)
            z2i = keep(z2i_n, z2i)
            zrm = keep(zrm_n, zrm)
            zim = keep(zim_n, zim)
            dmax = keep(dmax_n, dmax)
            unstable = unstable | bad
            return (zr, zi, z2r, z2i, zrm, zim, dmax, unstable, step + 1), None

        zc = jnp.zeros_like(state.z2r_mean)
        init = (
            state.zr, state.zi, zc, zc, zc, zc, state.drift_max,
            jnp.zeros((C,), bool), state.step,
        )
        (zr, zi, z2r, z2i, zrm, zim, dmax, unstable, step_end), _ = lax.scan(
            micro, init, None, length=cfg.loops
        )

        n_new = accum.runs_after(state.runs, cfg.loops)
        z2r = accum.merge_frame_sum(state.z2r_mean, z2r, cfg.loops, n_new)
        z2i = accum.merge_frame_sum(state.z2i_mean, z2i, cfg.loops, n_new)
        zrm = accum.merge_frame_sum(state.zr_mean, zrm, cfg.loops, n_new)
        zim = accum.merge_frame_sum(state.zi_mean, zim, cfg.loops, n_new)
        accept = ~unstable
        sel = lambda new, old: jnp.where(accept, new, old)
        new_state = CLState(
            zr=sel(zr, state.zr),
            zi=sel(zi, state.zi),
            z2r_mean=sel(z2r, state.z2r_mean),
            z2i_mean=sel(z2i, state.z2i_mean),
            zr_mean=sel(zrm, state.zr_mean),
            zi_mean=sel(zim, state.zi_mean),
            drift_max=sel(dmax, state.drift_max),
            runs=accum.bump_runs(state.runs, cfg.loops, accept),
            dtau=_adapt_dtau(state, accept, cfg),
            stab_cnt=jnp.where(
                accept,
                jnp.where(state.stab_cnt >= cfg.grow_after, 0, state.stab_cnt + 1),
                0,
            ),
            step=step_end,
        )
        metrics = {
            "stable": accept,
            "dtau": new_state.dtau,
            "drift_max": dmax,
        }
        return new_state, metrics

    return frame


def _adapt_dtau(state: CLState, accept, cfg: ComplexLangevinConfig):
    grow = accept & (state.stab_cnt >= cfg.grow_after)
    dtau = jnp.where(
        grow,
        state.dtau / cfg.shrink,
        jnp.where(accept, state.dtau, state.dtau * cfg.shrink),
    )
    if cfg.dtau_max is not None:
        dtau = jnp.minimum(dtau, jnp.float32(cfg.dtau_max))
    return dtau


@partial(jax.jit, static_argnames=("action", "cfg", "n_frames"))
def run_cl_frames(state: CLState, action: ComplexAction, cfg: ComplexLangevinConfig, n_frames: int):
    frame = make_cl_frame_fn(action, cfg)
    return lax.scan(lambda s, _: frame(s), state, None, length=n_frames)


@dataclasses.dataclass(frozen=True)
class ComplexChainConfig:
    """Complex Langevin for a 1-D Euclidean-time chain with a holomorphic
    site potential: S = Σ_i Δt[ (m/2)((z_{i+1}−z_i)/Δt)² + V(z_i) ],
    periodic BCs.  The complexified field z(t) = x(t) + i·y(t) evolves with
    drift m∇²z/Δt² − V'(z) and real noise √(2Δτ/Δt)·η on the real part."""

    action: str = "complex_gaussian"
    n_sites: int = 32
    dt: float = 0.25
    mass: float = 1.0
    n_chains: int = 256
    dtau: float = 1e-3
    loops: int = 100
    frames: int = 100
    seed: int = 0
    noise_amp: float = 1.0
    drift_cap: float = 10.0
    clamp: float = 100.0
    shrink: float = 0.95
    grow_after: int = 10
    dtau_max: Optional[float] = None

    def to_json(self) -> str:
        import json

        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ComplexChainConfig":
        import json

        return cls(**json.loads(s))


class ComplexChainState(NamedTuple):
    zr: jax.Array         # (C, N)
    zi: jax.Array         # (C, N)
    z2r_mean: jax.Array   # (C, N) running Re⟨z_i²⟩
    z2i_mean: jax.Array   # (C, N) running Im⟨z_i²⟩
    drift_max: jax.Array  # (C,)
    runs: jax.Array
    dtau: jax.Array
    stab_cnt: jax.Array
    step: jax.Array


def init_ccl_state(cfg: ComplexChainConfig) -> ComplexChainState:
    C, N = cfg.n_chains, cfg.n_sites
    z = rng.normal_for_shape(cfg.seed, rng.Stream.INIT, 0, (C, N))
    zeros = jnp.zeros((C, N), jnp.float32)
    return ComplexChainState(
        zr=jnp.sqrt(jnp.float32(2.0 * cfg.dtau)) * z,
        zi=zeros,
        z2r_mean=zeros,
        z2i_mean=zeros,
        drift_max=jnp.zeros((C,), jnp.float32),
        runs=accum.init_runs(C),
        dtau=jnp.full((C,), cfg.dtau, jnp.float32),
        stab_cnt=jnp.zeros((C,), jnp.int32),
        step=jnp.uint32(1),
    )


def make_ccl_frame_fn(action: ComplexAction, cfg: ComplexChainConfig):
    C, N = cfg.n_chains, cfg.n_sites
    c_amp = jnp.float32(cfg.noise_amp)
    cap = jnp.float32(cfg.drift_cap)
    clamp = jnp.float32(cfg.clamp)
    inv_dt2 = jnp.float32(cfg.mass / (cfg.dt * cfg.dt))

    def lap(z):
        return (jnp.roll(z, 1, -1) + jnp.roll(z, -1, -1) - 2.0 * z) * inv_dt2

    def frame(state: ComplexChainState):
        def substep(carry, step, eta):
            zr, zi, z2r, z2i, dmax, unstable = carry

            z = (zr + 1j * zi).astype(jnp.complex64)
            ds = action.dS(z)  # holomorphic site-potential derivative
            drift_r = lap(zr) - jnp.real(ds).astype(jnp.float32)
            drift_i = lap(zi) - jnp.imag(ds).astype(jnp.float32)
            dnorm = jnp.max(
                jnp.sqrt(drift_r * drift_r + drift_i * drift_i), axis=-1
            )  # (C,)

            scale = jnp.minimum(1.0, cap / jnp.maximum(dnorm, 1e-30))
            dtau_eff = (state.dtau * scale)[:, None]

            zr2 = zr + dtau_eff * drift_r + c_amp * jnp.sqrt(
                2.0 * dtau_eff / cfg.dt
            ) * eta
            zi2 = zi + dtau_eff * drift_i

            mod = jnp.sqrt(zr2 * zr2 + zi2 * zi2)
            bad = jnp.any(~jnp.isfinite(mod) | (mod > clamp), axis=-1)

            # frame sums (two-level accumulation, accum.py)
            re_z2 = zr * zr - zi * zi
            im_z2 = 2.0 * zr * zi
            z2r_n = z2r + re_z2
            z2i_n = z2i + im_z2
            dmax_n = jnp.maximum(dmax, dnorm)

            u = unstable[:, None]
            keep = lambda new, old: jnp.where(u, old, new)
            zr = keep(zr2, zr)
            zi = keep(zi2, zi)
            z2r = keep(z2r_n, z2r)
            z2i = keep(z2i_n, z2i)
            dmax = jnp.where(unstable, dmax, dmax_n)
            unstable = unstable | bad
            return (zr, zi, z2r, z2i, dmax, unstable)

        def pair_step(carry, _):
            *vals, step = carry
            e0, e1 = rng.normal_pair_for_shape(
                cfg.seed, rng.Stream.FIELD, step, (C, N)
            )
            vals = substep(tuple(vals), step, e0)
            vals = substep(vals, step + 1, e1)
            return (*vals, step + 2), None

        init = (
            state.zr, state.zi, jnp.zeros_like(state.z2r_mean),
            jnp.zeros_like(state.z2i_mean),
            state.drift_max, jnp.zeros((C,), bool), state.step,
        )
        carry, _ = lax.scan(pair_step, init, None, length=cfg.loops // 2)
        if cfg.loops % 2:
            *vals, step = carry
            e0, _ = rng.normal_pair_for_shape(
                cfg.seed, rng.Stream.FIELD, step, (C, N)
            )
            vals = substep(tuple(vals), step, e0)
            carry = (*vals, step + 1)
        zr, zi, z2r, z2i, dmax, unstable, step_end = carry

        n_new = accum.runs_after(state.runs, cfg.loops)[:, None]
        z2r = accum.merge_frame_sum(state.z2r_mean, z2r, cfg.loops, n_new)
        z2i = accum.merge_frame_sum(state.z2i_mean, z2i, cfg.loops, n_new)
        accept = ~unstable
        a1 = accept[:, None]
        sel2 = lambda new, old: jnp.where(a1, new, old)
        sel1 = lambda new, old: jnp.where(accept, new, old)
        new_state = ComplexChainState(
            zr=sel2(zr, state.zr),
            zi=sel2(zi, state.zi),
            z2r_mean=sel2(z2r, state.z2r_mean),
            z2i_mean=sel2(z2i, state.z2i_mean),
            drift_max=sel1(dmax, state.drift_max),
            runs=accum.bump_runs(state.runs, cfg.loops, accept),
            dtau=_adapt_dtau(state, accept, cfg),
            stab_cnt=jnp.where(
                accept,
                jnp.where(state.stab_cnt >= cfg.grow_after, 0, state.stab_cnt + 1),
                0,
            ),
            step=step_end,
        )
        metrics = {"stable": accept, "dtau": new_state.dtau, "drift_max": dmax}
        return new_state, metrics

    return frame


@partial(jax.jit, static_argnames=("action", "cfg", "n_frames"))
def run_ccl_frames(
    state: ComplexChainState, action: ComplexAction, cfg: ComplexChainConfig, n_frames: int
):
    frame = make_ccl_frame_fn(action, cfg)
    return lax.scan(lambda s, _: frame(s), state, None, length=n_frames)


def reset_ccl_means(state: ComplexChainState) -> ComplexChainState:
    z = jnp.zeros_like(state.z2r_mean)
    return state._replace(z2r_mean=z, z2i_mean=z, runs=jnp.zeros_like(state.runs))


def z2_estimate(state: CLState):
    """Ensemble ⟨z²⟩ as a complex number (mean over chains)."""
    import numpy as np

    return complex(
        np.asarray(state.z2r_mean).mean(), np.asarray(state.z2i_mean).mean()
    )


def reset_cl_means(state: CLState) -> CLState:
    z = jnp.zeros_like(state.z2r_mean)
    return state._replace(
        z2r_mean=z, z2i_mean=z, zr_mean=z, zi_mean=z,
        runs=jnp.zeros_like(state.runs),
    )
