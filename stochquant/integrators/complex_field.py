"""Complex Langevin for D-dimensional scalar-field lattices.

Extends the 0-D ensemble / 1-D chain complex-Langevin machinery
(``integrators/complex_langevin.py``) to the periodic D-dim field lattices
of ``integrators/field.py`` — the "complex Langevin for the field lattices"
item this framework adds beyond the reference (which is real-action 1-D QM
only; the reference's numerical-fault-tolerance story, divergence detector +
adaptive Δτ in ``tauhost.c:523-545``, generalizes here to the drift-norm
step control the CL literature requires).

Model: holomorphic site potential V(z) on a complexified field
z(x) = φ_r(x) + i·φ_i(x), action

    S[z] = Σ_x a^D [ ½ Σ_μ ((z(x+μ̂)−z(x))/a)² + V(z(x)) ],  periodic,

drift density −(1/a^D)·δS/δz = ∇²z − V'(z), evolved with *real* noise on
the real part:

    z ← z + Δτ_eff·(∇²z − V'(z)) + √(2·Δτ_eff/a^D)·η,   η ~ N(0,1) real.

Safety machinery (same shape as the real-field frames):
* per-micro-step drift-norm control  Δτ_eff = Δτ·min(1, d₀/max_x‖drift‖);
* frame-level accept/reject with rollback + adaptive base Δτ;
* runaway detector on |z| (imaginary-direction excursions).

Known answer (tests/test_complex_field.py): for the complex Gaussian
V = ½σz², the site-resolved propagator is

    ⟨z_x²⟩ = (1/(V·a^D)) Σ_k 1/(k̂² + σ),   k̂² = Σ_μ (2−2cos k_μ a)/a².

State is split into real/imag float arrays (elementwise real math on both
planes; no complex dtypes in the update).
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
from stochquant.actions.complex_actions import ComplexAction
from stochquant.integrators import accum

__all__ = [
    "ComplexFieldConfig",
    "ComplexFieldState",
    "init_cfield_state",
    "make_cfield_frame_fn",
    "run_cfield_frames",
    "reset_cfield_means",
    "exact_gaussian_z2",
]


@dataclasses.dataclass(frozen=True)
class ComplexFieldConfig:
    """Complex-Langevin run on a periodic D-dim lattice."""

    action: str = "complex_gaussian"
    shape: Tuple[int, ...] = (32, 32)
    spacing: float = 1.0
    n_chains: int = 64
    dtau: float = 1e-3
    loops: int = 100
    frames: int = 100
    seed: int = 0
    noise_amp: float = 1.0
    drift_cap: float = 10.0     # d₀: cap on max-site ‖drift‖·Δτ_eff/Δτ
    clamp: float = 100.0        # |z| beyond this counts as a runaway
    shrink: float = 0.95
    grow_after: int = 10
    dtau_max: Optional[float] = None
    action_params: tuple = ()   # ((name, value), ...) for the registry

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def to_json(self) -> str:
        import json

        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ComplexFieldConfig":
        import json

        d = json.loads(s)
        d["shape"] = tuple(d["shape"])
        d["action_params"] = tuple(tuple(p) for p in d.get("action_params", ()))
        return cls(**d)


class ComplexFieldState(NamedTuple):
    zr: jax.Array          # (C, *shape) Re z
    zi: jax.Array          # (C, *shape) Im z
    z2r_mean: jax.Array    # (C,) running Re⟨z²⟩ (site-averaged)
    z2i_mean: jax.Array    # (C,) running Im⟨z²⟩
    zim_mean: jax.Array    # (C,) running ⟨|Im z|⟩ — CL "imaginary drift" health metric
    drift_max: jax.Array   # (C,) max site ‖drift‖ seen this run
    runs: jax.Array        # (C,) uint32
    dtau: jax.Array        # (C,)
    stab_cnt: jax.Array    # (C,) int32
    step: jax.Array        # () uint32


def init_cfield_state(cfg: ComplexFieldConfig) -> ComplexFieldState:
    C = cfg.n_chains
    shape = (C,) + tuple(cfg.shape)
    z = rng.normal_for_shape(cfg.seed, rng.Stream.INIT, 0, shape)
    zeros = jnp.zeros((C,), jnp.float32)
    return ComplexFieldState(
        zr=jnp.sqrt(jnp.float32(2.0 * cfg.dtau)) * z,
        zi=jnp.zeros(shape, jnp.float32),
        z2r_mean=zeros,
        z2i_mean=zeros,
        zim_mean=zeros,
        drift_max=zeros,
        runs=accum.init_runs(C),
        dtau=jnp.full((C,), cfg.dtau, jnp.float32),
        stab_cnt=jnp.zeros((C,), jnp.int32),
        step=jnp.uint32(1),
    )


def make_cfield_frame_fn(action: ComplexAction, cfg: ComplexFieldConfig):
    C = cfg.n_chains
    shape = tuple(cfg.shape)
    ndim = len(shape)
    a = cfg.spacing
    measure = a**ndim
    inv_a2 = jnp.float32(1.0 / (a * a))
    c_amp = jnp.float32(cfg.noise_amp)
    cap = jnp.float32(cfg.drift_cap)
    clamp = jnp.float32(cfg.clamp)
    lat_axes = tuple(range(1, ndim + 1))

    def lap(z):
        out = jnp.zeros_like(z)
        for d in lat_axes:
            out = out + (jnp.roll(z, 1, d) + jnp.roll(z, -1, d) - 2.0 * z)
        return out * inv_a2

    def frame(state: ComplexFieldState):
        def substep(carry, step, eta):
            zr, zi, z2r, z2i, zim, dmax, unstable = carry

            z = (zr + 1j * zi).astype(jnp.complex64)
            ds = action.dS(z)  # holomorphic site-potential derivative V'(z)
            drift_r = lap(zr) - jnp.real(ds).astype(jnp.float32)
            drift_i = lap(zi) - jnp.imag(ds).astype(jnp.float32)
            dnorm = jnp.max(
                jnp.sqrt(drift_r * drift_r + drift_i * drift_i), axis=lat_axes
            )  # (C,)

            scale = jnp.minimum(1.0, cap / jnp.maximum(dnorm, 1e-30))
            dtau_eff = (state.dtau * scale).reshape((C,) + (1,) * ndim)

            zr2 = zr + dtau_eff * drift_r + c_amp * jnp.sqrt(
                2.0 * dtau_eff / measure
            ) * eta
            zi2 = zi + dtau_eff * drift_i

            mod = jnp.sqrt(zr2 * zr2 + zi2 * zi2)
            bad = jnp.any(~jnp.isfinite(mod) | (mod > clamp), axis=lat_axes)

            # holomorphic observables of the pre-update field, site-averaged;
            # frame sums, merged per frame (two-level accumulation, accum.py)
            re_z2 = jnp.mean(zr * zr - zi * zi, axis=lat_axes)
            im_z2 = jnp.mean(2.0 * zr * zi, axis=lat_axes)
            abs_zi = jnp.mean(jnp.abs(zi), axis=lat_axes)
            z2r_n = z2r + re_z2
            z2i_n = z2i + im_z2
            zim_n = zim + abs_zi
            dmax_n = jnp.maximum(dmax, dnorm)

            u = unstable.reshape((C,) + (1,) * ndim)
            zr = jnp.where(u, zr, zr2)
            zi = jnp.where(u, zi, zi2)
            keep = lambda new, old: jnp.where(unstable, old, new)
            z2r = keep(z2r_n, z2r)
            z2i = keep(z2i_n, z2i)
            zim = keep(zim_n, zim)
            dmax = keep(dmax_n, dmax)
            unstable = unstable | bad
            return (zr, zi, z2r, z2i, zim, dmax, unstable)

        def pair_step(carry, _):
            *vals, step = carry
            e0, e1 = rng.normal_pair_for_shape(
                cfg.seed, rng.Stream.FIELD, step, (C,) + shape
            )
            vals = substep(tuple(vals), step, e0)
            vals = substep(vals, step + 1, e1)
            return (*vals, step + 2), None

        zc = jnp.zeros_like(state.z2r_mean)
        init = (
            state.zr, state.zi, zc, zc, zc,
            state.drift_max, jnp.zeros((C,), bool), state.step,
        )
        carry, _ = lax.scan(pair_step, init, None, length=cfg.loops // 2)
        if cfg.loops % 2:
            *vals, step = carry
            e0, _ = rng.normal_pair_for_shape(
                cfg.seed, rng.Stream.FIELD, step, (C,) + shape
            )
            vals = substep(tuple(vals), step, e0)
            carry = (*vals, step + 1)
        zr, zi, z2r, z2i, zim, dmax, unstable, step_end = carry

        n_new = accum.runs_after(state.runs, cfg.loops)
        z2r = accum.merge_frame_sum(state.z2r_mean, z2r, cfg.loops, n_new)
        z2i = accum.merge_frame_sum(state.z2i_mean, z2i, cfg.loops, n_new)
        zim = accum.merge_frame_sum(state.zim_mean, zim, cfg.loops, n_new)
        accept = ~unstable
        au = accept.reshape((C,) + (1,) * ndim)
        sel = lambda new, old: jnp.where(accept, new, old)
        grow = accept & (state.stab_cnt >= cfg.grow_after)
        dtau = jnp.where(
            grow,
            state.dtau / cfg.shrink,
            jnp.where(accept, state.dtau, state.dtau * cfg.shrink),
        )
        if cfg.dtau_max is not None:
            dtau = jnp.minimum(dtau, jnp.float32(cfg.dtau_max))
        new_state = ComplexFieldState(
            zr=jnp.where(au, zr, state.zr),
            zi=jnp.where(au, zi, state.zi),
            z2r_mean=sel(z2r, state.z2r_mean),
            z2i_mean=sel(z2i, state.z2i_mean),
            zim_mean=sel(zim, state.zim_mean),
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
        metrics = {"stable": accept, "dtau": dtau, "drift_max": dmax}
        return new_state, metrics

    return frame


@partial(jax.jit, static_argnames=("action", "cfg", "n_frames"))
def run_cfield_frames(
    state: ComplexFieldState,
    action: ComplexAction,
    cfg: ComplexFieldConfig,
    n_frames: int,
):
    frame = make_cfield_frame_fn(action, cfg)
    return lax.scan(lambda s, _: frame(s), state, None, length=n_frames)


def reset_cfield_means(state: ComplexFieldState) -> ComplexFieldState:
    z = jnp.zeros_like(state.z2r_mean)
    return state._replace(
        z2r_mean=z, z2i_mean=z, zim_mean=z, runs=jnp.zeros_like(state.runs)
    )


def exact_gaussian_z2(shape, spacing, sigma) -> complex:
    """Exact site propagator ⟨z_x²⟩ of the complex free field:
    (1/(V·a^D))·Σ_k 1/(k̂² + σ)."""
    khat2 = np.zeros(shape)
    for d, L in enumerate(shape):
        k = 2.0 * np.pi * np.arange(L) / L
        kh = (2.0 - 2.0 * np.cos(k)) / spacing**2
        sh = [1] * len(shape)
        sh[d] = L
        khat2 = khat2 + kh.reshape(sh)
    # (1/(V·a^D))·Σ_k = mean_k / a^D
    return complex(np.mean(1.0 / (khat2 + sigma)) / spacing ** len(shape))
