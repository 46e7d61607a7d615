"""Euler–Maruyama Langevin integrator for D-dimensional scalar fields.

The reference is strictly 1-D QM; this is the scale-out axis of this
build (BASELINE.json configs 3–4: 2-D 256² and 4-D 32⁴ φ⁴).  Same frame
machinery as integrators/langevin.py — micro-step scan, per-chain adaptive
Δτ with exact rollback, on-line observables — but over periodic D-dim
lattices with the field-theory observable set (magnetization,
susceptibility, action density, time-slice correlator).

Update (site measure w = a^D):

    φ += Δτ·( ∇²φ − V'(φ) ) + c·√(2Δτ/a^D)·η.

The stencil is plain ``jnp.roll``: under a sharded-lattice `jax.sharding`
layout XLA's SPMD partitioner lowers it to neighbour collective-permutes
(halo exchange) automatically; parallel/halo.py provides the explicit
shard_map/ppermute version of the same math for manual control.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from stochquant import rng
from stochquant.actions.phi4 import FieldAction
from stochquant.config import FieldConfig, Scheme, Sweep
from stochquant.integrators import accum


def checkerboard_mask(shape, ndim, dtype=bool):
    """(1, *shape) mask, True on 'even' sites ((Σ coords) % 2 == 0)."""
    full = (1,) + tuple(shape)
    s = jnp.zeros(full, jnp.int32)
    for d in range(1, ndim + 1):
        s = s + lax.broadcasted_iota(jnp.int32, full, d)
    return (s % 2 == 0).astype(dtype) if dtype is not bool else (s % 2 == 0)

__all__ = [
    "FieldState",
    "init_field_state",
    "make_field_frame_fn",
    "run_field_frames",
    "susceptibility",
    "binder_cumulant",
    "reset_field_means",
]


class FieldState(NamedTuple):
    phi: jax.Array        # (C, *shape)
    mag_mean: jax.Array   # (C,) running ⟨M⟩,  M = (1/V)Σφ
    mag2_mean: jax.Array  # (C,) running ⟨M²⟩
    mag4_mean: jax.Array  # (C,) running ⟨M⁴⟩ — Binder cumulant / criticality
    absmag_mean: jax.Array  # (C,) running ⟨|M|⟩
    phi2_mean: jax.Array  # (C,) running ⟨φ²⟩ (site-averaged)
    act_mean: jax.Array   # (C,) running ⟨s⟩ action density (site-averaged)
    corr_mean: jax.Array  # (C, L0) running ⟨s̄(t)·s̄(0)⟩, s̄ = slice mean
    runs: jax.Array       # (C, 2) uint32 (lo, hi) 64-bit pair (accum.init_runs)
    dtau: jax.Array       # (C,)
    stab_cnt: jax.Array   # (C,) int32
    lrg_vl: jax.Array     # (C,)
    step: jax.Array       # () uint32


def init_field_state(cfg: FieldConfig) -> FieldState:
    C = cfg.n_chains
    dtype = cfg.jdtype
    shape = (C,) + tuple(cfg.shape)
    z = rng.normal_for_shape(
        cfg.seed, rng.Stream.INIT, 0, shape, rounds=rng.rounds_of(cfg.rng_impl)
    ).astype(dtype)
    phi = jnp.sqrt(jnp.asarray(2.0 * cfg.dtau, dtype)) * z
    zc = jnp.zeros((C,), dtype)
    return FieldState(
        phi=phi,
        mag_mean=zc,
        mag2_mean=zc,
        mag4_mean=zc,
        absmag_mean=zc,
        phi2_mean=zc,
        act_mean=zc,
        corr_mean=jnp.zeros((C, cfg.shape[0]), dtype),
        runs=accum.init_runs(C),
        dtau=jnp.full((C,), cfg.dtau, dtype),
        stab_cnt=jnp.zeros((C,), jnp.int32),
        lrg_vl=jnp.max(jnp.abs(phi), axis=tuple(range(1, phi.ndim))),
        step=jnp.uint32(1),
    )


def _exact_field_check(action: FieldAction, cfg: FieldConfig) -> None:
    if not hasattr(action, "m2"):
        raise ValueError(
            "Scheme.EXACT needs the action's Gaussian curvature (an `m2` "
            f"attribute) to split the propagator; action {cfg.action!r} "
            "declares none — use Scheme.EM"
        )
    if not float(action.m2) > 0.0:
        # m² <= 0 (the broken-symmetry phase): B̂(k) crosses zero, the OU
        # 'decay' e^{−B̂Δτ} amplifies the soft modes and the exact-variance
        # formula has no stationary limit — the Gaussian split is simply
        # not a contraction there.  Refuse loudly instead of silently
        # mis-propagating (r5 review finding).
        raise ValueError(
            "Scheme.EXACT requires a positive Gaussian curvature "
            f"(action.m2 = {float(action.m2)!r}): with m2 <= 0 the free "
            "propagator amplifies the soft modes and the exponential "
            "split is invalid — use Scheme.EM/HEUN for the broken phase"
        )
    if cfg.sweep != Sweep.SYNC:
        raise ValueError("Scheme.EXACT uses the synchronous (SYNC) sweep")
    if cfg.mesh_axes is not None:
        raise ValueError(
            "Scheme.EXACT runs single-program (rfftn over the full "
            "lattice); use mesh_axes=None"
        )


def _exact_field_mode_ops(action: FieldAction, cfg: FieldConfig, dtau):
    """Per-Fourier-mode exact-OU factors ``(decay, svar)`` on the rfftn
    grid (r4 — the 2-D/D-dim free-field analog of ChainConfig's
    Scheme.EXACT; ROADMAP item).

    The free drift dφ/dτ = (∇² − m²)φ + √(2c²/aᴰ)·ξ diagonalizes per mode:
    B̂(k) = (2/a²)·Σ_d(1 − cos k_d) + m², so one step of the exact
    transition is φ̂ ← e^{−B̂Δτ}φ̂ + ζ̂ with Var ζ = (c²/aᴰ)(1−e^{−2B̂Δτ})/B̂
    — zero integration bias at ANY Δτ, unconditionally stable.  A massless
    zero mode gets its diffusive limit 2Δτ·c²/aᴰ.  ``dtau`` is the
    per-chain (C,) array (resume-safe, ADVICE r3)."""
    shape = tuple(cfg.shape)
    ndim = len(shape)
    dtype = cfg.jdtype
    a = cfg.spacing
    measure = a**ndim
    rshape = shape[:-1] + (shape[-1] // 2 + 1,)
    bhat = jnp.zeros(rshape, dtype)
    for d in range(ndim):
        n = shape[d]
        k = jnp.fft.rfftfreq(n) if d == ndim - 1 else jnp.fft.fftfreq(n)
        k = (2.0 * np.pi) * k.astype(dtype)
        kshape = [1] * ndim
        kshape[d] = rshape[d]
        bhat = bhat + (2.0 / (a * a)) * (1.0 - jnp.cos(k.reshape(kshape)))
    bhat = bhat + jnp.asarray(action.m2, dtype)
    c2m = jnp.asarray(cfg.noise_amp**2 / measure, dtype)
    dt = jnp.asarray(dtau, dtype).reshape((-1,) + (1,) * ndim)
    decay = jnp.exp(-bhat[None] * dt)
    svar = jnp.where(
        bhat[None] > 1e-8,
        c2m * (1.0 - decay * decay) / jnp.maximum(bhat[None], 1e-8),
        2.0 * dt * c2m,
    )
    # ETD1 drift weight Δτ·φ₁(−B̂Δτ) = (1 − e^{−B̂Δτ})/B̂ for the explicit
    # non-Gaussian remainder (r5 interacting extension; → Δτ as B̂ → 0)
    coef = jnp.where(
        bhat[None] > 1e-8,
        (1.0 - decay) / jnp.maximum(bhat[None], 1e-8),
        dt * jnp.ones_like(decay),
    )
    return decay, jnp.sqrt(svar), coef


def make_field_frame_fn(action: FieldAction, cfg: FieldConfig):
    C = cfg.n_chains
    shape = tuple(cfg.shape)
    ndim = len(shape)
    dtype = cfg.jdtype
    a = cfg.spacing
    measure = a**ndim
    c_amp = jnp.asarray(cfg.noise_amp, dtype)
    clamp = jnp.asarray(cfg.clamp, dtype)
    lat_axes = tuple(range(1, ndim + 1))
    nonzero_axes = tuple(range(2, ndim + 1))  # lattice axes except dim 0
    checkerboard = cfg.sweep == Sweep.CHECKERBOARD
    even = checkerboard_mask(shape, ndim) if checkerboard else None
    exact_scheme = getattr(cfg, "scheme", Scheme.EM) == Scheme.EXACT
    if exact_scheme:
        _exact_field_check(action, cfg)
    # free actions keep the pure exact-OU step (zero bias at ANY Δτ);
    # interacting ones get the r5 exponential integrator — exact Gaussian
    # propagation + explicit ETD1 treatment of dV_int (unconditionally
    # stable in the stiff linear part, O(Δτ) bias in the coupling only)
    from stochquant.actions.phi4 import FreeField as _FreeField

    exact_interacting = exact_scheme and not isinstance(action, _FreeField)

    def frame(state: FieldState):
        dtau_b = lambda: state.dtau.reshape((C,) + (1,) * ndim)
        if exact_scheme:
            decay_k, svar_k, coef_k = _exact_field_mode_ops(
                action, cfg, state.dtau
            )

        def em_apply(phi, mask, noise):
            """EM update applied on `mask` sites (None = all), reading the
            current phi for the stencil; returns (new phi, |det|, finite)."""
            det = action.drift(phi, a, ndim).astype(dtype) * dtau_b()
            new_raw = phi + det + noise
            newphi = jnp.clip(new_raw, -clamp, clamp)
            newphi = jnp.where(jnp.isfinite(new_raw), newphi, clamp)
            if mask is not None:
                newphi = jnp.where(mask, newphi, phi)
                det = jnp.where(mask, det, 0.0)
                fin = jnp.isfinite(new_raw) | ~mask
            else:
                fin = jnp.isfinite(new_raw)
            return newphi, jnp.abs(det), fin

        def micro_step(carry, eta):
            phi, ms, m2s, m4s, ams, p2s, acs, cs, unstable, lrgvl, step = carry

            if exact_scheme:
                # exact OU transition per Fourier mode: φ ← F⁻¹[decay·Fφ]
                # + F⁻¹[√var·Fη] — the unnormalized-transform sandwich IS
                # the operator functional calculus, so the normalization
                # cancels; unconditionally stable, only non-finite trips.
                # Interacting actions add the ETD1 correction
                # F⁻¹[φ₁-weight · F[−dV_int(φ)]], with the EM path's
                # clamp + |correction|-vs-lrg_vl detector (the nonlinear
                # part CAN still run away; the Gaussian part cannot).
                ph = jnp.fft.rfftn(phi, axes=lat_axes)
                eh = jnp.fft.rfftn(eta, axes=lat_axes)
                noise = jnp.fft.irfftn(
                    svar_k.astype(ph.dtype) * eh, s=shape, axes=lat_axes
                ).astype(dtype)
                lin = jnp.fft.irfftn(
                    decay_k.astype(ph.dtype) * ph, s=shape, axes=lat_axes
                ).astype(dtype)
                if exact_interacting:
                    g = -action.dV_int(phi).astype(dtype)
                    gh = jnp.fft.rfftn(g, axes=lat_axes)
                    corr = jnp.fft.irfftn(
                        coef_k.astype(gh.dtype) * gh, s=shape, axes=lat_axes
                    ).astype(dtype)
                    new_raw = lin + corr + noise
                    newphi = jnp.clip(new_raw, -clamp, clamp)
                    newphi = jnp.where(jnp.isfinite(new_raw), newphi, clamp)
                    absdet = jnp.abs(corr)
                    absdet = jnp.where(
                        jnp.isfinite(new_raw), absdet, jnp.inf
                    )
                    max_det = jnp.max(absdet, axis=lat_axes)
                    bad = ~jnp.all(jnp.isfinite(new_raw), axis=lat_axes)
                    tripped = (max_det > lrgvl) | bad
                else:
                    newphi = lin + noise
                    fin = jnp.isfinite(newphi)
                    max_det = jnp.zeros((C,), dtype)
                    bad = ~jnp.all(fin, axis=lat_axes)
                    tripped = bad
            else:
                noise = c_amp * jnp.sqrt(2.0 * state.dtau / measure).reshape(
                    (C,) + (1,) * ndim
                ) * eta

                if checkerboard:
                    # even half-sweep, then odd sites see the fresh even
                    # values
                    phi_e, absdet_e, fin_e = em_apply(phi, even, noise)
                    newphi, absdet_o, fin_o = em_apply(phi_e, ~even, noise)
                    absdet = jnp.maximum(absdet_e, absdet_o)
                    fin = fin_e & fin_o
                else:
                    newphi, absdet, fin = em_apply(phi, None, noise)

                max_det = jnp.max(absdet, axis=lat_axes)
                bad = ~jnp.all(fin, axis=lat_axes)
                tripped = (max_det > lrgvl) | bad

            # observables sample the pre-update field
            mag = jnp.mean(phi, axis=lat_axes)
            phi2 = jnp.mean(phi * phi, axis=lat_axes)
            act_d = jnp.mean(
                action.action_density(phi, a, ndim).astype(dtype), axis=lat_axes
            )
            s_slice = jnp.mean(phi, axis=nonzero_axes)  # (C, L0)
            corr = s_slice * s_slice[:, :1]

            # frame-local sample sums; merged once per frame in the epilogue
            # (two-level accumulation, integrators/accum.py)
            mag2 = mag * mag
            ms2 = ms + mag
            m2s2 = m2s + mag2
            m4s2 = m4s + mag2 * mag2
            ams2 = ams + jnp.abs(mag)
            p2s2 = p2s + phi2
            acs2 = acs + act_d
            cs2 = cs + corr

            lrgvl2 = jnp.maximum(lrgvl, jnp.max(jnp.abs(newphi), axis=lat_axes))

            u = unstable.reshape((C,) + (1,) * ndim)
            phi = jnp.where(u, phi, newphi)
            keep = lambda new, old: jnp.where(unstable, old, new)
            ms = keep(ms2, ms)
            m2s = keep(m2s2, m2s)
            m4s = keep(m4s2, m4s)
            ams = keep(ams2, ams)
            p2s = keep(p2s2, p2s)
            acs = keep(acs2, acs)
            cs = jnp.where(unstable[:, None], cs, cs2)
            lrgvl = keep(lrgvl2, lrgvl)
            unstable = unstable | tripped
            return (phi, ms, m2s, m4s, ams, p2s, acs, cs, unstable, lrgvl, step + 1)

        def pair_step(carry, _):
            # two micro-steps per Threefry draw (both Box–Muller outputs)
            step = carry[-1]
            e0, e1 = rng.normal_pair_for_shape(
                cfg.seed, rng.Stream.FIELD, step, (C,) + shape,
                rounds=rng.rounds_of(cfg.rng_impl),
            )
            carry = micro_step(carry, e0.astype(dtype))
            carry = micro_step(carry, e1.astype(dtype))
            return carry, None

        zc = jnp.zeros((C,), dtype)
        init = (
            state.phi,
            zc,  # frame Σ M
            zc,  # frame Σ M²
            zc,  # frame Σ M⁴
            zc,  # frame Σ |M|
            zc,  # frame Σ φ²
            zc,  # frame Σ s
            jnp.zeros_like(state.corr_mean),  # frame Σ corr
            jnp.zeros((C,), bool),
            state.lrg_vl,
            state.step,
        )
        carry, _ = lax.scan(pair_step, init, None, length=cfg.loops // 2)
        if cfg.loops % 2:
            e0, _ = rng.normal_pair_for_shape(
                cfg.seed, rng.Stream.FIELD, carry[-1], (C,) + shape,
                rounds=rng.rounds_of(cfg.rng_impl),
            )
            carry = micro_step(carry, e0.astype(dtype))
        phi, ms, m2s, m4s, ams, p2s, acs, cs, unstable, lrgvl, step_end = carry

        accept = ~unstable
        au = accept.reshape((C,) + (1,) * ndim)
        phi = jnp.where(au, phi, state.phi)
        # merge frame sums into the running means (two-level accumulation)
        n_new = accum.runs_after(state.runs, cfg.loops).astype(dtype)
        mm = accum.merge_frame_sum(state.mag_mean, ms, cfg.loops, n_new)
        m2m = accum.merge_frame_sum(state.mag2_mean, m2s, cfg.loops, n_new)
        m4m = accum.merge_frame_sum(state.mag4_mean, m4s, cfg.loops, n_new)
        amm = accum.merge_frame_sum(state.absmag_mean, ams, cfg.loops, n_new)
        p2m = accum.merge_frame_sum(state.phi2_mean, p2s, cfg.loops, n_new)
        am = accum.merge_frame_sum(state.act_mean, acs, cfg.loops, n_new)
        cm = accum.merge_frame_sum(state.corr_mean, cs, cfg.loops, n_new[:, None])
        sel = lambda new, old: jnp.where(accept, new, old)
        mm = sel(mm, state.mag_mean)
        m2m = sel(m2m, state.mag2_mean)
        m4m = sel(m4m, state.mag4_mean)
        amm = sel(amm, state.absmag_mean)
        p2m = sel(p2m, state.phi2_mean)
        am = sel(am, state.act_mean)
        cm = jnp.where(accept[:, None], cm, state.corr_mean)
        lrgvl = sel(lrgvl, state.lrg_vl)
        runs = accum.bump_runs(state.runs, cfg.loops, accept)

        if exact_scheme and not exact_interacting:
            # nothing to adapt: the propagator is exact at the configured
            # Δτ and unconditionally stable (mirrors the chain EXACT path)
            dtau = state.dtau
            stab_cnt = jnp.where(accept, state.stab_cnt + 1, 0)
        else:
            # interacting EXACT keeps the controller: the nonlinear ETD1
            # remainder can trip, and a rejected frame should shrink Δτ
            grow = accept & (state.stab_cnt >= cfg.grow_after)
            dtau = jnp.where(
                grow,
                state.dtau / cfg.shrink,
                jnp.where(accept, state.dtau, state.dtau * cfg.shrink),
            )
            if cfg.dtau_max is not None:
                dtau = jnp.minimum(dtau, jnp.asarray(cfg.dtau_max, dtype))
            stab_cnt = jnp.where(
                accept, jnp.where(grow, 0, state.stab_cnt + 1), 0
            )

        new_state = FieldState(
            phi=phi,
            mag_mean=mm,
            mag2_mean=m2m,
            mag4_mean=m4m,
            absmag_mean=amm,
            phi2_mean=p2m,
            act_mean=am,
            corr_mean=cm,
            runs=runs,
            dtau=dtau,
            stab_cnt=stab_cnt,
            lrg_vl=lrgvl,
            step=step_end,
        )
        metrics = {"stable": accept, "dtau": dtau, "max_phi": lrgvl}
        return new_state, metrics

    return frame


@partial(jax.jit, static_argnames=("action", "cfg", "n_frames"))
def run_field_frames(state: FieldState, action: FieldAction, cfg: FieldConfig, n_frames: int):
    frame = make_field_frame_fn(action, cfg)
    return lax.scan(lambda s, _: frame(s), state, None, length=n_frames)


def susceptibility(state: FieldState, volume: int) -> jax.Array:
    """χ = V·(⟨M²⟩ − ⟨|M|⟩²) per chain."""
    return volume * (state.mag2_mean - state.absmag_mean**2)


def binder_cumulant(state: FieldState) -> jax.Array:
    """U = 1 − ⟨M⁴⟩/(3⟨M²⟩²) per chain: → 0 in the symmetric (Gaussian-M)
    phase, → 2/3 in the broken phase; its lattice-size crossing locates the
    critical coupling."""
    m2 = state.mag2_mean
    # dtype-aware floor: a literal like 1e-300 underflows to 0 in float32,
    # making the guard a no-op (fresh/reset means would yield NaN/Inf)
    floor = jnp.finfo(m2.dtype).tiny
    return 1.0 - state.mag4_mean / jnp.maximum(3.0 * m2 * m2, floor)


def reset_field_means(state: FieldState) -> FieldState:
    zc = jnp.zeros_like(state.mag_mean)
    return state._replace(
        mag_mean=zc,
        mag2_mean=zc,
        mag4_mean=zc,
        absmag_mean=zc,
        phi2_mean=zc,
        act_mean=zc,
        corr_mean=jnp.zeros_like(state.corr_mean),
        runs=jnp.zeros_like(state.runs),
    )
