"""Euler–Maruyama Langevin integrator for 1-D Euclidean-time chains.

Redesign of the reference's kernel+host loop
(``tau_kernel.cl:25-175`` driving, ``tauhost.c:479-560`` driven):

* the inner ``loops`` micro-step loop is a ``lax.scan`` (functional state
  threading replaces the double-buffer swap K7 and the intra-kernel global
  barrier, flaw F1 — synchronous update is correct by construction);
* one jitted *frame* = one reference kernel launch; a scan over frames
  replaces the per-frame host round-trip of all field buffers (H7);
* noise is counter-based (rng.py) instead of the racy shared LCG (F2);
* the divergence detector (K5), running-mean observables (K6), collective-
  coordinate update (K4) and adaptive-Δτ controller (H9) are carry state —
  and all of them are *per chain*, so batched chains adapt independently;
* rejected frames are rolled back exactly (the reference discards them by
  not reading buffers back, tauhost.c:533-544).

Update (interior site, background formulation — tau_kernel.cl:111-117):

    f_i += Δτ·[ m·(f_{i+1}+f_{i−1}−2f_i)/Δt² − V''(x_cl(t_i,ω))·f_i ]
           + c·√(2Δτ/Δt)·η_i

and for the direct formulation the linearized force is replaced by the full
−V'(x_i).  Both target exp(−S/ħ) as Δτ→0.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from stochquant import rng
from stochquant.actions.base import QMAction
from stochquant.config import BoundaryCondition, ChainConfig, Formulation, Scheme
from stochquant.integrators import accum

__all__ = [
    "ChainState",
    "init_chain_state",
    "make_frame_fn",
    "run_frames",
    "connected_correlator",
]


class ChainState(NamedTuple):
    """Full resumable state of a batch of Langevin chains.

    Fixes reference flaw F4: everything needed for statistically continuous
    resume is here — field, means, counts, per-chain Δτ, ω, stability memory
    and the global RNG step counter.
    """

    f: jax.Array         # (C, N) field (fluctuation in BACKGROUND mode)
    omega: jax.Array     # (C,)  collective coordinate (kink center)
    x_mean: jax.Array    # (C, N) running ⟨x_i⟩
    xx0_mean: jax.Array  # (C, N) running ⟨x_i·x_mid⟩
    x2_mean: jax.Array   # (C, N) running ⟨x_i²⟩
    x4_mean: jax.Array   # (C, N) running ⟨x_i⁴⟩ — virial/Schwinger-Dyson
                         # gates and quartic response (the reference has no
                         # moment beyond the two-point row, tau_kernel.cl:144)
    runs: jax.Array      # (C, 2) uint32 (lo, hi) — accepted micro-step
                         # samples as a 64-bit pair (accum.init_runs; a
                         # single uint32 wraps at 4.3e9 — VERDICT r2 item 5)
    dtau: jax.Array      # (C,)  current Langevin step size
    stab_cnt: jax.Array  # (C,)  int32 — consecutive stable frames
    lrg_vl: jax.Array    # (C,)  running max |x| (divergence threshold, K5)
    spec_mean: jax.Array  # (C, N//2+1) running ⟨|x̂_k|²⟩ power spectrum — the
                          # translation-averaged two-point function via iFFT
                          # (zeros unless cfg.accumulate_spectrum)
    step: jax.Array      # ()    uint32 — global micro-step counter (RNG)


def init_chain_state(cfg: ChainConfig, action: QMAction) -> ChainState:
    """Cold start (reference H2, ``tauhost.c:84-102``): field seeded with
    N(0, √(2Δτ)) noise; ω at the lattice midpoint T/2 plus noise, reflected
    into [0, (N−1)Δt]."""
    C, N = cfg.n_chains, cfg.n_sites
    dtype = cfg.jdtype
    R = rng.rounds_of(cfg.rng_impl)
    z = rng.normal_for_shape(
        cfg.seed, rng.Stream.INIT, 0, (C, N), rounds=R
    ).astype(dtype)
    f = jnp.sqrt(jnp.asarray(2.0 * cfg.dtau, dtype)) * z
    half = 0.5 * cfg.n_sites * cfg.dt
    chain_ids = jnp.arange(C, dtype=jnp.uint32)
    z_om = rng.normal(
        cfg.seed, rng.Stream.INIT, chain_ids, jnp.uint32(0), jnp.uint32(1), R
    )
    omega = jnp.asarray(half, dtype) + math.sqrt(cfg.dt) * z_om.astype(dtype)
    omega = _reflect(omega, (N - 1) * cfg.dt)
    zeros = jnp.zeros((C, N), dtype)
    # Seed the divergence threshold with the initial |x| so the very first
    # frame is not spuriously rejected (the reference starts lrgVl at 0 and
    # burns its first frames re-arming, tauhost.c:533-544).
    if cfg.formulation == Formulation.BACKGROUND:
        t_grid = (jnp.arange(N) * cfg.dt).astype(dtype)
        x0 = f + action.x_cl(t_grid[None, :], omega[:, None]).astype(dtype)
    else:
        x0 = f
    lrg_vl = jnp.max(jnp.abs(x0), axis=-1)
    return ChainState(
        f=f,
        omega=omega,
        x_mean=zeros,
        xx0_mean=zeros,
        x2_mean=zeros,
        x4_mean=zeros,
        runs=accum.init_runs(C),
        dtau=jnp.full((C,), cfg.dtau, dtype),
        stab_cnt=jnp.zeros((C,), jnp.int32),
        lrg_vl=lrg_vl,
        spec_mean=jnp.zeros((C, N // 2 + 1), dtype),
        step=jnp.uint32(2),  # steps 0/1 consumed by the cold-start draws
    )


def _reflect(om, upper):
    """Reflect the collective coordinate into [0, upper]
    (tau_kernel.cl:155-167)."""
    om = jnp.where(om > upper, 2.0 * upper - om, om)
    return jnp.where(om < 0, -om, om)


def _neighbor_sum(f, left_ghost, right_ghost, bc: BoundaryCondition):
    """f_{i+1} + f_{i−1} with ghost sites supplied by the BC (K3).

    ``left_ghost``/``right_ghost`` are (C,) arrays used for FIXED_BG /
    DIRICHLET; ignored for PERIODIC.
    """
    if bc == BoundaryCondition.PERIODIC:
        return jnp.roll(f, 1, axis=-1) + jnp.roll(f, -1, axis=-1)
    up = jnp.concatenate([f[:, 1:], right_ghost[:, None]], axis=-1)
    down = jnp.concatenate([left_ghost[:, None], f[:, :-1]], axis=-1)
    return up + down


def _exact_scheme_check(action: QMAction, cfg: ChainConfig) -> None:
    background = cfg.formulation == Formulation.BACKGROUND
    has_zm = background and action.has_zero_mode and cfg.parisi
    if not background or has_zm:
        raise ValueError(
            "Scheme.EXACT integrates the linearized (BACKGROUND) drift "
            "exactly and needs it frozen: use formulation=BACKGROUND with "
            "parisi=False (or an action without a zero mode)"
        )
    # every BC is supported since r4: PERIODIC (corner wrap), FIXED_BG
    # (ghost source), DIRICHLET (interior propagator, edges re-pinned)


def exact_propagator_ops(action: QMAction, cfg: ChainConfig, omega, dtau=None):
    """Per-chain exact-OU step operators ``(P, S, mu)`` for the linearized
    drift at frozen ω (``Scheme.EXACT``).

    ``dtau``: per-chain (C,) step sizes; defaults to ``cfg.dtau``.  Callers
    resuming checkpointed state MUST pass ``state.dtau`` — a checkpoint whose
    adaptive Δτ diverged from the config (e.g. ``--resume`` from an EM run
    combined with ``--scheme exact``) would otherwise silently integrate at
    ``cfg.dtau`` while the state/metrics report the per-chain values
    (ADVICE r3).

    The BACKGROUND micro-step integrates ``df/dτ = −B f + s + √(2/Δt)c ξ``
    with the (per-chain) constant SPD matrix ``B = (m/Δt²)(2I − shift) +
    V''(x_cl(t, ω))`` and the FIXED_BG ghost source ``s``.  That OU process
    has the closed-form transition f(τ+Δτ) = μ + e^{−BΔτ}(f−μ) + ζ,
    ζ ~ N(0, (c²/Δt)·B⁻¹(I − e^{−2BΔτ})), μ = B⁻¹s — so one dense update
    per micro-step samples the EXACT continuous-time law at any Δτ
    (Euler–Maruyama's Δτ→0 limit, with zero discretization bias and no
    stability bound).  Computed via a batched ``eigh`` once per
    ``run_frames`` call; the per-step application is two (C,N)·(N,N)
    batched matmuls — dense matrix work, unlike the stencil schemes.

    Zero modes (λ → 0, e.g. the periodic free-particle constant mode) get
    their exact diffusive limit ``var = 2Δτ·c²/Δt``.
    """
    C, N = cfg.n_chains, cfg.n_sites
    dt = cfg.dt
    dtype = cfg.jdtype
    t_grid = (jnp.arange(N) * dt).astype(dtype)
    inv = action.mass / (dt * dt)
    x_cl = action.x_cl(t_grid[None, :], omega[:, None]).astype(dtype)
    curv = action.ddV(x_cl).astype(dtype)  # (C, N)
    eye = jnp.eye(N, dtype=dtype)
    off = (jnp.eye(N, k=1) + jnp.eye(N, k=-1)).astype(dtype)
    B = curv[:, :, None] * eye + (2.0 * inv) * eye - inv * off
    dirichlet = cfg.bc == BoundaryCondition.DIRICHLET
    if dirichlet:
        # edge SITES pinned to 0 (the EM path's per-step
        # ``.at[:, 0].set(0)``, tau_kernel.cl:70-72 semantics): the exact
        # propagator acts on the N−2 interior sites with the Dirichlet
        # Laplacian and is embedded into N×N with zero edge rows/cols —
        # every exact step then re-pins the edges by construction.
        Ni = N - 2
        eye_i = jnp.eye(Ni, dtype=dtype)
        off_i = (jnp.eye(Ni, k=1) + jnp.eye(Ni, k=-1)).astype(dtype)
        B = (
            curv[:, 1:-1, None] * eye_i + (2.0 * inv) * eye_i - inv * off_i
        )
        mu = jnp.zeros((C, N), dtype)
    elif cfg.bc == BoundaryCondition.PERIODIC:
        corner = (
            jnp.zeros((N, N), dtype).at[0, N - 1].set(1.0).at[N - 1, 0].set(1.0)
        )
        B = B - inv * corner
        mu = jnp.zeros((C, N), dtype)
    else:  # FIXED_BG ghost sources (tau_kernel.cl:74,92 semantics)
        if cfg.ghost_override is not None:
            asym_l = jnp.asarray(cfg.ghost_override[0], dtype)
            asym_r = jnp.asarray(cfg.ghost_override[1], dtype)
        else:
            asym_l = jnp.asarray(action.boundary_asymptote(-1), dtype)
            asym_r = jnp.asarray(action.boundary_asymptote(+1), dtype)
        gl = asym_l - action.x_cl(jnp.asarray(-dt, dtype), omega).astype(dtype)
        gr = asym_r - action.x_cl(jnp.asarray(N * dt, dtype), omega).astype(dtype)
        s = (
            jnp.zeros((C, N), dtype)
            .at[:, 0].add(inv * gl)
            .at[:, -1].add(inv * gr)
        )
        with jax.default_matmul_precision("highest"):  # no TF32 in the solve
            mu = jnp.linalg.solve(B, s[..., None])[..., 0]
    with jax.default_matmul_precision("highest"):
        lam, U = jnp.linalg.eigh(B)  # (C, N), (C, N, N)
    if dtau is None:
        dtau_col = jnp.full((C, 1), cfg.dtau, dtype)
    else:
        dtau_col = jnp.asarray(dtau, dtype).reshape((C, 1))
    c2_dt = jnp.asarray(cfg.noise_amp**2 / dt, dtype)
    decay = jnp.exp(-lam * dtau_col)
    var = jnp.where(
        lam > 1e-8,
        c2_dt * (1.0 - decay * decay) / jnp.maximum(lam, 1e-8),
        2.0 * dtau_col * c2_dt,
    )
    # precision=HIGHEST: XLA may run f32 contractions at reduced precision
    # on an accelerator (TF32 on NVIDIA GPUs, ~1e-3 relative error); the
    # EXACT scheme's whole point is zero integration bias, so the
    # propagator products are exact fp32
    hi = jax.lax.Precision.HIGHEST
    P = jnp.einsum("cik,ck,cjk->cij", U, decay, U, precision=hi)
    S = jnp.einsum("cik,ck,cjk->cij", U, jnp.sqrt(var), U, precision=hi)
    if dirichlet:
        # embed the interior operators; zero edge rows/cols keep f = 0 at
        # the edge sites (and zero their noise) every step
        Pf = jnp.zeros((C, N, N), dtype).at[:, 1:-1, 1:-1].set(P)
        Sf = jnp.zeros((C, N, N), dtype).at[:, 1:-1, 1:-1].set(S)
        return Pf, Sf, mu
    return P, S, mu


def make_frame_fn(action: QMAction, cfg: ChainConfig, exact_ops=None):
    """Build ``frame(state) -> (state', metrics)``: one macro-step of
    ``cfg.loops`` micro-steps with accept/reject + adaptive Δτ.

    Pure and jittable; chains axis shards transparently (noise is keyed by
    global chain/site ids, so any sharding yields bit-identical trajectories).

    ``exact_ops``: precomputed :func:`exact_propagator_ops` for
    ``Scheme.EXACT`` (``run_frames`` builds them once per call so the
    eigendecomposition is hoisted out of the frame scan; if omitted they
    are derived inside the frame — correct but recomputed per frame).
    """
    C, N = cfg.n_chains, cfg.n_sites
    dt = cfg.dt
    dtype = cfg.jdtype
    mid = N // 2
    t_grid = (jnp.arange(N) * dt).astype(dtype)  # (N,)
    background = cfg.formulation == Formulation.BACKGROUND
    inv_dt2 = jnp.asarray(action.mass / (dt * dt), dtype)
    zm_const = jnp.asarray(action.zero_mode_const(), dtype)
    has_zm = background and action.has_zero_mode and cfg.parisi
    upper = jnp.asarray((N - 1) * dt, dtype)
    c_amp = jnp.asarray(cfg.noise_amp, dtype)
    clamp = jnp.asarray(cfg.clamp, dtype)
    chain_ids = jnp.arange(C, dtype=jnp.uint32)
    if cfg.ghost_override is not None:
        asym_l = jnp.asarray(cfg.ghost_override[0], dtype)
        asym_r = jnp.asarray(cfg.ghost_override[1], dtype)
    else:
        asym_l = jnp.asarray(action.boundary_asymptote(-1), dtype)
        asym_r = jnp.asarray(action.boundary_asymptote(+1), dtype)
    t_ghost_l = jnp.asarray(-dt, dtype)
    t_ghost_r = jnp.asarray(N * dt, dtype)
    exact_scheme = cfg.scheme == Scheme.EXACT
    if exact_scheme:
        _exact_scheme_check(action, cfg)

    def ghosts(omega):
        """(C,) ghost-site field values for the configured BC."""
        if cfg.bc == BoundaryCondition.PERIODIC:
            z = jnp.zeros((C,), dtype)
            return z, z
        if cfg.bc == BoundaryCondition.DIRICHLET:
            z = jnp.zeros((C,), dtype)
            return z, z
        # FIXED_BG: pin the *full field* at the asymptote; in background
        # formulation the fluctuation ghost is asymptote − x_cl(t_ghost, ω)
        # (tau_kernel.cl:74,92).
        if background:
            gl = asym_l - action.x_cl(t_ghost_l, omega).astype(dtype)
            gr = asym_r - action.x_cl(t_ghost_r, omega).astype(dtype)
        else:
            gl = jnp.full((C,), asym_l, dtype)
            gr = jnp.full((C,), asym_r, dtype)
        return jnp.broadcast_to(gl, (C,)), jnp.broadcast_to(gr, (C,))

    def drift(f, omega):
        """Drift density −(1/Δt)·∂S/∂f (K2): m·∇²/Δt² − force term."""
        gl, gr = ghosts(omega)
        lap = (_neighbor_sum(f, gl, gr, cfg.bc) - 2.0 * f) * inv_dt2
        if background:
            curv = action.ddV(action.x_cl(t_grid[None, :], omega[:, None])).astype(dtype)
            return lap - curv * f
        return lap - action.dV(f).astype(dtype)

    def full_x(f, omega):
        """Reconstruct the physical field x = f + x_cl (K6's `f+clas`)."""
        if background:
            return f + action.x_cl(t_grid[None, :], omega[:, None]).astype(dtype)
        return f

    def frame(state: ChainState):
        if exact_scheme:
            P_op, S_op, mu_op = (
                exact_ops
                if exact_ops is not None
                else exact_propagator_ops(action, cfg, state.omega, state.dtau)
            )

        def substep(vals, eta, eta_om):
            """One micro-step given its noise field (EM / Heun / exact-OU)."""
            f, omega, xs, xxs, x2s, x4s, specs, unstable, lrgvl = vals

            if exact_scheme:
                # exact OU transition: ζ at the exact covariance, drift part
                # μ + e^{−BΔτ}(f−μ) — two batched matmuls; cast back to
                # the EM bookkeeping shape (det + noise) so the shared
                # detector/observable machinery below applies unchanged
                hi = jax.lax.Precision.HIGHEST
                noise = jnp.einsum("cij,cj->ci", S_op, eta, precision=hi)
                f_next = (
                    mu_op
                    + jnp.einsum("cij,cj->ci", P_op, f - mu_op, precision=hi)
                    + noise
                )
                det = f_next - f - noise
            else:
                noise = c_amp * jnp.sqrt(2.0 * state.dtau[:, None] / dt) * eta
                if cfg.scheme == Scheme.HEUN:
                    # stochastic Heun: predictor with the same noise
                    # realization, corrector averages the drift → O(Δτ²)
                    # stationary bias
                    f1 = drift(f, omega)
                    f_pred = f + state.dtau[:, None] * f1 + noise
                    f2 = drift(f_pred, omega)
                    det = 0.5 * state.dtau[:, None] * (f1 + f2)
                else:
                    det = drift(f, omega) * state.dtau[:, None]
            newf_raw = f + det + noise
            # clamp + definitize non-finite values (tau_kernel.cl:119-133)
            newf = jnp.clip(newf_raw, -clamp, clamp)
            newf = jnp.where(jnp.isfinite(newf_raw), newf, clamp)
            if cfg.bc == BoundaryCondition.DIRICHLET:
                # field pinned to 0 at the edge *sites* (tau_kernel.cl:70-72)
                newf = newf.at[:, 0].set(0.0).at[:, -1].set(0.0)

            # divergence detector (K5, cleaned semantics): trip when the
            # largest *deterministic* per-site change exceeds the historical
            # max |x|, or anything went non-finite.
            max_det = jnp.max(jnp.abs(det), axis=-1)
            bad = ~jnp.all(jnp.isfinite(newf_raw), axis=-1)
            if exact_scheme:
                # the exact transition legitimately moves O(σ) per step at
                # large Δτ (Δτ→∞ is a full redraw); only non-finite trips
                tripped = bad
            else:
                tripped = (max_det > lrgvl) | bad

            # observables sample the *pre-update* field.  Frame-local fp32
            # sample SUMS here; the cross-frame merge happens once per frame
            # in the epilogue (two-level accumulation, integrators/accum.py —
            # the precision-hardened equivalent of the reference's per-sample
            # double-precision running means, tau_kernel.cl:144-145).
            x = full_x(f, omega)
            x2 = x * x
            xs2 = xs + x
            xxs2 = xxs + x * x[:, mid : mid + 1]
            x2s2 = x2s + x2
            x4s2 = x4s + x2 * x2
            if cfg.accumulate_spectrum:
                power = jnp.abs(jnp.fft.rfft(x, axis=-1)).astype(dtype) ** 2
                specs2 = specs + power
            else:
                specs2 = specs

            lrgvl2 = jnp.maximum(
                lrgvl, jnp.max(jnp.abs(full_x(newf, omega)), axis=-1)
            )

            if has_zm:
                d_om = zm_const * c_amp * jnp.sqrt(2.0 * state.dtau) * eta_om
                omega2 = _reflect(omega + d_om, upper)
            else:
                omega2 = omega

            # freeze chains whose frame already diverged (the reference breaks
            # all work-items out of the micro loop, tau_kernel.cl:169-171)
            u = unstable[:, None]
            keep = lambda new, old: jnp.where(u, old, new)
            fz = keep(newf, f)
            omega2 = jnp.where(unstable, omega, omega2)
            xsz = keep(xs2, xs)
            xxsz = keep(xxs2, xxs)
            x2sz = keep(x2s2, x2s)
            x4sz = keep(x4s2, x4s)
            specsz = jnp.where(u, specs, specs2)
            lrgvlz = jnp.where(unstable, lrgvl, lrgvl2)
            unstable = unstable | tripped
            return (fz, omega2, xsz, xxsz, x2sz, x4sz, specsz, unstable, lrgvlz)

        def om_noise_pair(step):
            if not has_zm:
                return None, None
            k1 = jnp.uint32(rng.Stream.COLLECTIVE) ^ lax.shift_left(
                chain_ids, jnp.uint32(8)
            )
            z0, z1 = rng.normal_pair(
                jnp.uint32(cfg.seed), k1, jnp.zeros_like(chain_ids), step,
                rng.rounds_of(cfg.rng_impl),
            )
            return z0.astype(dtype), z1.astype(dtype)

        def field_pair(step):
            e0, e1 = rng.normal_pair_for_shape(
                cfg.seed, rng.Stream.FIELD, step, (C, N),
                rounds=rng.rounds_of(cfg.rng_impl),
            )
            return e0.astype(dtype), e1.astype(dtype)

        def pair_step(carry, _):
            """Two micro-steps per iteration, sharing one Threefry draw (both
            Box–Muller outputs are used — halves RNG cost)."""
            *vals, step = carry
            eta0, eta1 = field_pair(step)
            zo0, zo1 = om_noise_pair(step)
            vals = substep(tuple(vals), eta0, zo0)
            vals = substep(vals, eta1, zo1)
            return (*vals, step + 2), None

        def lm_pair_step(carry, _):
            """LM: micro-step k uses (ξ_k + ξ_{k+1})/2; ξ of the *next* pair
            is drawn here and carried forward so RNG cost stays one Threefry
            draw per two steps (ξ_{k+2} is re-drawn identically by the next
            iteration/frame — counter-based keying makes that exact)."""
            *rest, step = carry
            if has_zm:
                *vals, p0, p1, po0, po1 = rest
            else:
                *vals, p0, p1 = rest
            q0, q1 = field_pair(step + 2)
            if has_zm:
                qo0, qo1 = om_noise_pair(step + 2)
                vals = substep(tuple(vals), 0.5 * (p0 + p1), 0.5 * (po0 + po1))
                vals = substep(vals, 0.5 * (p1 + q0), 0.5 * (po1 + qo0))
                return (*vals, q0, q1, qo0, qo1, step + 2), None
            vals = substep(tuple(vals), 0.5 * (p0 + p1), None)
            vals = substep(vals, 0.5 * (p1 + q0), None)
            return (*vals, q0, q1, step + 2), None

        zsum = jnp.zeros_like(state.x_mean)
        vals0 = (
            state.f,
            state.omega,
            zsum,  # frame Σ x
            zsum,  # frame Σ x·x_mid
            zsum,  # frame Σ x²
            zsum,  # frame Σ x⁴
            jnp.zeros_like(state.spec_mean),  # frame Σ |x̂|²
            jnp.zeros((C,), bool),
            state.lrg_vl,
        )
        if cfg.scheme == Scheme.LM:
            if cfg.loops % 2:
                raise ValueError("Scheme.LM requires an even cfg.loops")
            p0, p1 = field_pair(state.step)
            extra = (p0, p1)
            if has_zm:
                po0, po1 = om_noise_pair(state.step)
                extra = (p0, p1, po0, po1)
            carry, _ = lax.scan(
                lm_pair_step, (*vals0, *extra, state.step), None,
                length=cfg.loops // 2,
            )
            *rest, step_end = carry
            vals = rest[: len(vals0)]
            carry = (*vals, step_end)
        else:
            carry, _ = lax.scan(
                pair_step, (*vals0, state.step), None, length=cfg.loops // 2
            )
            if cfg.loops % 2:
                *vals, step = carry
                eta0, _ = field_pair(step)
                zo0, _ = om_noise_pair(step)
                vals = substep(tuple(vals), eta0, zo0)
                carry = (*vals, step + 1)
        f, omega, xs, xxs, x2s, x4s, specs, unstable, lrgvl, step_end = carry
        return frame_epilogue(
            state, cfg, f, omega, (xs, xxs, x2s, x4s), lrgvl, unstable,
            step_end, specs=specs if cfg.accumulate_spectrum else None,
        )

    return frame


def frame_epilogue(
    state: ChainState, cfg: ChainConfig, f, omega, sums, lrgvl, unstable,
    step_end, specs=None,
):
    """End of a frame, shared by every execution path: accept/reject with
    rollback, the merge of the frame sums into the running means
    (integrators/accum.py) and the adaptive-Δτ controller.

    ``f``/``omega``/``lrgvl`` are the frame's end values, ``sums`` its
    (Σx, Σx·x_mid, Σx², Σx⁴) sample sums, ``unstable`` the per-chain
    divergence flags and ``specs`` the Σ|x̂|² spectrum sums (or None)."""
    dtype = cfg.jdtype
    xs, xxs, x2s, x4s = sums
    accept = ~unstable  # (C,)
    a1 = accept[:, None]
    # merge the frame sums into the running means (two-level accumulation)
    n_new = accum.runs_after(state.runs, cfg.loops).astype(dtype)[:, None]
    xm = accum.merge_frame_sum(state.x_mean, xs, cfg.loops, n_new)
    xxm = accum.merge_frame_sum(state.xx0_mean, xxs, cfg.loops, n_new)
    x2m = accum.merge_frame_sum(state.x2_mean, x2s, cfg.loops, n_new)
    x4m = accum.merge_frame_sum(state.x4_mean, x4s, cfg.loops, n_new)
    if specs is not None:
        spec = accum.merge_frame_sum(state.spec_mean, specs, cfg.loops, n_new)
    else:
        spec = state.spec_mean
    sel = lambda new, old: jnp.where(a1, new, old)
    f = sel(f, state.f)
    xm = sel(xm, state.x_mean)
    xxm = sel(xxm, state.xx0_mean)
    x2m = sel(x2m, state.x2_mean)
    x4m = sel(x4m, state.x4_mean)
    spec = jnp.where(a1, spec, state.spec_mean)
    omega = jnp.where(accept, omega, state.omega)
    lrgvl = jnp.where(accept, lrgvl, state.lrg_vl)
    runs = accum.bump_runs(state.runs, cfg.loops, accept)

    # adaptive Δτ (H9, tauhost.c:523-545) — per chain.  Scheme.EXACT has
    # nothing to adapt (the propagator is exact at the configured Δτ and
    # unconditionally stable): Δτ stays fixed.
    if cfg.scheme == Scheme.EXACT:
        dtau = state.dtau
        stab_cnt = jnp.where(accept, state.stab_cnt + 1, 0)
    else:
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

    new_state = ChainState(
        f=f,
        omega=omega,
        x_mean=xm,
        xx0_mean=xxm,
        x2_mean=x2m,
        x4_mean=x4m,
        runs=runs,
        dtau=dtau,
        stab_cnt=stab_cnt,
        lrg_vl=lrgvl,
        spec_mean=spec,
        step=step_end,  # RNG never reuses noise, even on rejection
    )
    metrics = {
        "stable": accept,
        "dtau": dtau,
        "max_x": lrgvl,
    }
    return new_state, metrics


@partial(jax.jit, static_argnames=("action", "cfg", "n_frames"))
def run_frames(state: ChainState, action: QMAction, cfg: ChainConfig, n_frames: int):
    """Scan ``n_frames`` macro-steps fully on device.

    Returns (final_state, metrics) with metrics arrays stacked over frames —
    the structured replacement for the stdout streaming protocol (H8).
    """
    exact_ops = (
        exact_propagator_ops(action, cfg, state.omega, state.dtau)
        if cfg.scheme == Scheme.EXACT
        else None
    )  # eigh once per call, hoisted out of the frame scan
    frame = make_frame_fn(action, cfg, exact_ops=exact_ops)
    return lax.scan(lambda s, _: frame(s), state, None, length=n_frames)


def connected_correlator(state: ChainState) -> jax.Array:
    """C_i = ⟨x_i·x_mid⟩ − ⟨x_i⟩·⟨x_mid⟩ per chain (tauhost.c:519-521)."""
    mid = state.x_mean.shape[-1] // 2
    return state.xx0_mean - state.x_mean * state.x_mean[:, mid : mid + 1]


def reset_means(state: ChainState) -> ChainState:
    """Zero the running observables (use after thermalization burn-in, so
    equilibrium estimates are not contaminated by the cold start)."""
    z = jnp.zeros_like(state.x_mean)
    return state._replace(
        x_mean=z,
        xx0_mean=z,
        x2_mean=z,
        x4_mean=z,
        spec_mean=jnp.zeros_like(state.spec_mean),
        runs=jnp.zeros_like(state.runs),
    )


def translation_averaged_correlator(state: ChainState) -> jax.Array:
    """⟨x(t)·x(t+Δ)⟩ averaged over all t (per chain) from the accumulated
    power spectrum — every site pair contributes, giving far better
    statistics than the reference's single-midpoint column
    (requires cfg.accumulate_spectrum).  Connected part: subtract
    ⟨x⟩ₜ-bar² outside if the mean is nonzero."""
    n = state.x_mean.shape[-1]
    return jnp.fft.irfft(state.spec_mean, n=n, axis=-1) / n
