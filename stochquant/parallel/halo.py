"""Explicit domain decomposition: shard_map + ring ``ppermute`` halo exchange.

parallel/mesh.py's GSPMD path lets XLA partition the ``jnp.roll`` stencil
automatically.  This module is the manually-scheduled equivalent (SURVEY.md
§2.5 "ring / neighbor-exchange"): each shard owns a contiguous lattice block,
exchanges 1-site-wide edge slices with its ring neighbours
(`lax.ppermute` — stencil radius 1, the analog of ``tau_kernel.cl:114``'s
neighbour reads), and updates its block locally.  The halo sends are issued
before any local math that needs them, so XLA's latency-hiding scheduler
overlaps the collective-permute with the interior drift computation.

Bitwise-identical to the unsharded integrator (tests/test_halo.py): noise is
keyed by global coordinates, halo values are exact copies, and per-chain
reductions use max/psum trees that are exact (max) or tolerance-tested (sum).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from stochquant import rng
from stochquant.actions.phi4 import FieldAction
from stochquant.config import FieldConfig, Sweep
from stochquant.integrators import accum
from stochquant.integrators.field import FieldState

__all__ = ["halo_shifted", "make_halo_runner"]


def halo_shifted(x, axis: int, mesh_axis: str | None):
    """(x shifted −1, x shifted +1) along ``axis`` with periodic wraparound
    across the shard ring.

    Returns (up, down) where up[i] = x[i+1] and down[i] = x[i−1] in *global*
    coordinates.  For an unsharded axis this is plain ``jnp.roll``; for a
    sharded axis the wrap elements come from ring neighbours via
    ``lax.ppermute`` (the SPMD halo exchange).
    """
    if mesh_axis is None:
        return jnp.roll(x, -1, axis), jnp.roll(x, 1, axis)
    n = lax.axis_size(mesh_axis)
    if n == 1:
        return jnp.roll(x, -1, axis), jnp.roll(x, 1, axis)
    first = lax.slice_in_dim(x, 0, 1, axis=axis)
    last = lax.slice_in_dim(x, x.shape[axis] - 1, x.shape[axis], axis=axis)
    # my right halo = left edge of my right neighbour (src i+1 → dst i);
    # issue both sends up front so they overlap with local compute.
    right_halo = lax.ppermute(first, mesh_axis, [((i + 1) % n, i) for i in range(n)])
    left_halo = lax.ppermute(last, mesh_axis, [((i - 1) % n, i) for i in range(n)])
    body_up = lax.slice_in_dim(x, 1, x.shape[axis], axis=axis)
    body_down = lax.slice_in_dim(x, 0, x.shape[axis] - 1, axis=axis)
    up = jnp.concatenate([body_up, right_halo], axis=axis)
    down = jnp.concatenate([left_halo, body_down], axis=axis)
    return up, down


def make_halo_runner(
    action: FieldAction,
    cfg: FieldConfig,
    mesh: Mesh,
    *,
    overlap: bool = True,
):
    """Build ``run(state, n_frames) -> (state, metrics)`` executing the field
    frame loop under shard_map with explicit halo exchange.

    ``cfg.mesh_axes`` names the mesh axis for each lattice dimension (None =
    unsharded); ``cfg.mesh_chain_axis`` optionally shards chains.  State must
    be placed with ``parallel.shard_field_state`` using the same cfg.

    overlap=True (default): halos are issued before the bulk stencil, which
    runs with local wraparound and has NO data dependency on the collectives;
    only the O(surface) edge-slice fixup waits on them.  overlap=False keeps
    the halo values on the critical path of the whole stencil (concatenate
    then shift) — the reference for measuring the overlap; both variants are
    bitwise identical.
    """
    if cfg.mesh_axes is None:
        raise ValueError("cfg.mesh_axes required for the halo runner")
    ndim = cfg.ndim
    shape = tuple(cfg.shape)
    ca = cfg.mesh_chain_axis
    lat_axes_spec = tuple(cfg.mesh_axes)
    dtype = cfg.jdtype
    a = cfg.spacing
    measure = a**ndim
    inv_a2 = 1.0 / (a * a)
    c_amp = jnp.asarray(cfg.noise_amp, dtype)
    clamp = jnp.asarray(cfg.clamp, dtype)

    axis_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    local_shape = tuple(
        s // (axis_sizes[ax] if ax else 1) for s, ax in zip(shape, lat_axes_spec)
    )
    for s, ls, ax in zip(shape, local_shape, lat_axes_spec):
        if ax and ls * axis_sizes[ax] != s:
            raise ValueError(f"lattice dim {s} not divisible by mesh axis {ax}")
    c_local = cfg.n_chains // (axis_sizes[ca] if ca else 1)

    volume = float(np.prod(shape))
    lat_reduce = tuple(range(1, ndim + 1))
    nonzero_reduce = tuple(range(2, ndim + 1))
    lat_mesh_axes = tuple(ax for ax in lat_axes_spec if ax)

    def psum_lat(v):
        return lax.psum(v, lat_mesh_axes) if lat_mesh_axes else v

    def pmax_lat(v):
        return lax.pmax(v, lat_mesh_axes) if lat_mesh_axes else v

    def local_offsets():
        ch_off = (lax.axis_index(ca) * c_local) if ca else 0
        lat_off = tuple(
            (lax.axis_index(ax) * ls) if ax else 0
            for ax, ls in zip(lat_axes_spec, local_shape)
        )
        return ch_off, lat_off

    def _exchange_halos(phi):
        """Kick off the ring ppermutes for every sharded lattice dim and
        return {dim: (left_halo, right_halo)}.  Issued before ANY local
        stencil math so the collective-permutes are in flight while
        the (much larger) interior compute runs — the sends are not data
        dependencies of the bulk work below, which is what lets XLA's
        latency-hiding scheduler overlap them (SURVEY.md §2.5 ring row)."""
        pending = {}
        for d in range(ndim):
            ax = lat_axes_spec[d]
            if not ax or axis_sizes[ax] == 1:
                continue
            axis = d + 1
            n = axis_sizes[ax]
            first = lax.slice_in_dim(phi, 0, 1, axis=axis)
            last = lax.slice_in_dim(
                phi, phi.shape[axis] - 1, phi.shape[axis], axis=axis
            )
            right_halo = lax.ppermute(
                first, ax, [((i + 1) % n, i) for i in range(n)]
            )
            left_halo = lax.ppermute(
                last, ax, [((i - 1) % n, i) for i in range(n)]
            )
            pending[d] = (left_halo, right_halo)
        return pending

    def laplacian_blocking(phi):
        """Non-overlapped reference: halo values sit on the critical path of
        every site's stencil (concatenate-then-add)."""
        lap = jnp.zeros_like(phi)
        for d in range(ndim):
            up, down = halo_shifted(phi, d + 1, lat_axes_spec[d])
            lap = lap + (up + down - 2.0 * phi)
        return lap * inv_a2

    def laplacian_overlapped(phi):
        """Overlapped halo-exchange stencil, bitwise-equal to the unsharded
        ∇²: (a) halos go on the wire, (b) the bulk stencil runs with local
        wraparound (exact for every interior site), (c) only the two edge
        slices per exchanged dim are recomputed with the true neighbor
        values — same operand order as the bulk, so the fixup is exact, and
        it is the only code that waits on the collectives."""
        pending = _exchange_halos(phi)
        lap = jnp.zeros_like(phi)
        for d in range(ndim):
            axis = d + 1
            c = jnp.roll(phi, -1, axis) + jnp.roll(phi, 1, axis) - 2.0 * phi
            if d in pending:
                left_halo, right_halo = pending[d]
                L = phi.shape[axis]
                phi_first = lax.slice_in_dim(phi, 0, 1, axis=axis)
                phi_last = lax.slice_in_dim(phi, L - 1, L, axis=axis)
                up_first = (
                    lax.slice_in_dim(phi, 1, 2, axis=axis) if L > 1 else right_halo
                )
                down_last = (
                    lax.slice_in_dim(phi, L - 2, L - 1, axis=axis)
                    if L > 1
                    else left_halo
                )
                fix_first = up_first + left_halo - 2.0 * phi_first
                fix_last = right_halo + down_last - 2.0 * phi_last
                c = lax.dynamic_update_slice_in_dim(c, fix_first, 0, axis)
                c = lax.dynamic_update_slice_in_dim(c, fix_last, L - 1, axis)
            lap = lap + c
        return lap * inv_a2

    laplacian = laplacian_overlapped if overlap else laplacian_blocking

    def action_density_overlapped(phi):
        """Local block's action density (forward differences), with the same
        overlap structure: bulk forward-diffs run on local rolls while the
        right-edge halos fly, then only the last slice per exchanged dim is
        fixed up."""
        pending = _exchange_halos(phi)
        kin = jnp.zeros_like(phi)
        for d in range(ndim):
            axis = d + 1
            up = jnp.roll(phi, -1, axis)
            if d in pending:
                _, right_halo = pending[d]
                L = phi.shape[axis]
                up = lax.dynamic_update_slice_in_dim(up, right_halo, L - 1, axis)
            diff = up - phi
            kin = kin + 0.5 * diff * diff * inv_a2
        return kin + action.V(phi)

    def action_density_blocking(phi):
        """Non-overlapped reference: the forward-difference neighbours come
        from halo_shifted (concatenate-then-diff), keeping the halo values on
        the critical path of every site — so an overlap A/B comparison
        isolates the *full* overlap effect (the laplacian's and this one's)."""
        kin = jnp.zeros_like(phi)
        for d in range(ndim):
            up, _ = halo_shifted(phi, d + 1, lat_axes_spec[d])
            diff = up - phi
            kin = kin + 0.5 * diff * diff * inv_a2
        return kin + action.V(phi)

    action_density_local = (
        action_density_overlapped if overlap else action_density_blocking
    )

    state_spec = FieldState(
        phi=P(ca, *lat_axes_spec),
        mag_mean=P(ca), mag2_mean=P(ca), mag4_mean=P(ca), absmag_mean=P(ca),
        phi2_mean=P(ca), act_mean=P(ca),
        corr_mean=P(ca, lat_axes_spec[0]),
        runs=P(ca), dtau=P(ca), stab_cnt=P(ca), lrg_vl=P(ca), step=P(),
    )
    metrics_spec = {"stable": P(None, ca), "dtau": P(None, ca), "max_phi": P(None, ca)}

    checkerboard = cfg.sweep == Sweep.CHECKERBOARD

    def local_even_mask(lat_off):
        """'Even' sites of the *global* checkerboard on this shard's block."""
        full = (1,) + local_shape
        s = jnp.zeros(full, jnp.int32)
        for d in range(1, ndim + 1):
            s = s + lax.broadcasted_iota(jnp.int32, full, d) + jnp.asarray(
                lat_off[d - 1], jnp.int32
            )
        return s % 2 == 0


    def frame(state: FieldState):
        ch_off, lat_off = local_offsets()
        even = local_even_mask(lat_off) if checkerboard else None

        def em_apply(phi, mask, noise):
            det = (laplacian(phi) - action.dV(phi).astype(dtype)) * state.dtau.reshape(
                (c_local,) + (1,) * ndim
            )
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

        def noise_pair(step):
            return rng.normal_pair_for_shape(
                cfg.seed,
                rng.Stream.FIELD,
                step,
                (c_local,) + local_shape,
                global_lattice_shape=shape,
                chain_offset=ch_off,
                lattice_offsets=lat_off,
                rounds=rng.rounds_of(cfg.rng_impl),
            )

        def finish_micro_step(
            carry, newphi, max_det_loc, bad_loc, npmax_loc,
            mag_loc, phi2_loc, act_loc, s_slice_loc,
        ):
            """Shared micro-step tail: global reductions, trip decision,
            observable accumulation, per-chain freeze."""
            phi, ms, m2s, m4s, ams, p2s, acs, cs, unstable, lrgvl, step = carry

            max_det = pmax_lat(max_det_loc)
            # pmax over int-cast booleans: "any non-finite value anywhere"
            anybad = pmax_lat(bad_loc.astype(jnp.int32)) > 0
            tripped = (max_det > lrgvl) | anybad

            mag = psum_lat(mag_loc) / volume
            phi2 = psum_lat(phi2_loc) / volume
            act_d = psum_lat(act_loc) / volume

            # time-slice mean over non-0 dims: (C_loc, L0_loc)
            n_per_slice = volume / shape[0]
            s_slice = s_slice_loc
            if lat_mesh_axes:
                other_axes = tuple(ax for ax in lat_axes_spec[1:] if ax)
                if other_axes:
                    s_slice = lax.psum(s_slice, other_axes)
            s_slice = s_slice / n_per_slice
            ax0 = lat_axes_spec[0]
            if ax0:
                contrib = jnp.where(
                    lax.axis_index(ax0) == 0, s_slice[:, :1], jnp.zeros_like(s_slice[:, :1])
                )
                s0 = lax.psum(contrib, ax0)
            else:
                s0 = s_slice[:, :1]
            corr = s_slice * s0

            # frame-local sample sums (two-level accumulation, accum.py)
            mag2 = mag * mag
            ms2 = ms + mag
            m2s2 = m2s + mag2
            m4s2 = m4s + mag2 * mag2
            ams2 = ams + jnp.abs(mag)
            p2s2 = p2s + phi2
            acs2 = acs + act_d
            cs2 = cs + corr

            lrgvl2 = jnp.maximum(lrgvl, pmax_lat(npmax_loc))

            u = unstable.reshape((c_local,) + (1,) * ndim)
            phi = jnp.where(u, phi, newphi)
            keep = lambda new, old: jnp.where(unstable, old, new)
            ms = keep(ms2, ms)
            m2s = keep(m2s2, m2s)
            m4s = keep(m4s2, m4s)
            ams = keep(ams2, ams)
            p2s = keep(p2s2, p2s)
            acs = keep(acs2, acs)
            cs = jnp.where(unstable[:, None], cs, cs2)
            lrgvl = jnp.where(unstable, lrgvl, lrgvl2)
            unstable = unstable | tripped
            return (phi, ms, m2s, m4s, ams, p2s, acs, cs, unstable, lrgvl, step + 1)

        def micro_step(carry, eta):
            phi = carry[0]

            noise = c_amp * jnp.sqrt(2.0 * state.dtau / measure).reshape(
                (c_local,) + (1,) * ndim
            ) * eta

            if checkerboard:
                # second half-sweep re-exchanges halos of the fresh even sites
                phi_e, absdet_e, fin_e = em_apply(phi, even, noise)
                newphi, absdet_o, fin_o = em_apply(phi_e, ~even, noise)
                absdet = jnp.maximum(absdet_e, absdet_o)
                fin = fin_e & fin_o
            else:
                newphi, absdet, fin = em_apply(phi, None, noise)

            return finish_micro_step(
                carry,
                newphi,
                jnp.max(absdet, axis=lat_reduce),
                ~jnp.all(fin, axis=lat_reduce),
                jnp.max(jnp.abs(newphi), axis=lat_reduce),
                jnp.sum(phi, axis=lat_reduce),
                jnp.sum(phi * phi, axis=lat_reduce),
                jnp.sum(action_density_local(phi).astype(dtype), axis=lat_reduce),
                jnp.sum(phi, axis=nonzero_reduce),
            )

        def pair_step(carry, _):
            e0, e1 = noise_pair(carry[-1])
            carry = micro_step(carry, e0.astype(dtype))
            carry = micro_step(carry, e1.astype(dtype))
            return carry, None

        def odd_tail(carry):
            e0, _ = noise_pair(carry[-1])
            return micro_step(carry, e0.astype(dtype))

        zc = jnp.zeros((c_local,), dtype)
        init = (
            state.phi, zc, zc, zc, zc, zc, zc, jnp.zeros_like(state.corr_mean),
            jnp.zeros((c_local,), bool), state.lrg_vl, state.step,
        )
        carry, _ = lax.scan(pair_step, init, None, length=cfg.loops // 2)
        if cfg.loops % 2:
            carry = odd_tail(carry)
        phi, ms, m2s, m4s, ams, p2s, acs, cs, unstable, lrgvl, step_end = carry

        accept = ~unstable
        au = accept.reshape((c_local,) + (1,) * ndim)
        phi = jnp.where(au, phi, state.phi)
        # merge frame sums into running means (integrators/accum.py)
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

        grow = accept & (state.stab_cnt >= cfg.grow_after)
        dtau = jnp.where(
            grow,
            state.dtau / cfg.shrink,
            jnp.where(accept, state.dtau, state.dtau * cfg.shrink),
        )
        if cfg.dtau_max is not None:
            dtau = jnp.minimum(dtau, jnp.asarray(cfg.dtau_max, dtype))
        stab_cnt = jnp.where(accept, jnp.where(grow, 0, state.stab_cnt + 1), 0)

        new_state = FieldState(
            phi=phi, mag_mean=mm, mag2_mean=m2m, mag4_mean=m4m,
            absmag_mean=amm,
            phi2_mean=p2m, act_mean=am, corr_mean=cm,
            runs=runs, dtau=dtau, stab_cnt=stab_cnt, lrg_vl=lrgvl, step=step_end,
        )
        metrics = {"stable": accept, "dtau": dtau, "max_phi": lrgvl}
        return new_state, metrics

    _cache = {}

    def _runner(n_frames: int):
        if n_frames not in _cache:
            sharded = shard_map(
                lambda s: lax.scan(lambda st, _: frame(st), s, None, length=n_frames),
                mesh=mesh,
                in_specs=(state_spec,),
                out_specs=(state_spec, metrics_spec),
                check_vma=False,
            )
            _cache[n_frames] = jax.jit(sharded)
        return _cache[n_frames]

    def run(state: FieldState, n_frames: int):
        return _runner(n_frames)(state)

    return run
