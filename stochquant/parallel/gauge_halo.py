"""Gauge-sector domain decomposition: links sharded over mesh axes with
1-site halo exchange (r4, VERDICT r3 item 5).

The gauge drift for link U_μ(x) reads neighbours at most one lattice site
away in each direction — the backward staple reaches U_ν(x+μ̂−ν̂)
(actions/gauge.py:_staple_sum), a CORNER displacement — so a 1-site halo per
split dim, exchanged two-phase in ascending dim order (each later phase
ships the earlier phases' halos along, exactly like parallel/halo.py's
field extension), suffices for every group.  Per micro-step each shard:

1. ring-``ppermute``s its boundary link slices (every direction's links at
   once — the state array carries all D directions);
2. evaluates the FULL drift on the extended block (the action's
   ``jnp.roll`` stencils are exact for every owned site; the halo sites'
   own drift values read wrapped garbage and are sliced away);
3. draws the owned block's noise from global (chain, link, step) Threefry
   counters — bitwise the unsharded field, so the sharded trajectory
   equals the unsharded one by construction (tests/test_gauge_halo.py);
4. applies the exact group update to the OWNED links only;
5. reduces detector statistics (``pmax``: exact) and the per-site
   plaquette density (``psum``; tolerance-gated) across the mesh.

This is SURVEY.md §2.5's spatial-decomposition row applied to the gauge
sector — the scaling path for lattices beyond one device's memory, composing
with chain data parallelism via ``cfg.mesh_chain_axis`` (the reference has
no gauge sector to cite — this is a beyond-reference capability).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from stochquant import rng
from stochquant.integrators import accum
from stochquant.integrators.gauge import GaugeConfig, GaugeState

__all__ = [
    "make_gauge_halo_runner",
    "shard_gauge_state",
    "gauge_state_sharding",
]


def _axis_sizes(mesh: Mesh):
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def gauge_state_sharding(action, mesh: Mesh, cfg: GaugeConfig):
    """Per-field NamedShardings for a GaugeState on ``mesh`` under
    ``cfg.mesh_axes`` / ``cfg.mesh_chain_axis``."""
    ndim = cfg.ndim
    ca = cfg.mesh_chain_axis
    lat = cfg.mesh_axes or (None,) * ndim
    lat_axes = action.lattice_axes(ndim)
    links_rank = len(action.state_shape(cfg.n_chains, ndim, cfg.shape))
    spec = [None] * links_rank
    spec[0] = ca
    for d, ax in enumerate(lat):
        spec[lat_axes[d]] = ax
    links_spec = P(*spec)
    chain_spec = P(ca)
    specs = GaugeState(
        links=links_spec,
        plaq_mean=chain_spec,
        drift_max=chain_spec,
        runs=chain_spec,
        dtau=chain_spec,
        stab_cnt=chain_spec,
        step=P(),
    )
    return jax.tree.map(
        lambda sp: jax.sharding.NamedSharding(mesh, sp), specs,
        is_leaf=lambda x: isinstance(x, P),
    )


def shard_gauge_state(state: GaugeState, action, mesh: Mesh, cfg: GaugeConfig):
    """Place a GaugeState onto the mesh per ``gauge_state_sharding``."""
    sh = gauge_state_sharding(action, mesh, cfg)
    return jax.tree.map(jax.device_put, state, sh)


def make_gauge_halo_runner(action, cfg: GaugeConfig, mesh: Mesh):
    """Build ``run(state, n_frames) -> (state, metrics)`` executing the
    gauge frame loop under shard_map with explicit 1-site halo exchange.

    ``cfg.mesh_axes`` names the mesh axis per lattice dim (None =
    unsharded); ``cfg.mesh_chain_axis`` optionally shards chains.  State
    must be placed with :func:`shard_gauge_state`.  Cooling is not
    supported under the halo runner (its smearing stencil would need wider
    halos); complexified groups work the same way as compact ones (their
    drift has the same 1-site stencil radius)."""
    if cfg.mesh_axes is None:
        raise ValueError("cfg.mesh_axes required for the gauge halo runner")
    if cfg.cooling_rate > 0.0:
        raise ValueError(
            "gauge cooling is not supported under the halo runner (wider "
            "stencil); run unsharded or disable cooling"
        )
    ndim = cfg.ndim
    shape = tuple(cfg.shape)
    C = cfg.n_chains
    ca = cfg.mesh_chain_axis
    lat_spec = tuple(cfg.mesh_axes)
    sizes = _axis_sizes(mesh)
    local_shape = tuple(
        s // (sizes[ax] if ax else 1) for s, ax in zip(shape, lat_spec)
    )
    for s, ls, ax in zip(shape, local_shape, lat_spec):
        if ax and ls * sizes[ax] != s:
            raise ValueError(f"lattice dim {s} not divisible by mesh axis {ax}")
    c_local = C // (sizes[ca] if ca else 1)
    sharded_dims = tuple(bool(ax) and sizes[ax] > 1 for ax in lat_spec)
    lat_mesh_axes = tuple(ax for ax in lat_spec if ax)
    volume = float(np.prod(shape))
    cap = jnp.float32(cfg.drift_cap)

    lat_axes_state = action.lattice_axes(ndim)
    lat_axes_noise = action.noise_lattice_axes(ndim)
    noise_shape_loc = action.noise_shape(c_local, ndim, local_shape)
    noise_shape_glob = action.noise_shape(1, ndim, shape)[1:]

    def psum_lat(v):
        return lax.psum(v, lat_mesh_axes) if lat_mesh_axes else v

    def pmax_lat(v):
        return lax.pmax(v, lat_mesh_axes) if lat_mesh_axes else v

    def pany_lat(v):
        if not lat_mesh_axes:
            return v
        return lax.pmax(v.astype(jnp.int32), lat_mesh_axes) > 0

    def local_offsets():
        ch_off = (lax.axis_index(ca) * c_local) if ca else 0
        lat_off = tuple(
            (lax.axis_index(ax) * ls) if ax else 0
            for ax, ls in zip(lat_spec, local_shape)
        )
        return ch_off, lat_off

    def extend(x, lat_axes):
        """1-site halos along every split lattice dim, ascending (two-phase
        concat: corners ride the neighbours' already-extended slices)."""
        for d in range(ndim):
            if not sharded_dims[d]:
                continue
            ax = lat_spec[d]
            axis = lat_axes[d]
            n = sizes[ax]
            L = x.shape[axis]
            first = lax.slice_in_dim(x, 0, 1, axis=axis)
            last = lax.slice_in_dim(x, L - 1, L, axis=axis)
            down = lax.ppermute(first, ax, [((i + 1) % n, i) for i in range(n)])
            up = lax.ppermute(last, ax, [((i - 1) % n, i) for i in range(n)])
            x = jnp.concatenate([up, x, down], axis=axis)
        return x

    def owned(x, lat_axes):
        """Slice the owned block back out of an extended array."""
        idx = [slice(None)] * x.ndim
        for d in range(ndim):
            if sharded_dims[d]:
                idx[lat_axes[d]] = slice(1, 1 + local_shape[d])
        return x[tuple(idx)]

    # metrics / state specs for shard_map
    links_rank = len(action.state_shape(C, ndim, shape))
    lspec = [None] * links_rank
    lspec[0] = ca
    for d, ax in enumerate(lat_spec):
        lspec[lat_axes_state[d]] = ax
    state_spec = GaugeState(
        links=P(*lspec),
        plaq_mean=P(ca), drift_max=P(ca), runs=P(ca), dtau=P(ca),
        stab_cnt=P(ca), step=P(),
    )
    metrics_spec = {
        "stable": P(None, ca), "dtau": P(None, ca),
        "drift_max": P(None, ca), "unitarity_norm": P(None, ca),
    }

    def frame(state: GaugeState):
        ch_off, lat_off = local_offsets()
        noise_offs = [0] * (len(noise_shape_loc) - 1)
        for d in range(ndim):
            noise_offs[lat_axes_noise[d] - 1] = lat_off[d]

        def substep(carry, eta):
            links, ps, dmax, unstable = carry

            ext = extend(links, lat_axes_state)
            f = owned(action.drift(ext, ndim), action.lattice_axes(ndim))
            dnorm = pmax_lat(action.drift_norm(f))

            scale = jnp.minimum(1.0, cap / jnp.maximum(dnorm, 1e-30))
            dtau_eff = (state.dtau * scale).reshape(
                (c_local,) + (1,) * (f.ndim - 1)
            )
            omega = dtau_eff * f + jnp.sqrt(2.0 * dtau_eff).astype(
                f.dtype
            ) * action.noise_to_tangent(eta)

            new_links = action.apply_update(links, omega)
            bad = pany_lat(
                ~jnp.all(
                    jnp.isfinite(new_links)
                    if not jnp.iscomplexobj(new_links)
                    else jnp.isfinite(jnp.real(new_links))
                    & jnp.isfinite(jnp.imag(new_links)),
                    axis=tuple(range(1, new_links.ndim)),
                )
            )

            # observable samples the pre-update links: per-site plaquette
            # density on the extended block, owned sites summed then psum'd
            psm = action.plaquette_site_mean(ext, ndim)
            psm_owned = owned(psm, tuple(range(1, 1 + ndim)))
            plaq = psum_lat(
                jnp.sum(psm_owned, axis=tuple(range(1, psm_owned.ndim)))
            ) / volume
            ps_n = ps + plaq
            dmax_n = jnp.maximum(dmax, dnorm)

            u = unstable.reshape((c_local,) + (1,) * (new_links.ndim - 1))
            links = jnp.where(u, links, new_links)
            keep = lambda new, old: jnp.where(unstable, old, new)
            ps = keep(ps_n, ps)
            dmax = keep(dmax_n, dmax)
            unstable = unstable | bad
            return (links, ps, dmax, unstable)

        def noise_pair(step):
            return rng.normal_pair_for_shape(
                cfg.seed, rng.Stream.FIELD, step, noise_shape_loc,
                global_lattice_shape=noise_shape_glob,
                chain_offset=ch_off,
                lattice_offsets=tuple(noise_offs),
            )

        def pair_step(carry, _):
            *vals, step = carry
            e0, e1 = noise_pair(step)
            vals = substep(tuple(vals), e0)
            vals = substep(vals, e1)
            return (*vals, step + 2), None

        init = (
            state.links, jnp.zeros_like(state.plaq_mean), state.drift_max,
            jnp.zeros((c_local,), bool), state.step,
        )
        carry, _ = lax.scan(pair_step, init, None, length=cfg.loops // 2)
        if cfg.loops % 2:
            *vals, step = carry
            e0, _ = noise_pair(step)
            vals = substep(tuple(vals), e0)
            carry = (*vals, step + 1)
        links, ps, dmax, unstable, step_end = carry

        n_new = accum.runs_after(state.runs, cfg.loops)
        pm = accum.merge_frame_sum(state.plaq_mean, ps, cfg.loops, n_new)
        accept = ~unstable
        au = accept.reshape((c_local,) + (1,) * (links.ndim - 1))
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
        # unitarity norm needs no halo (per-link); pmax completes the
        # lattice max across shards
        un = pmax_lat(action.unitarity_norm(new_state.links, ndim))
        metrics = {
            "stable": accept,
            "dtau": dtau,
            "drift_max": dmax,
            "unitarity_norm": un,
        }
        return new_state, metrics

    _cache = {}

    def _runner(n_frames: int):
        if n_frames not in _cache:
            sharded = shard_map(
                lambda s: lax.scan(
                    lambda st, _: frame(st), s, None, length=n_frames
                ),
                mesh=mesh,
                in_specs=(state_spec,),
                out_specs=(state_spec, metrics_spec),
                check_vma=False,
            )
            _cache[n_frames] = jax.jit(sharded)
        return _cache[n_frames]

    def run(state: GaugeState, n_frames: int):
        return _runner(n_frames)(state)

    return run
