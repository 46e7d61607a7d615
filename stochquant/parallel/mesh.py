"""Device mesh construction and state placement.

The reference runs on exactly one OpenCL device chosen by a CLI index
(``tauhost.c:201-209``); here scale-out is a first-class config: chains
shard over a ``'chain'`` mesh axis (data parallel — SURVEY.md §2.5), lattice
dimensions shard over spatial axes (domain decomposition), and the same
program spans hosts via ``jax.distributed`` (parallel/distributed.py).

Because the noise is keyed by *global* (chain, site, step) coordinates
(rng.py), any placement produces bit-identical field trajectories — tested
in tests/test_parallel.py.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stochquant.config import FieldConfig
from stochquant.integrators.field import FieldState
from stochquant.integrators.langevin import ChainState


def make_mesh(axes: Sequence[Tuple[str, int]], devices=None) -> Mesh:
    """Build a mesh from (name, size) pairs, e.g. [("chain", 2), ("x", 4)]."""
    names = [n for n, _ in axes]
    sizes = [s for _, s in axes]
    if devices is None:
        devices = jax.devices()
    n = int(np.prod(sizes))
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(sizes)
    return Mesh(dev, tuple(names))


def chain_state_sharding(mesh: Mesh, chain_axis: Optional[str]) -> ChainState:
    """NamedShardings for each ChainState leaf: chains sharded, sites local."""
    row = NamedSharding(mesh, P(chain_axis))
    mat = NamedSharding(mesh, P(chain_axis, None))
    rep = NamedSharding(mesh, P())
    return ChainState(
        f=mat, omega=row, x_mean=mat, xx0_mean=mat, x2_mean=mat,
        x4_mean=mat,
        runs=row, dtau=row, stab_cnt=row, lrg_vl=row, spec_mean=mat, step=rep,
    )


def shard_chain_state(state: ChainState, mesh: Mesh, chain_axis: str = "chain") -> ChainState:
    sh = chain_state_sharding(mesh, chain_axis)
    return jax.tree.map(jax.device_put, state, sh)


def field_state_sharding(
    mesh: Mesh,
    cfg: FieldConfig,
) -> FieldState:
    """NamedShardings for FieldState: phi over (chain, *mesh_axes); per-chain
    scalars over chain; the time-slice correlator over (chain, axis0)."""
    ca = cfg.mesh_chain_axis
    lat = cfg.mesh_axes or (None,) * cfg.ndim
    row = NamedSharding(mesh, P(ca))
    rep = NamedSharding(mesh, P())
    phi = NamedSharding(mesh, P(ca, *lat))
    corr = NamedSharding(mesh, P(ca, lat[0]))
    return FieldState(
        phi=phi, mag_mean=row, mag2_mean=row, mag4_mean=row, absmag_mean=row,
        phi2_mean=row, act_mean=row, corr_mean=corr,
        runs=row, dtau=row, stab_cnt=row, lrg_vl=row, step=rep,
    )


def shard_field_state(state: FieldState, mesh: Mesh, cfg: FieldConfig) -> FieldState:
    sh = field_state_sharding(mesh, cfg)
    return jax.tree.map(jax.device_put, state, sh)
