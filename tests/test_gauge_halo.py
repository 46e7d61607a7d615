"""Gauge domain decomposition (parallel/gauge_halo.py, r4): links sharded
over the mesh with 1-site halo exchange vs the unsharded integrator —
trajectory and trip decisions bitwise (global-counter noise + exact pmax
reductions), plaquette observable to float tolerance."""

import dataclasses

import numpy as np
import pytest

from stochquant.integrators import gauge as gauge_mod
from stochquant.integrators.gauge import GaugeConfig
from stochquant.parallel import make_mesh, shard_gauge_state
from stochquant.parallel.gauge_halo import make_gauge_halo_runner


def _compare(cfg, mesh_shape, frames=2, exact=True):
    act = gauge_mod.resolve_gauge_action(cfg)
    s0 = gauge_mod.init_gauge_state(cfg, act)
    cfg_ref = dataclasses.replace(cfg, mesh_axes=None, mesh_chain_axis=None)
    ref, mref = gauge_mod.run_gauge_frames(s0, act, cfg_ref, frames)

    mesh = make_mesh(mesh_shape)
    s0_sh = shard_gauge_state(s0, act, mesh, cfg)
    out, mout = make_gauge_halo_runner(act, cfg, mesh)(s0_sh, frames)

    assert_links = (
        np.testing.assert_array_equal
        if exact
        else lambda a, b: np.testing.assert_allclose(a, b, rtol=3e-6, atol=3e-6)
    )
    assert_links(np.asarray(ref.links), np.asarray(out.links))
    np.testing.assert_array_equal(
        np.asarray(mref["stable"]), np.asarray(mout["stable"])
    )
    np.testing.assert_array_equal(
        np.asarray(ref.dtau), np.asarray(out.dtau)
    )
    np.testing.assert_allclose(
        np.asarray(ref.drift_max), np.asarray(out.drift_max), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(ref.plaq_mean), np.asarray(out.plaq_mean),
        rtol=1e-5, atol=1e-7,
    )
    return ref, out


@pytest.mark.parametrize(
    "mesh_axes,mesh_shape,chain_ax",
    [
        (("x", None), [("x", 4)], None),
        (("x", "y"), [("x", 2), ("y", 2)], None),
        (("x", "y"), [("chain", 2), ("x", 2), ("y", 2)], "chain"),
    ],
)
def test_u1_halo_matches_unsharded(mesh_axes, mesh_shape, chain_ax):
    cfg = GaugeConfig(
        group="u1", beta=1.0, shape=(8, 8), n_chains=4, dtau=5e-3, loops=6,
        seed=11, hot_start=True, mesh_axes=mesh_axes,
        mesh_chain_axis=chain_ax, grow_after=10**9,
    )
    _compare(cfg, mesh_shape)


def test_su2_halo_matches_unsharded():
    cfg = GaugeConfig(
        group="su2", beta=2.0, shape=(8, 8), n_chains=2, dtau=2e-3, loops=4,
        seed=7, hot_start=True, mesh_axes=("x", "y"), grow_after=10**9,
    )
    _compare(cfg, [("x", 2), ("y", 2)])


def test_su3_halo_matches_unsharded():
    # complex64 einsum contractions can pick different fusion per shape →
    # allow 1-ulp-scale drift on the links; decisions stay exact
    cfg = GaugeConfig(
        group="su3", beta=5.0, shape=(4, 4), n_chains=2, dtau=1e-3, loops=4,
        seed=3, hot_start=True, mesh_axes=("x", None), grow_after=10**9,
    )
    _compare(cfg, [("x", 2)], exact=False)


def test_u1_4d_halo_matches_unsharded():
    cfg = GaugeConfig(
        group="u1", beta=1.0, shape=(4, 4, 2, 2), n_chains=2, dtau=5e-3,
        loops=4, seed=13, hot_start=True,
        mesh_axes=("x", "y", None, None), grow_after=10**9,
    )
    _compare(cfg, [("x", 2), ("y", 2)])


def test_runtime_run_gauge_sharded(tmp_path):
    """runtime.run_gauge(mesh=...) end-to-end: halo runner engaged, the XLA
    path recorded in the metrics stream, and observables healthy."""
    from stochquant import metrics, runtime

    events = []

    class Capture(metrics.MetricsSink):
        def emit(self, obj):
            events.append(obj)
            super().emit(obj)

    cfg = GaugeConfig(
        group="u1", beta=1.0, shape=(8, 8), n_chains=2, dtau=5e-3, loops=4,
        frames=2, seed=5, mesh_axes=("x", None), grow_after=10**9,
    )
    mesh = make_mesh([("x", 2)])
    res = runtime.run_gauge(
        cfg, mesh=mesh, sink=Capture(stream=open("/dev/null", "w"))
    )
    assert res.summary["total_site_updates"] > 0
    paths = [e for e in events if e.get("type") == "path"]
    assert [p["path"] for p in paths] == ["xla"]
    assert paths[0]["sector"] == "gauge"


def test_gauge_cooling_rejected_under_halo():
    cfg = GaugeConfig(
        group="u1", beta=1.0, shape=(8, 8), cooling_rate=0.1,
        mesh_axes=("x", None),
    )
    act = gauge_mod.resolve_gauge_action(cfg)
    mesh = make_mesh([("x", 2)])
    with pytest.raises(ValueError, match="cooling"):
        make_gauge_halo_runner(act, cfg, mesh)


# Every group on every decomposition the halo runner serves: lattice splits
# on one or both dims, thin slabs (2 owned rows per shard), chain data
# parallelism alone and combined with a lattice split.
_GEOMETRIES = [
    ("x2", ("x", None), [("x", 2)], None),
    ("x4-thin", ("x", None), [("x", 4)], None),
    ("y2", (None, "y"), [("y", 2)], None),
    ("xy", ("x", "y"), [("x", 2), ("y", 2)], None),
    ("chain-x", ("x", None), [("chain", 2), ("x", 2)], "chain"),
    ("chain-only", (None, None), [("chain", 2)], "chain"),
]


@pytest.mark.parametrize("group", ["u1", "su2", "su3"])
@pytest.mark.parametrize(
    "mesh_axes,mesh_shape,chain_ax",
    [g[1:] for g in _GEOMETRIES], ids=[g[0] for g in _GEOMETRIES],
)
def test_gauge_halo_groups_by_geometry(group, mesh_axes, mesh_shape, chain_ax):
    beta, dtau = {"u1": (1.0, 5e-3), "su2": (2.0, 2e-3), "su3": (5.0, 1e-3)}[group]
    cfg = GaugeConfig(
        group=group, beta=beta, shape=(8, 4), n_chains=2, dtau=dtau, loops=4,
        seed=21, hot_start=True, mesh_axes=mesh_axes,
        mesh_chain_axis=chain_ax, grow_after=10**9,
    )
    # su3's complex64 contractions may fuse differently per shard shape
    # (1-ulp drift, as in test_su3_halo_matches_unsharded); decisions exact
    _compare(cfg, mesh_shape, exact=group != "su3")
