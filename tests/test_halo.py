"""Explicit shard_map halo-exchange runner vs the single-device integrator:
field trajectory bitwise, observables to float tolerance."""

import dataclasses

import numpy as np
import pytest

from stochquant.actions import phi4
from stochquant.config import FieldConfig
from stochquant.integrators import field
from stochquant.parallel import make_mesh, shard_field_state
from stochquant.parallel.halo import halo_shifted, make_halo_runner


@pytest.mark.parametrize(
    "mesh_axes,mesh_shape,chain_ax",
    [
        (("x", None), [("x", 4)], None),
        (("x", "y"), [("x", 2), ("y", 2)], None),
        (("x", "y"), [("chain", 2), ("x", 2), ("y", 2)], "chain"),
    ],
)
def test_halo_runner_matches_unsharded(mesh_axes, mesh_shape, chain_ax):
    cfg = FieldConfig(
        action="phi4",
        shape=(16, 16),
        dtau=0.01,
        n_chains=4,
        loops=8,
        seed=77,
    )
    act = phi4.get_field("phi4")
    s0 = field.init_field_state(cfg)
    ref, ref_metrics = field.run_field_frames(s0, act, cfg, 3)

    cfg_sh = dataclasses.replace(
        cfg, mesh_axes=mesh_axes, mesh_chain_axis=chain_ax
    )
    mesh = make_mesh(mesh_shape)
    runner = make_halo_runner(act, cfg_sh, mesh)
    s0_sh = shard_field_state(s0, mesh, cfg_sh)
    out, out_metrics = runner(s0_sh, 3)

    np.testing.assert_array_equal(np.asarray(ref.phi), np.asarray(out.phi))
    np.testing.assert_array_equal(
        np.asarray(ref_metrics["stable"]), np.asarray(out_metrics["stable"])
    )
    for name in ["mag_mean", "phi2_mean", "act_mean"]:
        np.testing.assert_allclose(
            np.asarray(getattr(ref, name)),
            np.asarray(getattr(out, name)),
            rtol=1e-5,
            atol=1e-7,
            err_msg=name,
        )
    np.testing.assert_allclose(
        np.asarray(ref.corr_mean), np.asarray(out.corr_mean), rtol=1e-4, atol=1e-6
    )


def test_halo_runner_4d():
    cfg = FieldConfig(
        action="free_field",
        shape=(4, 4, 4, 4),
        dtau=0.02,
        n_chains=2,
        loops=5,
        seed=5,
        mesh_axes=("x", None, "y", None),
    )
    act = phi4.get_field("free_field")
    s0 = field.init_field_state(cfg)
    cfg_ref = dataclasses.replace(cfg, mesh_axes=None)
    ref, _ = field.run_field_frames(s0, act, cfg_ref, 2)

    mesh = make_mesh([("x", 2), ("y", 2)])
    runner = make_halo_runner(act, cfg, mesh)
    s0_sh = shard_field_state(s0, mesh, cfg)
    out, _ = runner(s0_sh, 2)
    np.testing.assert_array_equal(np.asarray(ref.phi), np.asarray(out.phi))
    np.testing.assert_allclose(
        np.asarray(ref.phi2_mean), np.asarray(out.phi2_mean), rtol=1e-5, atol=1e-7
    )


def test_halo_runner_checkerboard_matches_unsharded():
    from stochquant.config import Sweep

    cfg = FieldConfig(
        action="phi4",
        shape=(16, 16),
        dtau=0.005,
        n_chains=2,
        loops=6,
        seed=19,
        sweep=Sweep.CHECKERBOARD,
    )
    act = phi4.get_field("phi4")
    s0 = field.init_field_state(cfg)
    ref, _ = field.run_field_frames(s0, act, cfg, 2)

    cfg_sh = dataclasses.replace(cfg, mesh_axes=("x", "y"))
    mesh = make_mesh([("x", 2), ("y", 2)])
    runner = make_halo_runner(act, cfg_sh, mesh)
    s0_sh = shard_field_state(s0, mesh, cfg_sh)
    out, _ = runner(s0_sh, 2)
    # the doubled stencil pass gives XLA different FMA-fusion choices per
    # shard shape → 1-ulp float drift; the integer noise path stays exact
    np.testing.assert_allclose(
        np.asarray(ref.phi), np.asarray(out.phi), rtol=3e-5, atol=3e-6
    )


def test_overlap_and_blocking_stencils_bitwise_equal():
    """The overlapped halo stencil (bulk compute independent of the in-flight
    collectives + exact edge fixup) must be bitwise identical to the
    blocking concatenate-then-shift reference."""
    import numpy as np

    from stochquant.actions import phi4 as phi4_mod
    from stochquant.config import FieldConfig
    from stochquant.integrators import field as field_mod
    from stochquant.parallel import make_mesh, shard_field_state
    from stochquant.parallel.halo import make_halo_runner

    cfg = FieldConfig(
        action="phi4", shape=(8, 8), dtau=0.01, n_chains=2, loops=6,
        frames=1, seed=31, mesh_axes=("x", "y"),
    )
    mesh = make_mesh([("x", 4), ("y", 2)])
    act = phi4_mod.get_field(cfg.action)
    s0 = shard_field_state(field_mod.init_field_state(cfg), mesh, cfg)
    a, _ = make_halo_runner(act, cfg, mesh, overlap=True)(s0, 2)
    b, _ = make_halo_runner(act, cfg, mesh, overlap=False)(s0, 2)
    for name, x, y in zip(a._fields, a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)


# The decompositions the halo runner serves, each against the unsharded
# integrator: splits of one or several lattice dims at D = 2, 3 and 4,
# thin slabs (fewer owned rows than the ring has shards' worth of halo),
# chain data parallelism alone and combined with a split, and the
# checkerboard sweep across split dims.
_GEOMETRIES = [
    ("2d-x4", (64, 32), ("x", None), [("x", 4)], None, False),
    ("2d-xy", (32, 64), ("x", "y"), [("x", 2), ("y", 4)], None, False),
    ("2d-y-only", (16, 64), (None, "y"), [("y", 4)], None, False),
    ("2d-x-cb", (32, 16), ("x", None), [("x", 4)], None, True),
    ("3d-x", (8, 4, 4), ("x", None, None), [("x", 2)], None, False),
    ("4d-dim0", (16, 8, 4, 4), ("x", None, None, None), [("x", 4)], None, False),
    ("4d-dim01", (8, 8, 4, 4), ("x", "y", None, None), [("x", 2), ("y", 2)], None, False),
    ("4d-dim02", (8, 4, 8, 4), ("x", None, "y", None), [("x", 2), ("y", 2)], None, False),
    ("4d-thin", (16, 8, 4, 4), ("x", None, None, None), [("x", 8)], None, False),
    ("4d-dim01-cb", (8, 8, 4, 4), ("x", "y", None, None), [("x", 2), ("y", 2)], None, True),
    ("4d-chain-x", (8, 4, 2, 2), ("x", None, None, None), [("chain", 2), ("x", 4)], "chain", False),
    ("2d-chain-only", (16, 16), (None, None), [("chain", 4)], "chain", False),
]


@pytest.mark.parametrize(
    "shape,mesh_axes,mesh_shape,chain_ax,checkerboard",
    [g[1:] for g in _GEOMETRIES], ids=[g[0] for g in _GEOMETRIES],
)
def test_halo_runner_geometries_match_unsharded(
    shape, mesh_axes, mesh_shape, chain_ax, checkerboard
):
    from stochquant.config import Sweep

    cfg = FieldConfig(
        action="phi4", shape=shape, dtau=0.01, n_chains=4, loops=6, seed=7,
        sweep=Sweep.CHECKERBOARD if checkerboard else Sweep.SYNC,
    )
    act = phi4.get_field("phi4")
    s0 = field.init_field_state(cfg)
    ref, mref = field.run_field_frames(s0, act, cfg, 2)
    cfg_sh = dataclasses.replace(cfg, mesh_axes=mesh_axes, mesh_chain_axis=chain_ax)
    mesh = make_mesh(mesh_shape)
    out, mout = make_halo_runner(act, cfg_sh, mesh)(
        shard_field_state(s0, mesh, cfg_sh), 2
    )
    if checkerboard:
        # the doubled stencil pass fuses differently per shard shape: 1-ulp
        # float drift (test_halo_runner_checkerboard_matches_unsharded)
        np.testing.assert_allclose(
            np.asarray(ref.phi), np.asarray(out.phi), rtol=3e-5, atol=3e-6
        )
    else:
        np.testing.assert_array_equal(np.asarray(ref.phi), np.asarray(out.phi))
        np.testing.assert_array_equal(
            np.asarray(ref.lrg_vl), np.asarray(out.lrg_vl)
        )
    np.testing.assert_array_equal(
        np.asarray(mref["stable"]), np.asarray(mout["stable"])
    )
    for name in ("mag_mean", "mag2_mean", "phi2_mean", "act_mean"):
        np.testing.assert_allclose(
            np.asarray(getattr(ref, name)), np.asarray(getattr(out, name)),
            rtol=1e-5, atol=1e-7, err_msg=name,
        )
    np.testing.assert_allclose(
        np.asarray(ref.corr_mean), np.asarray(out.corr_mean), rtol=1e-4, atol=1e-6
    )


def test_run_field_halo_records_xla_path():
    """runtime.run_field on a mesh runs the XLA halo runner, says so in the
    metrics stream, and matches the same runner called directly."""
    from stochquant import metrics, runtime

    cfg = FieldConfig(
        action="phi4", shape=(16, 16), dtau=0.01, n_chains=2, loops=4,
        frames=2, seed=3, mesh_axes=("x", None),
    )
    mesh = make_mesh([("x", 2)])
    recs = []
    res = runtime.run_field(cfg, mesh=mesh, sink=metrics.MetricsSink(callback=recs.append))
    assert [r["path"] for r in recs if r["type"] == "path"] == ["xla"]
    act = phi4.get_field(cfg.action)
    s0 = shard_field_state(field.init_field_state(cfg), mesh, cfg)
    direct, _ = make_halo_runner(act, cfg, mesh)(s0, 2)
    np.testing.assert_array_equal(np.asarray(res.state.phi), np.asarray(direct.phi))
