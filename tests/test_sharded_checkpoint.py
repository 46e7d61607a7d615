"""Sharded checkpoint save/restore (SURVEY.md §5, VERDICT r1 item 4).

Each process writes only its addressable shards; restore rebuilds global
arrays on the caller's mesh without any host-side gather.  On the 8-device
virtual CPU mesh a single process owns all shards, which exercises the whole
index-matching path; the true multi-host cycle (save → kill → new processes
resume) lives in tests/test_multiprocess.py.
"""

import dataclasses

import jax
import numpy as np
import pytest

from stochquant import metrics, runtime
from stochquant.actions import phi4 as phi4_mod
from stochquant.config import FieldConfig
from stochquant.integrators import field as field_mod
from stochquant.io import checkpoint as ckpt
from stochquant.parallel import make_mesh, shard_field_state
from stochquant.parallel.halo import make_halo_runner


def _halo_cfg(**kw):
    base = dict(
        action="phi4", shape=(8, 8), dtau=0.01, n_chains=4, loops=4,
        frames=2, seed=21, mesh_axes=("x", "y"), mesh_chain_axis="chain",
    )
    base.update(kw)
    return FieldConfig(**base)


def _mesh():
    return make_mesh([("chain", 2), ("x", 2), ("y", 2)])


def test_sharded_roundtrip_bitwise_and_resume_continues():
    cfg = _halo_cfg()
    mesh = _mesh()
    act = phi4_mod.get_field(cfg.action)
    state = shard_field_state(field_mod.init_field_state(cfg), mesh, cfg)
    runner = make_halo_runner(act, cfg, mesh)

    s2, _ = runner(state, 2)
    import tempfile, os

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ck")
        out = ckpt.save_sharded(path, s2, cfg, frames_done=2)
        assert out.endswith(".proc0-of-1.npz")
        assert ckpt.is_sharded_checkpoint(path)
        assert ckpt.read_meta_any(path)["frames_done"] == 2

        restored, loaded_cfg = ckpt.load_sharded(path, mesh)
        assert loaded_cfg.shape == cfg.shape
        for name, want, got in zip(s2._fields, s2, restored):
            np.testing.assert_array_equal(
                np.asarray(want), np.asarray(got), err_msg=name
            )
            # placement must be restored too, not just values
            if getattr(want, "sharding", None) is not None and want.ndim:
                assert got.sharding.spec == want.sharding.spec, name

        # resume-then-run equals straight-through bitwise
        s3_direct, _ = runner(s2, 1)
        s3_resumed, _ = runner(restored, 1)
        for name, a, b in zip(s3_direct._fields, s3_direct, s3_resumed):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b), err_msg=name
            )


def test_runtime_field_halo_sharded_checkpoint_cycle(tmp_path):
    """runtime.run_field on the halo path: write a (sharded-format)
    checkpoint mid-run, then resume through the runtime and match the
    uninterrupted run bitwise."""
    cfg = _halo_cfg(frames=4)
    mesh = _mesh()
    act = phi4_mod.get_field(cfg.action)

    # uninterrupted reference
    full_state = shard_field_state(field_mod.init_field_state(cfg), mesh, cfg)
    runner = make_halo_runner(act, cfg, mesh)
    full, _ = runner(full_state, 4)

    ck = tmp_path / "halo_ck"
    # force the sharded writer (single process is fully addressable, so
    # save_auto would pick the single-file format here)
    half_cfg = dataclasses.replace(cfg, frames=2)
    res = runtime.run_field(half_cfg, mesh=mesh, sink=metrics.MetricsSink())
    ckpt.save_sharded(str(ck), res.state, cfg, frames_done=2)

    res2 = runtime.run_field(
        cfg, mesh=mesh, sink=metrics.MetricsSink(),
        checkpoint_in=str(ck), resume_progress=True,
    )
    for name, a, b in zip(full._fields, full, res2.state):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


def test_load_sharded_rejects_misaligned_mesh():
    cfg = _halo_cfg()
    mesh = _mesh()
    act = phi4_mod.get_field(cfg.action)
    state = shard_field_state(field_mod.init_field_state(cfg), mesh, cfg)
    import tempfile, os

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ck")
        ckpt.save_sharded(path, state, cfg)
        # a mesh with different shard boundaries on 'x' must be refused,
        # not silently misassembled
        bad_mesh = make_mesh([("chain", 1), ("x", 4), ("y", 2)])
        with pytest.raises(ValueError, match="missing shard"):
            ckpt.load_sharded(path, bad_mesh)


def test_resave_prunes_stale_shard_generations(tmp_path, monkeypatch):
    """Re-saving under a different process count must not leave the old
    generation's shard files behind (they sort after the fresh ones and
    would shadow them in the loader) — ADVICE r2 medium #1."""
    cfg = _halo_cfg()
    mesh = _mesh()
    state = shard_field_state(field_mod.init_field_state(cfg), mesh, cfg)
    path = str(tmp_path / "ck")

    # generation 1: pretend this single process is 1-of-4
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    ckpt.save_sharded(path, state, cfg)
    monkeypatch.undo()
    assert (tmp_path / "ck.proc0-of-4.npz").exists()

    # generation 2 under the real count supersedes generation 1
    ckpt.save_sharded(path, state, cfg)
    assert not (tmp_path / "ck.proc0-of-4.npz").exists()
    assert (tmp_path / "ck.proc0-of-1.npz").exists()
    restored, _ = ckpt.load_sharded(path, mesh)
    np.testing.assert_array_equal(np.asarray(restored.phi), np.asarray(state.phi))


def test_single_file_resave_supersedes_sharded(tmp_path):
    """A single-file re-save at the same path removes the shard files, so
    resume no longer silently prefers the stale sharded state."""
    cfg = _halo_cfg()
    mesh = _mesh()
    state = shard_field_state(field_mod.init_field_state(cfg), mesh, cfg)
    path = str(tmp_path / "ck")
    ckpt.save_sharded(path, state, cfg)
    assert ckpt.is_sharded_checkpoint(path)
    ckpt.save(path, state, cfg)
    assert not ckpt.is_sharded_checkpoint(path)
    restored, _ = ckpt.load(path)
    np.testing.assert_array_equal(np.asarray(restored.phi), np.asarray(state.phi))


def test_load_sharded_rejects_mixed_generations(tmp_path, monkeypatch):
    """Files from two different save generations under one path must raise,
    not silently interleave stale and fresh arrays."""
    cfg = _halo_cfg()
    mesh = _mesh()
    state = shard_field_state(field_mod.init_field_state(cfg), mesh, cfg)
    path = str(tmp_path / "ck")
    ckpt.save_sharded(path, state, cfg)
    # sneak a second generation in with pruning disabled
    monkeypatch.setattr(ckpt, "_prune_stale_shards", lambda *a, **k: None)
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    ckpt.save_sharded(path, state, cfg)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="mixed shard generations"):
        ckpt.load_sharded(path, mesh)


def test_save_auto_picks_single_file_when_addressable(tmp_path):
    cfg = FieldConfig(action="phi4", shape=(8, 8), n_chains=2, loops=2, frames=1)
    state = field_mod.init_field_state(cfg)
    p = tmp_path / "plain.npz"
    ckpt.save_auto(str(p), state, cfg, frames_done=1)
    assert p.exists() and not ckpt.is_sharded_checkpoint(str(p))
