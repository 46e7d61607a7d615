"""Checkpoint tests: strict resume (run 2k == run k, save, load, run k),
codec round-trips, and C++-vs-Python reference-format parity."""

import numpy as np

from stochquant.integrators import accum
import pytest

from stochquant import actions, oracle
from stochquant.config import ChainConfig, FieldConfig
from stochquant.integrators import field as fieldmod
from stochquant.integrators import langevin
from stochquant.io import checkpoint, reference_fmt
from stochquant.actions import phi4


def test_chain_checkpoint_resume_bitwise(tmp_path):
    cfg = ChainConfig(
        action="double_well", n_sites=24, dt=0.1, dtau=0.0005, n_chains=3,
        loops=20, seed=8,
    )
    act = actions.get(cfg.action)
    s0 = langevin.init_chain_state(cfg, act)
    full, _ = langevin.run_frames(s0, act, cfg, 6)

    half, _ = langevin.run_frames(s0, act, cfg, 3)
    p = tmp_path / "ck.npz"
    checkpoint.save(p, half, cfg)
    loaded, cfg2 = checkpoint.load(p)
    assert cfg2 == cfg
    resumed, _ = langevin.run_frames(loaded, act, cfg2, 3)
    for name, a, b in zip(full._fields, full, resumed):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


def test_field_checkpoint_resume_bitwise(tmp_path):
    cfg = FieldConfig(action="phi4", shape=(8, 8), dtau=0.01, n_chains=2, loops=10, seed=3)
    act = phi4.get_field("phi4")
    s0 = fieldmod.init_field_state(cfg)
    full, _ = fieldmod.run_field_frames(s0, act, cfg, 4)
    half, _ = fieldmod.run_field_frames(s0, act, cfg, 2)
    p = tmp_path / "ck.npz"
    checkpoint.save(p, half, cfg)
    loaded, cfg2 = checkpoint.load(p)
    resumed, _ = fieldmod.run_field_frames(loaded, act, cfg2, 2)
    for name, a, b in zip(full._fields, full, resumed):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


def test_reference_fmt_roundtrip_python(tmp_path):
    rng = np.random.default_rng(0)
    N = 17
    arrs = [rng.normal(size=N) for _ in range(4)]
    p = tmp_path / "ref.txt"
    reference_fmt.write(p, *arrs, omega=1.2345, runs=42000, dtau=3.25e-4)
    d = reference_fmt.read(p, N)
    for got, want in zip([d["xavg"], d["xx0"], d["x"], d["f"]], arrs):
        np.testing.assert_array_equal(got, want)  # hex float: exact
    assert d["omega"] == 1.2345
    assert d["runs"] == 42000
    np.testing.assert_allclose(d["dtau"], 3.25e-4, rtol=1e-15)


def test_reference_fmt_cpp_python_parity(tmp_path):
    """The native codec (C %a) and the Python codec (float.hex) must read
    each other's files exactly."""
    rng = np.random.default_rng(1)
    N = 9
    arrs = [rng.normal(size=N) for _ in range(4)]
    p_c = tmp_path / "c.txt"
    oracle.write_reference_checkpoint(p_c, *arrs, omega=0.7, runs=100, dtau=1e-3, width=30)
    d_py = reference_fmt.read(p_c, N)
    for got, want in zip([d_py["xavg"], d_py["xx0"], d_py["x"], d_py["f"]], arrs):
        np.testing.assert_array_equal(got, want)

    p_py = tmp_path / "py.txt"
    reference_fmt.write(p_py, *arrs, omega=0.7, runs=100, dtau=1e-3)
    d_c = oracle.read_reference_checkpoint(p_py, N)
    for got, want in zip([d_c["xavg"], d_c["xx0"], d_c["x"], d_c["f"]], arrs):
        np.testing.assert_array_equal(got, want)
    assert d_c["omega"] == 0.7 and d_c["runs"] == 100


def test_import_reference_into_chain_state(tmp_path):
    cfg = ChainConfig(action="double_well", n_sites=12, dt=0.1, dtau=0.001, n_chains=2)
    rng = np.random.default_rng(2)
    arrs = [rng.normal(size=12) for _ in range(4)]
    p = tmp_path / "ref.txt"
    reference_fmt.write(p, *arrs, omega=0.55, runs=7, dtau=0.01)
    st = checkpoint.import_reference(p, cfg)
    assert st.f.shape == (2, 12)
    np.testing.assert_allclose(np.asarray(st.f)[0], arrs[3], rtol=1e-6)
    # dtau clamped to cfg value like tauhost.c:131-137
    np.testing.assert_allclose(float(np.asarray(st.dtau)[0]), cfg.dtau, rtol=1e-6)
    act = actions.get(cfg.action)
    out, _ = langevin.run_frames(st, act, cfg, 1)  # must run
    assert np.all(np.isfinite(np.asarray(out.f)))


def test_export_reference_roundtrip(tmp_path):
    cfg = ChainConfig(action="double_well", n_sites=16, dt=0.1, dtau=0.0005, n_chains=2, loops=10)
    act = actions.get(cfg.action)
    s, _ = langevin.run_frames(langevin.init_chain_state(cfg, act), act, cfg, 2)
    p = tmp_path / "exp.txt"
    checkpoint.export_reference(p, s, chain=1)
    d = reference_fmt.read(p, 16)
    np.testing.assert_allclose(d["f"], np.asarray(s.f)[1], rtol=1e-7)
    assert d["runs"] == int(accum.runs_total(s.runs)[1])


def test_load_backfills_pre_r2_moment_channels(tmp_path):
    """Checkpoints written before the <x^4>/<M^4> channels existed must still
    load: missing moment leaves are zero-backfilled (with a warning), and
    the trajectory resumes bitwise."""
    import warnings

    import jax.numpy as jnp

    from stochquant import actions
    from stochquant.config import ChainConfig
    from stochquant.integrators import langevin
    from stochquant.io import checkpoint as ckpt

    cfg = ChainConfig(action="harmonic", n_sites=16, dt=0.2, dtau=1e-3,
                      n_chains=2, loops=10, seed=33)
    act = actions.get(cfg.action)
    state, _ = langevin.run_frames(langevin.init_chain_state(cfg, act), act, cfg, 2)
    p = tmp_path / "new.npz"
    ckpt.save(p, state, cfg)

    # rewrite the file without the r2 moment channel (simulating r1 format)
    z = dict(np.load(p))
    del z["state_x4_mean"]
    with open(tmp_path / "old.npz", "wb") as fh:
        np.savez(fh, **z)

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        loaded, lcfg = ckpt.load(tmp_path / "old.npz")
    assert any("x4_mean" in str(x.message) for x in w)
    assert lcfg == cfg
    np.testing.assert_array_equal(np.asarray(loaded.x4_mean), 0.0)
    np.testing.assert_array_equal(np.asarray(loaded.f), np.asarray(state.f))
    # resumes and runs
    cont, _ = langevin.run_frames(loaded, act, cfg, 1)
    ref, _ = langevin.run_frames(state, act, cfg, 1)
    np.testing.assert_array_equal(np.asarray(cont.f), np.asarray(ref.f))


def test_load_upgrades_pre_r3_scalar_runs(tmp_path):
    """Pre-r3 checkpoints stored `runs` as a (C,) uint32; the loader must
    upgrade it to the (C, 2) (lo, hi) pair with hi = 0 so old checkpoints
    resume bitwise-continuously."""
    import json

    from stochquant.actions import phi4 as phi4_mod
    from stochquant.config import FieldConfig
    from stochquant.integrators import field as field_mod
    from stochquant.io import checkpoint as ckpt

    cfg = FieldConfig(action="phi4", shape=(8, 8), n_chains=2, loops=4, frames=1)
    act = phi4_mod.get_field(cfg.action)
    state, _ = field_mod.run_field_frames(field_mod.init_field_state(cfg), act, cfg, 1)
    p = tmp_path / "old.npz"
    ckpt.save(str(p), state, cfg)
    # rewrite as the old schema: scalar (C,) runs
    with np.load(str(p)) as z:
        payload = {k: z[k] for k in z.files}
    assert payload["state_runs"].shape == (2, 2)
    payload["state_runs"] = payload["state_runs"][:, 0]
    np.savez(str(p), **payload)

    restored, _ = ckpt.load(str(p))
    assert np.asarray(restored.runs).shape == (2, 2)
    np.testing.assert_array_equal(np.asarray(restored.runs), np.asarray(state.runs))
    # and the restored state keeps running
    s2, _ = field_mod.run_field_frames(restored, act, cfg, 1)
    assert np.all(np.asarray(s2.runs)[:, 0] > 0)


def _gauge_state_and_cfg():
    from stochquant.integrators import gauge as gauge_mod

    cfg = gauge_mod.GaugeConfig(group="su3", beta=5.0, shape=(4, 4), n_chains=2)
    act = gauge_mod.resolve_gauge_action(cfg)
    return gauge_mod.init_gauge_state(cfg, act), cfg


def _chain_state_and_cfg():
    cfg = ChainConfig(action="harmonic", n_sites=8, n_chains=2, loops=2)
    return langevin.init_chain_state(cfg, actions.get(cfg.action)), cfg


def _field_state_and_cfg():
    cfg = FieldConfig(action="phi4", shape=(4, 4), n_chains=2, loops=2)
    return fieldmod.init_field_state(cfg), cfg


# config fields earlier versions wrote for kernels that no longer exist
_OLD_FIELDS = {
    "chain": {"frames_per_launch": 4, "block_chains": 128, "rng_impl": "hardware"},
    "field": {"frames_per_launch": 2, "tile_rows": 8, "exchange_steps": 4,
              "prefer_rdma": True, "rng_impl": "hardware"},
    "gauge": {"frames_per_launch": 8, "exchange_steps": 4},
}


@pytest.mark.parametrize(
    "kind,make",
    [("chain", _chain_state_and_cfg), ("field", _field_state_and_cfg),
     ("gauge", _gauge_state_and_cfg)],
)
def test_load_drops_removed_config_fields(tmp_path, kind, make):
    """Checkpoints written before the kernel options were removed still
    load: the removed fields are dropped, the state is bitwise intact and a
    'hardware' noise generator reads as the counter-based default."""
    import json

    state, cfg = make()
    p = tmp_path / "old.npz"
    checkpoint.save(p, state, cfg)
    with np.load(p) as z:
        payload = {k: z[k] for k in z.files}
    meta = json.loads(bytes(payload["meta"].tobytes()).decode())
    old_cfg = json.loads(meta["config"])
    old_cfg.update(_OLD_FIELDS[kind])
    meta["config"] = json.dumps(old_cfg)
    payload["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    with open(p, "wb") as fh:
        np.savez(fh, **payload)

    loaded, cfg2 = checkpoint.load(p)
    assert cfg2 == cfg
    for name, a, b in zip(state._fields, state, loaded):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


def test_complex_leaves_round_trip_directly(tmp_path):
    """Complex state (su3 links) is saved and restored as complex arrays."""
    state, cfg = _gauge_state_and_cfg()
    state = state._replace(links=state.links * (1 + 0.5j))
    p = tmp_path / "c.npz"
    checkpoint.save(p, state, cfg)
    with np.load(p) as z:
        assert np.iscomplexobj(z["state_links"])
    loaded, _ = checkpoint.load(p)
    np.testing.assert_array_equal(np.asarray(loaded.links), np.asarray(state.links))
