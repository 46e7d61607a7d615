"""Runtime driver + CLI + metrics smoke tests (CPU, tiny configs)."""

import json

import numpy as np

from stochquant import cli, metrics, runtime
from stochquant.config import ChainConfig, FieldConfig


def test_run_chain_with_metrics_and_checkpoint(tmp_path):
    cfg = ChainConfig(
        action="harmonic", n_sites=16, dt=0.2, dtau=1e-3, n_chains=4,
        loops=10, frames=4, fps=2, seed=1,
    )
    mpath = tmp_path / "m.jsonl"
    ck = tmp_path / "ck.npz"
    with open(mpath, "w") as fh:
        sink = metrics.MetricsSink(stream=fh)
        res = runtime.run_chain(cfg, backend="xla", sink=sink, checkpoint_out=str(ck), burn_frames=1)
    recs = [json.loads(l) for l in open(mpath)]
    frames = [r for r in recs if r["type"] == "frame"]
    assert len(frames) == 2  # 4 frames / fps=2
    assert frames[-1]["percent"] == 100.0
    assert "log_abs_corr" in frames[-1] and len(frames[-1]["log_abs_corr"]) == 16
    assert recs[-1]["type"] == "summary" and recs[-1]["total_site_updates"] > 0
    assert ck.exists()

    # resume from checkpoint through the runtime
    cfg2 = ChainConfig(**{**cfg.__dict__, "frames": 2})
    res2 = runtime.run_chain(cfg2, backend="xla", checkpoint_in=str(ck),
                             sink=metrics.MetricsSink())
    assert int(np.asarray(res2.state.step)) > int(np.asarray(res.state.step)) - 1


def test_run_field_smoke():
    cfg = FieldConfig(
        action="phi4", shape=(8, 8), dtau=0.01, n_chains=2, loops=5,
        frames=2, seed=2,
    )
    res = runtime.run_field(cfg, sink=metrics.MetricsSink())
    assert res.summary["total_site_updates"] == 2 * 64 * 5 * 2


def test_cli_run_and_reference_import(tmp_path, capsys):
    m = tmp_path / "run.jsonl"
    ck = tmp_path / "out.npz"
    cli.main([
        "run", "--preset", "harmosc", "--frames", "2", "--loops", "5",
        "--chains", "2", "--dtau", "1e-3", "--backend", "xla",
        "--metrics", str(m), "--out", str(ck),
    ])
    assert ck.exists() and m.exists()

    # export a reference-format file then import it via the CLI
    from stochquant.io import checkpoint as ckpt
    from stochquant.config import PRESETS

    state, cfg = ckpt.load(ck)
    ref = tmp_path / "ref.txt"
    ckpt.export_reference(ref, state)
    out = tmp_path / "imported.npz"
    cli.main([
        "reference-import", "--file", str(ref), "--preset", "harmosc",
        "--out", str(out),
    ])
    assert out.exists()
    st2, _ = ckpt.load(out)
    assert st2.f.shape[1] == PRESETS["harmosc"].n_sites


def test_cli_complex_preset(tmp_path):
    m = tmp_path / "cl.jsonl"
    cli.main([
        "run", "--preset", "complex_gaussian", "--frames", "2", "--loops", "5",
        "--chains", "8", "--metrics", str(m),
    ])
    recs = [json.loads(l) for l in open(m)]
    frames = [r for r in recs if r["type"] == "frame"]
    assert frames and "re_z2" in frames[-1]


def test_preemption_stop_checkpoints_and_resume_is_bitwise(tmp_path):
    """stop tripping after 2 of 4 frames must checkpoint; --auto-resume-style
    continuation (resume_progress) must reproduce the uninterrupted run
    bitwise (full-state checkpoints incl. RNG step make this exact)."""
    from stochquant.actions import get
    from stochquant.integrators import langevin

    cfg = ChainConfig(
        action="harmonic", n_sites=16, dt=0.2, dtau=1e-3, n_chains=4,
        loops=10, frames=4, seed=3,
    )
    act = get(cfg.action)
    full, _ = langevin.run_frames(langevin.init_chain_state(cfg, act), act, cfg, 4)

    ck = tmp_path / "pre.npz"
    calls = {"n": 0}

    def stop():
        calls["n"] += 1
        return calls["n"] >= 2  # trip at the end of frame 2

    m = tmp_path / "m.jsonl"
    with open(m, "w") as fh:
        runtime.run_chain(
            cfg, backend="xla", sink=metrics.MetricsSink(stream=fh),
            checkpoint_out=str(ck), stop=stop,
        )
    recs = [json.loads(l) for l in open(m)]
    assert any(r["type"] == "preempted" and r["frames_done"] == 2 for r in recs)
    assert ck.exists()

    res = runtime.run_chain(
        cfg, backend="xla", sink=metrics.MetricsSink(),
        checkpoint_in=str(ck), resume_progress=True,
    )
    for got, want in zip(res.state, full):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_preemption_guard_catches_sigterm():
    import os
    import signal

    with runtime.PreemptionGuard() as g:
        assert not g()
        os.kill(os.getpid(), signal.SIGTERM)
        assert g()  # handler set the flag instead of killing the process
    # original disposition restored on exit
    assert signal.getsignal(signal.SIGTERM) != g._handler


def test_cli_auto_resume_requires_out():
    import pytest

    with pytest.raises(SystemExit):
        cli.main(["run", "--preset", "harmosc", "--auto-resume"])


def test_cli_auto_resume_continues(tmp_path):
    ck = tmp_path / "ar.npz"
    m1 = tmp_path / "a.jsonl"
    cli.main([
        "run", "--preset", "harmosc", "--frames", "2", "--loops", "5",
        "--chains", "2", "--dtau", "1e-3", "--backend", "xla",
        "--metrics", str(m1), "--out", str(ck), "--auto-resume",
    ])
    m2 = tmp_path / "b.jsonl"
    cli.main([
        "run", "--preset", "harmosc", "--frames", "4", "--loops", "5",
        "--chains", "2", "--dtau", "1e-3", "--backend", "xla",
        "--metrics", str(m2), "--out", str(ck), "--auto-resume",
    ])
    recs = [json.loads(l) for l in open(m2)]
    frames = [r for r in recs if r["type"] == "frame"]
    # first invocation did 2 of 4; the auto-resumed one only runs the rest
    assert len(frames) == 2 and frames[-1]["percent"] == 100.0


def test_cli_complex_chain_preset(tmp_path):
    m = tmp_path / "ccl.jsonl"
    cli.main([
        "run", "--preset", "complex_chain", "--frames", "2", "--loops", "4",
        "--chains", "4", "--metrics", str(m),
    ])
    recs = [json.loads(l) for l in open(m)]
    assert any(r["type"] == "summary" for r in recs)


def test_cli_gauge_measure_loops(tmp_path):
    import json

    from stochquant import cli

    mfile = tmp_path / "g.jsonl"
    cli.main([
        "run", "--preset", "u1_2d", "--frames", "2", "--loops", "4",
        "--chains", "4", "--measure-loops", "--metrics", str(mfile),
    ])
    recs = [json.loads(l) for l in mfile.read_text().splitlines()]
    frames = [r for r in recs if r["type"] == "frame"]
    assert frames and all("polyakov_re" in f for f in frames)
    tables = [r for r in recs if r["type"] == "wilson_loops"]
    assert len(tables) == 1
    w = tables[0]["w"]
    assert len(w) == 4 and len(w[0]) == 4  # rmax=4 on the 16x16 preset


def test_field_backend_routing():
    """The field sector runs on the XLA path on every platform; a cuda
    request raises, and the path taken is recorded in the metrics stream."""
    import pytest

    base = FieldConfig(action="phi4", shape=(16, 128), loops=4, frames=1)
    for platform in ("cpu", "gpu"):
        path, reason = runtime.select_path("field", base, "auto", platform=platform)
        assert path == "xla" and "no CUDA kernel" in reason
        assert runtime.select_path("field", base, "xla", platform=platform)[0] == "xla"
    with pytest.raises(ValueError, match="no CUDA kernel"):
        runtime.select_path("field", base, "cuda", platform="gpu")
    recs = []
    runtime.run_field(base, sink=metrics.MetricsSink(callback=recs.append))
    paths = [r for r in recs if r["type"] == "path"]
    assert len(paths) == 1
    assert paths[0]["sector"] == "field" and paths[0]["path"] == "xla"
    assert paths[0]["platform"] == "cpu"


def test_chain_backend_explicit_validation():
    """Explicit backend='cuda' with kernel-unsupported features, or off a
    GPU, must raise, not silently switch path; unknown backends raise."""
    import pytest

    from stochquant.config import Scheme

    spec = ChainConfig(
        action="harmonic", n_sites=8, n_chains=2, loops=2, frames=1,
        accumulate_spectrum=True,
    )
    with pytest.raises(ValueError, match="spectrum"):
        runtime.run_chain(spec, backend="cuda", sink=metrics.MetricsSink())
    lm = ChainConfig(
        action="harmonic", n_sites=8, n_chains=2, loops=2, frames=1,
        scheme=Scheme.LM,
    )
    with pytest.raises(ValueError, match="LM"):
        runtime.run_chain(lm, backend="cuda", sink=metrics.MetricsSink())
    with pytest.raises(ValueError, match="unknown backend"):
        runtime.run_chain(lm, backend="triton", sink=metrics.MetricsSink())
    em = ChainConfig(action="harmonic", n_sites=8, n_chains=2, loops=2, frames=1)
    with pytest.raises(ValueError, match="needs a GPU"):
        runtime.run_chain(em, backend="cuda", sink=metrics.MetricsSink())


def test_resume_rejects_incompatible_checkpoint(tmp_path):
    import pytest

    cfg = FieldConfig(action="phi4", shape=(8, 8), n_chains=2, loops=4, frames=1)
    ck = tmp_path / "f.npz"
    runtime.run_field(cfg, sink=metrics.MetricsSink(), checkpoint_out=str(ck))
    # different lattice shape
    import dataclasses

    cfg2 = dataclasses.replace(cfg, shape=(16, 16))
    with pytest.raises(ValueError, match="incompatible"):
        runtime.run_field(cfg2, sink=metrics.MetricsSink(), checkpoint_in=str(ck))
    # wrong run kind entirely
    ccfg = ChainConfig(action="harmonic", n_sites=8, n_chains=2, loops=4, frames=1)
    with pytest.raises(ValueError, match="FieldConfig"):
        runtime.run_chain(ccfg, backend="xla", sink=metrics.MetricsSink(),
                          checkpoint_in=str(ck))


def test_gauge_resume_rejects_incompatible(tmp_path):
    import dataclasses

    import pytest

    from stochquant.integrators.gauge import GaugeConfig

    cfg = GaugeConfig(group="u1", shape=(4, 4), n_chains=2, loops=2, frames=1)
    ck = tmp_path / "g.npz"
    runtime.run_gauge(cfg, sink=metrics.MetricsSink(), checkpoint_out=str(ck))
    bad = dataclasses.replace(cfg, group="su2")
    with pytest.raises(ValueError, match="incompatible"):
        runtime.run_gauge(bad, sink=metrics.MetricsSink(), checkpoint_in=str(ck))


def test_burn_frames_not_counted_as_resume_progress(tmp_path):
    """A checkpoint written after burn-in must not count burn frames as
    completed measurement frames (VERDICT r1 weak item 5): the writer stores
    the true frames_done and resume honours it."""
    import json as _json

    cfg = ChainConfig(
        action="harmonic", n_sites=16, dt=0.2, dtau=1e-3, n_chains=2,
        loops=10, frames=2, seed=9,
    )
    ck = tmp_path / "b.npz"
    runtime.run_chain(cfg, backend="xla", sink=metrics.MetricsSink(),
                      checkpoint_out=str(ck), burn_frames=3)
    from stochquant.io import checkpoint as ckpt

    assert ckpt.read_meta(str(ck))["frames_done"] == 2
    # resume asking for 4 total: must run exactly 2 more frames, not 0
    # (the old step//loops heuristic saw (3 burn + 2) frames > 4 and quit)
    import dataclasses

    cfg2 = dataclasses.replace(cfg, frames=4)
    m = tmp_path / "m.jsonl"
    with open(m, "w") as fh:
        runtime.run_chain(cfg2, backend="xla",
                          sink=metrics.MetricsSink(stream=fh),
                          checkpoint_in=str(ck), resume_progress=True)
    frames = [r for r in map(_json.loads, open(m)) if r["type"] == "frame"]
    assert len(frames) == 2 and frames[-1]["percent"] == 100.0


import pytest as _pytest


@_pytest.mark.parametrize("group", ["cu1", "csu3"])
def test_gauge_measure_loops_complex_group(tmp_path, group):
    """Polyakov/Wilson loops are holomorphic observables — valid under
    complex Langevin; the loop algebra must dispatch on the complexified
    groups end-to-end through runtime.run_gauge (ADVICE r1 item 1 /
    VERDICT r2 item 10), for both the phase (cu1) and matrix (csu3)
    complexifications."""
    import json as _json

    from stochquant.integrators.gauge import GaugeConfig

    cfg = GaugeConfig(
        group=group, beta=1.0, beta_im=0.3, shape=(4, 4), n_chains=2,
        loops=2, frames=2, dtau=1e-3, cooling_rate=0.05, measure_loops=True,
    )
    m = tmp_path / "cg.jsonl"
    with open(m, "w") as fh:
        runtime.run_gauge(cfg, sink=metrics.MetricsSink(stream=fh))
    recs = [_json.loads(l) for l in open(m)]
    frames = [r for r in recs if r["type"] == "frame"]
    assert frames and all("polyakov_re" in f for f in frames)
    assert frames and all("unitarity_norm" in f for f in frames)
    assert any(r["type"] == "wilson_loops" for r in recs)
    w = next(r for r in recs if r["type"] == "wilson_loops")
    assert np.all(np.isfinite(np.asarray(w["w"], dtype=complex).real))


_DW = ChainConfig(action="double_well", n_sites=200, dt=0.02, dtau=2e-4, loops=10)


def _path_cases():
    import dataclasses

    from stochquant.config import Scheme
    from stochquant.integrators.gauge import GaugeConfig

    rep = dataclasses.replace
    field = FieldConfig(action="phi4", shape=(8, 8))
    gauge = GaugeConfig(group="u1", shape=(8, 8))
    return [
        # (id, sector, cfg, backend, platform, expected path or error match)
        ("chain-gpu-auto", "chain", _DW, "auto", "gpu", "cuda"),
        ("chain-gpu-cuda", "chain", _DW, "cuda", "gpu", "cuda"),
        ("chain-gpu-xla", "chain", _DW, "xla", "gpu", "xla"),
        ("chain-cpu-auto", "chain", _DW, "auto", "cpu", "xla"),
        ("chain-cpu-cuda", "chain", _DW, "cuda", "cpu", "needs a GPU"),
        ("chain-gpu-lm", "chain", rep(_DW, scheme=Scheme.LM), "auto", "gpu", "xla"),
        ("chain-gpu-heun-cuda", "chain", rep(_DW, scheme=Scheme.HEUN), "cuda", "gpu", "HEUN"),
        ("chain-gpu-spectrum", "chain", rep(_DW, accumulate_spectrum=True), "auto", "gpu", "xla"),
        ("chain-gpu-long", "chain", rep(_DW, n_sites=1024), "auto", "gpu", "xla"),
        ("chain-gpu-autodiff-action", "chain", rep(_DW, action="poeschl_teller"), "auto", "gpu", "xla"),
        ("field-gpu-auto", "field", field, "auto", "gpu", "xla"),
        ("gauge-gpu-cuda", "gauge", gauge, "cuda", "gpu", "no CUDA kernel"),
        ("gauge-cpu-auto", "gauge", gauge, "auto", "cpu", "xla"),
        ("unknown-platform", "chain", _DW, "auto", "rocm", "unsupported platform"),
        ("unknown-backend", "chain", _DW, "triton", "gpu", "unknown backend"),
        ("unknown-sector", "spin", _DW, "auto", "gpu", "unknown sector"),
    ]


import pytest  # noqa: E402

_CASES = _path_cases()


@pytest.mark.parametrize(
    "sector,cfg,backend,platform,expect",
    [c[1:] for c in _CASES], ids=[c[0] for c in _CASES],
)
def test_select_path_mapping(sector, cfg, backend, platform, expect):
    """One function maps (platform, sector, config, backend) to a path; a
    path a config cannot take raises instead of switching quietly."""
    if expect in ("cuda", "xla"):
        path, reason = runtime.select_path(sector, cfg, backend, platform=platform)
        assert path == expect and reason
    else:
        with pytest.raises(ValueError, match=expect):
            runtime.select_path(sector, cfg, backend, platform=platform)


def test_run_chain_records_path_once(tmp_path):
    recs = []
    cfg = ChainConfig(action="harmonic", n_sites=8, n_chains=2, loops=2, frames=3)
    runtime.run_chain(cfg, sink=metrics.MetricsSink(callback=recs.append))
    paths = [r for r in recs if r["type"] == "path"]
    assert len(paths) == 1
    assert paths[0]["path"] == "xla" and "needs a GPU" in paths[0]["reason"]
