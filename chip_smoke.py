#!/usr/bin/env python3
"""Smoke test of stochquant on an NVIDIA GPU.

Run from the root of a checkout on a machine with one GPU:

    python chip_smoke.py            # phases 1-5 on one card
    python chip_smoke.py --four     # phase 6 only, on four cards

Phases (one process; any failure raises and the script exits nonzero):

1. device — the card's name and power limit from ``nvidia-smi`` (a child
   process that stays off JAX), then ``jax.devices()``; fails unless the
   platform is ``gpu``;
2. tests  — the tests marked ``gpu`` (``pytest -m gpu``) in a child
   process, before this process opens the card;
3. main   — ``stochquant run --preset double_well`` at 65,536 chains x 200
   sites x 1,000 micro-steps through ``cli.main``: the CUDA path is taken,
   every frame is stable, the correlator is finite, and a checkpoint
   round-trip resumes bitwise; prints the frame's memory analysis;
4. kernel — the CUDA kernel against the plain XLA reference at that width:
   noise bits, one frame's state, and the ``run_chain`` times of both paths;
5. sectors — every other sector through ``runtime.run_*`` on the XLA path at
   real widths, plus the harmonic chain against its exact EM covariance;
6. four   — (``--four``) the halo runner on a 64^4 phi^4 lattice and the
   double-well ensemble split over four cards, each against one card.

``--only PHASE[,PHASE...]`` runs a subset (after the device phase).  The
last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``
and is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import stochquant  # noqa: E402,F401  (fails outside a checkout)

MAIN_CHAINS = 65536
MAIN_DTAU = 2e-4
BURN = 3

#: Kernel-against-XLA bounds for one 1,000-step double-well frame at the
#: main-path width.  The two paths draw identical noise bits and the kernel
#: follows XLA's GPU lowering of sqrt, division and tanh
#: (cuda/chain_math.h), so Box–Muller and ω come out bit-equal; what is left
#: is rounding in the site update, carried through 1,000 coupled micro-steps
#: and amplified where the double well's curvature is negative.  Measured on
#: an H100 at 700 W: max|Δf| 1.43e-6, |Δx_mean| 6.0e-7, |Δxx0_mean| 1.9e-6,
#: |Δx2_mean| 2.1e-6, |Δx4_mean| 5.3e-5, |Δlrg_vl| 9.5e-7, Δω 0.  The bounds
#: leave about a five-fold margin; x4_mean's is wider because ⟨x⁴⟩ carries
#: f's difference times 4|x|³ (|x| reaches ~2).
TOL = {
    "f": 1e-5,
    "omega": 1e-5,
    "x_mean": 5e-6,
    "xx0_mean": 1e-5,
    "x2_mean": 1e-5,
    "x4_mean": 3e-4,
    "lrg_vl": 5e-6,
}


def log(msg: str = "") -> None:
    print(msg, flush=True)


def phase(name: str):
    log(f"=== phase: {name}")
    return time.perf_counter()


def done(name: str, t0: float) -> None:
    log(f"=== {name} passed in {time.perf_counter() - t0:.1f} s")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ------------------------------------------------------------------ 1 ----


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def device_phase():
    import jax

    devs = jax.devices()
    log(f"jax.devices(): {devs}")
    check(devs[0].platform == "gpu", f"no GPU: platform {devs[0].platform!r}")
    return devs


# ------------------------------------------------------------------ 2 ----


def tests_phase() -> None:
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
         "-p", "no:cacheprovider"],
        cwd=REPO, capture_output=True, text=True, timeout=900,
    )
    tail = (proc.stdout + proc.stderr).strip().splitlines()[-15:]
    for line in tail:
        log(f"  | {line}")
    check(proc.returncode == 0, f"gpu tests failed (exit {proc.returncode})")


# ------------------------------------------------------------------ 3 ----


def _records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def main_path_phase(tmp: str) -> None:
    import numpy as np

    from stochquant import actions, cli
    from stochquant.config import PRESETS
    from stochquant.io import checkpoint
    from stochquant.kernels import chain_cuda

    base = ["run", "--preset", "double_well", "--chains", str(MAIN_CHAINS),
            "--dtau", str(MAIN_DTAU)]
    # Burn-in frames: at Δτ = 2e-4 the lattice's top mode sits exactly on
    # Euler–Maruyama's stability edge (4Δτ/Δt² = 2), so the cold start's
    # first frame trips the divergence detector on every path and is rolled
    # back, max|x| (the detector's threshold) included; the controller steps
    # Δτ down by cfg.shrink.  The next frame still starts from the cold
    # threshold and rejects a few chains in 65,536.  The measured frames
    # follow BURN frames.
    m_full = os.path.join(tmp, "main.jsonl")
    ck_full = os.path.join(tmp, "full.npz")
    t0 = time.perf_counter()
    cli.main(base + ["--burn", str(BURN), "--frames", "3", "--metrics",
                     m_full, "--out", ck_full])
    log(f"  cli run (burn {BURN} + 3 frames, compile included): "
        f"{time.perf_counter() - t0:.1f} s")
    recs = _records(m_full)
    paths = [r for r in recs if r["type"] == "path"]
    check(len(paths) == 1, f"expected one path record, got {paths}")
    log(f"  path: {paths[0]}")
    check(paths[0]["path"] == "cuda", "main path did not take the CUDA kernel")
    frames = [r for r in recs if r["type"] == "frame"]
    check(len(frames) == 3, f"expected 3 frame records, got {len(frames)}")
    for r in frames:
        log(f"  frame {r['frame']}: stable_frac {r['stable_frac']} "
            f"dtau {r['dtau']} mlups {r['mlups']}")
        check(r["stable_frac"] == 1.0, f"unstable frame: {r['stable_frac']}")
        corr = np.asarray(r["log_abs_corr"], np.float64)
        check(corr.shape == (200,) and np.all(np.isfinite(corr)),
              "log_abs_corr not finite")

    # checkpoint round-trip: burn + 1 frame, resume for 2 more == 3 straight
    ck_a = os.path.join(tmp, "a.npz")
    ck_b = os.path.join(tmp, "b.npz")
    cli.main(base + ["--burn", str(BURN), "--frames", "1", "--metrics",
                     os.path.join(tmp, "a.jsonl"), "--out", ck_a])
    cli.main(base + ["--frames", "2", "--resume", ck_a, "--metrics",
                     os.path.join(tmp, "b.jsonl"), "--out", ck_b])
    with np.load(ck_full) as za, np.load(ck_b) as zb:
        names = [k for k in za.files if k.startswith("state_")]
        for k in names:
            check(np.array_equal(za[k], zb[k]), f"resume not bitwise: {k}")
    log(f"  checkpoint resume bitwise over {len(names)} state leaves")

    state, cfg = checkpoint.load(ck_full)
    act = actions.get(cfg.action)
    compiled = chain_cuda.run_frames.lower(state, act, cfg, 1).compile()
    log(f"  frame memory_analysis: {compiled.memory_analysis()}")


# ------------------------------------------------------------------ 4 ----


def kernel_phase() -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from stochquant import actions, rng, runtime
    from stochquant.config import PRESETS
    from stochquant.integrators import langevin
    from stochquant.kernels import chain_cuda
    from stochquant.metrics import MetricsSink
    from stochquant.timing import ab_timeit

    cfg = dataclasses.replace(
        PRESETS["double_well"], n_chains=MAIN_CHAINS, dtau=MAIN_DTAU
    )
    act = actions.get(cfg.action)
    s0 = langevin.init_chain_state(cfg, act)
    # compare a frame after the burn-in the main path uses (see
    # main_path_phase): the cold start's frames are rejected on both paths
    s1, _ = langevin.run_frames(s0, act, cfg, BURN)

    # noise bits on a slice of chains, all sites, a few steps of the frame
    chains = np.array([0, 1, 31, 32, 4097, MAIN_CHAINS - 1], np.uint32)
    steps = int(s1.step) + np.array([0, 2, 500, cfg.loops - 2], np.uint32)
    cc, ss, tt = np.meshgrid(chains, np.arange(cfg.n_sites, dtype=np.uint32),
                             steps, indexing="ij")
    k0 = np.full(cc.shape, cfg.seed, np.uint32)
    k1 = np.uint32(rng.Stream.FIELD) ^ (cc << np.uint32(8))
    R = rng.rounds_of(cfg.rng_impl)
    b0, b1, z0, z1 = chain_cuda.device_normal_pair(k0, k1, ss, tt, R)
    xb0, xb1 = jax.jit(rng.threefry2x32, static_argnums=4)(
        k0.ravel(), k1.ravel(), ss.ravel(), tt.ravel(), R)
    xz0, xz1 = jax.jit(rng.normal_pair, static_argnums=4)(
        k0.ravel(), k1.ravel(), ss.ravel(), tt.ravel(), R)
    check(np.array_equal(np.asarray(b0), np.asarray(xb0))
          and np.array_equal(np.asarray(b1), np.asarray(xb1)),
          "kernel noise bits differ from rng.threefry2x32")
    dz = max(float(jnp.max(jnp.abs(z0 - xz0))), float(jnp.max(jnp.abs(z1 - xz1))))
    log(f"  noise bits equal on {b0.size} counters; Box-Muller max|dz| {dz:.3e}")

    sk, mk = chain_cuda.run_frames(s1, act, cfg, 1)
    sx, mx = langevin.run_frames(s1, act, cfg, 1)
    stable_k = np.asarray(mk["stable"])
    check(np.array_equal(stable_k, np.asarray(mx["stable"])),
          "stable flags differ between kernel and XLA")
    log(f"  compared frame: {int(stable_k.sum())} of {stable_k.size} chains "
        "accepted on both paths")
    check(stable_k.mean() > 0.999, "the compared frame was rejected")
    diffs = {}
    for name, tol in TOL.items():
        a = np.asarray(getattr(sk, name), np.float64)
        b = np.asarray(getattr(sx, name), np.float64)
        check(bool(np.all(np.isfinite(a))), f"kernel {name} not finite")
        diffs[name] = float(np.max(np.abs(a - b)))
        log(f"  max|d {name}| = {diffs[name]:.3e}  (bound {tol:.0e})")
    for name, tol in TOL.items():
        check(diffs[name] <= tol, f"{name}: {diffs[name]:.3e} > {tol:.0e}")

    # run_chain at the main-path size, 5 frames per run, both paths in turn
    tcfg = dataclasses.replace(cfg, frames=5, fps=5)

    def run(backend):
        def go():
            res = runtime.run_chain(tcfg, backend=backend, sink=MetricsSink())
            jax.block_until_ready(res.state)
        return go

    # one warm-up each, then 3 timed runs of each in turns
    times = ab_timeit({"cuda": run("cuda"), "xla": run("xla")}, reps=3)
    out = {}
    for k, (med, lo, hi) in times.items():
        out[k] = med / tcfg.frames
        log(f"  run_chain {k}: {tcfg.frames} frames in median {med:.4f} s "
            f"(min {lo:.4f}, max {hi:.4f}; 3 runs) -> "
            f"{med / tcfg.frames * 1e3:.2f} ms/frame")
    log(f"  xla/cuda frame-time ratio: {out['xla'] / out['cuda']:.3f}")
    return out


# ------------------------------------------------------------------ 5 ----


def sectors_phase() -> None:
    import numpy as np

    from stochquant import runtime
    from stochquant.cli import _complex_presets, _gauge_presets
    from stochquant.config import PRESETS, BoundaryCondition, ChainConfig, Formulation
    from stochquant.integrators.gauge import GaugeConfig
    from stochquant.metrics import MetricsSink
    from stochquant.observables import exact

    rep = dataclasses.replace
    runs = [
        ("phi4_2d 256^2 x 64", runtime.run_field,
         rep(PRESETS["phi4_2d"], n_chains=64, frames=2)),
        ("phi4_4d 32^4 x 8", runtime.run_field,
         rep(PRESETS["phi4_4d"], n_chains=8, frames=2)),
        ("u1 256^2 x 32", runtime.run_gauge,
         GaugeConfig(group="u1", beta=1.0, shape=(256, 256), n_chains=32,
                     dtau=5e-3, loops=100, frames=2, seed=15)),
        ("su2 128^2 x 16", runtime.run_gauge,
         GaugeConfig(group="su2", beta=2.0, shape=(128, 128), n_chains=16,
                     dtau=2e-3, loops=100, frames=2, seed=19)),
        ("su3 64^2 x 8", runtime.run_gauge,
         GaugeConfig(group="su3", beta=5.0, shape=(64, 64), n_chains=8,
                     dtau=1e-3, loops=50, frames=2, seed=19)),
        ("su3_4d", runtime.run_gauge, rep(_gauge_presets()["su3_4d"], frames=2)),
        ("complex_field_2d", runtime.run_complex,
         rep(_complex_presets()["complex_field_2d"], frames=2)),
    ]
    for label, fn, cfg in runs:
        recs = []
        t0 = time.perf_counter()
        fn(cfg, sink=MetricsSink(callback=recs.append))
        dt = time.perf_counter() - t0
        paths = [r["path"] for r in recs if r["type"] == "path"]
        frames = [r for r in recs if r["type"] == "frame"]
        check(paths == ["xla"], f"{label}: path {paths}")
        check(len(frames) == 2, f"{label}: {len(frames)} frames")
        for r in frames:
            check(r["stable_frac"] == 1.0, f"{label}: unstable frame {r}")
            for k, v in r.items():
                if isinstance(v, float):
                    check(math.isfinite(v), f"{label}: {k} = {v}")
        obs = {k: v for k, v in frames[-1].items()
               if k not in ("type", "frame", "percent", "wall_time")}
        log(f"  {label}: {dt:.1f} s (compile included) {obs}")

    # the harmonic chain against the exact finite-Δτ EM covariance, at the
    # gate of its CPU test (test_integrator.py::test_float64_dtype_on_cpu:
    # site-wise 6σ + 1e-3), in float32 with 4,096 chains.  Δτ·b_max = 0.27
    # keeps every frame far from EM's stability edge, so no chain's Δτ
    # moves (a shrunk Δτ would change the covariance being tested).
    hcfg = ChainConfig(
        action="harmonic", n_sites=16, dt=0.4, dtau=0.01, n_chains=4096,
        loops=100, frames=40, fps=40, bc=BoundaryCondition.PERIODIC,
        formulation=Formulation.DIRECT, seed=9, grow_after=10**9,
    )
    B = exact.harmonic_drift_matrix(hcfg.n_sites, hcfg.dt, k=2.0, bc=hcfg.bc)
    x2_theory = np.diag(exact.em_stationary_cov(B, hcfg.dt, hcfg.dtau))
    for backend in ("auto", "xla"):
        recs = []
        res = runtime.run_chain(
            hcfg, backend=backend, burn_frames=10, stream_correlator=False,
            sink=MetricsSink(callback=recs.append),
        )
        path = [r["path"] for r in recs if r["type"] == "path"][0]
        check(all(r["stable_frac"] == 1.0 for r in recs if r["type"] == "frame")
              and bool(np.all(np.asarray(res.state.dtau) == np.float32(hcfg.dtau))),
              f"harmonic ({path}): a frame was rejected")
        x2 = np.asarray(res.state.x2_mean, np.float64)
        mean = x2.mean(axis=0)
        stderr = x2.std(axis=0) / np.sqrt(hcfg.n_chains)
        z = np.abs(mean - x2_theory) / stderr
        log(f"  harmonic <x^2> ({path}): {mean.mean():.6f} vs exact EM "
            f"{x2_theory.mean():.6f}; site-wise max |z| {z.max():.2f}")
        check(bool(np.all(np.abs(mean - x2_theory) < 6 * stderr + 1e-3)),
              f"harmonic EM covariance gate ({path})")


# ------------------------------------------------------------------ 6 ----


def four_phase(lattice: int = 64, chains: int = MAIN_CHAINS) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from stochquant import actions
    from stochquant.actions import phi4
    from stochquant.config import PRESETS
    from stochquant.integrators import field as field_mod
    from stochquant.integrators import langevin
    from stochquant.kernels import chain_cuda
    from stochquant.parallel import make_mesh, shard_chain_state, shard_field_state
    from stochquant.parallel.halo import make_halo_runner

    check(len(jax.devices()) == 4, f"--four needs 4 GPUs, have {jax.devices()}")

    def maxdiff(a, b):
        return float(jnp.max(jnp.abs(jnp.asarray(a, jnp.float32)
                                     - jnp.asarray(b, jnp.float32))))

    # φ⁴ on 64^4 x 4 chains: halo runner vs the unsharded integrator
    base = dataclasses.replace(PRESETS["phi4_4d"], shape=(lattice,) * 4,
                               n_chains=4, frames=2)
    act = phi4.get_field(base.action)
    s0 = field_mod.init_field_state(base)
    t0 = time.perf_counter()
    ref, _ = field_mod.run_field_frames(s0, act, base, 2)
    jax.block_until_ready(ref)
    log(f"  phi4 {lattice}^4 x 4 on one card: {time.perf_counter() - t0:.1f} s")
    for label, axes, mesh_axes in (
        ("x4", [("x", 4)], ("x", None, None, None)),
        ("x2y2", [("x", 2), ("y", 2)], ("x", "y", None, None)),
    ):
        cfg = dataclasses.replace(base, mesh_axes=mesh_axes)
        mesh = make_mesh(axes)
        runner = make_halo_runner(act, cfg, mesh)
        t0 = time.perf_counter()
        out, _ = runner(shard_field_state(s0, mesh, cfg), 2)
        jax.block_until_ready(out)
        d = {k: maxdiff(getattr(out, k), getattr(ref, k))
             for k in ("phi", "mag_mean", "phi2_mean", "dtau")}
        log(f"  phi4 halo {label}: {time.perf_counter() - t0:.1f} s; "
            f"max|d| vs one card {d}")
        check(d["phi"] <= 1e-5 and d["phi2_mean"] <= 1e-5,
              f"phi4 halo {label} differs from one card: {d}")

    # double-well ensemble split by chains over ("chain", 4)
    cfg = dataclasses.replace(PRESETS["double_well"], n_chains=chains,
                              dtau=MAIN_DTAU)
    act = actions.get(cfg.action)
    s0 = langevin.init_chain_state(cfg, act)
    mesh = make_mesh([("chain", 4)])
    ref, mref = chain_cuda.run_frames(s0, act, cfg, 2)
    out, mout = chain_cuda.run_frames_sharded(
        shard_chain_state(s0, mesh), act, cfg, 2, mesh)
    xref, _ = langevin.run_frames(s0, act, cfg, 2)
    xout, _ = langevin.run_frames(shard_chain_state(s0, mesh), act, cfg, 2)
    for label, a, b in (("cuda", out, ref), ("xla", xout, xref)):
        eq = all(np.array_equal(np.asarray(x), np.asarray(y))
                 for x, y in zip(a, b))
        d = maxdiff(a.f, b.f)
        log(f"  double_well chain x4 ({label}): bitwise {eq}, max|d f| {d:.3e}")
        check(eq, f"chain-split {label} run differs from one card")


# ----------------------------------------------------------------- main ---


PHASES = ("tests", "main", "kernel", "sectors")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    ap.add_argument("--only", help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    todo = ["four"] if args.four else (
        args.only.split(",") if args.only else list(PHASES))
    for p in todo:
        if p not in PHASES + ("four",):
            ap.error(f"unknown phase {p!r}")

    from stochquant import compile_cache

    log(f"compile cache: {compile_cache.configure()}")
    t0 = phase("device")
    card = card_name_and_power()
    log(f"nvidia-smi: {card}")
    if "tests" in todo:
        t1 = phase("tests")
        tests_phase()
        done("tests", t1)
    devs = device_phase()
    done("device", t0)
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in (("main", lambda: main_path_phase(tmp)),
                         ("kernel", kernel_phase),
                         ("sectors", sectors_phase),
                         ("four", four_phase)):
            if name in todo:
                t1 = phase(name)
                fn()
                done(name, t1)
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
