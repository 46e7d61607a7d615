#!/usr/bin/env python
"""Throughput of the product paths on one NVIDIA GPU.

Each arm runs a sector through its normal entry point (``runtime.run_*``)
at an on-device size and reports lattice site-updates per second (MLUPS);
the chain ensemble runs on both of its paths, the CUDA kernel and the XLA
scan, in turns in one process.  Prints ONE JSON line on stdout, headed by
the double-well ensemble on the CUDA path:

  {"metric": ..., "value": MLUPS, "unit": "MLUPS", "vs_baseline": x,
   "device": {"platform", "kind", "count"}, "card": "<name>, <power limit>",
   ...per-arm rates and their spreads...}

``vs_baseline`` divides by the serial CPU rate of the C++ reference oracle
(cc/oracle.cpp) on the same host.  Diagnostics go to stderr.

The measurement runs in a child process (``--worker``) under a watchdog:
the parent never initialises a JAX backend, so the child has the card to
itself, and a retry starts only after the previous child has exited.  With
no GPU the benchmark exits nonzero without a result.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
METRIC = "double_well_site_updates_per_sec_per_chip"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_name_and_power() -> str:
    """``nvidia-smi``'s name and power limit of the card (no JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def worker() -> None:
    sys.path.insert(0, REPO)
    from stochquant import compile_cache

    compile_cache.configure()
    import dataclasses

    import jax

    from stochquant import metrics, oracle, runtime
    from stochquant.config import PRESETS, BoundaryCondition, ChainConfig, Formulation
    from stochquant.integrators.gauge import GaugeConfig
    from stochquant.timing import ab_timeit

    devs = jax.devices()
    if devs[0].platform != "gpu":
        log(f"no GPU: {devs}")
        sys.exit(2)
    log(f"devices: {devs}")
    sink = lambda: metrics.MetricsSink()  # noqa: E731
    rep = dataclasses.replace

    def chain_run(cfg, backend):
        def run():
            res = runtime.run_chain(cfg, backend=backend, sink=sink())
            jax.block_until_ready(res.state)
        return run

    def mlups(updates, t):
        med, lo, hi = t
        return round(updates / med / 1e6, 1), [
            round(updates / hi / 1e6, 1), round(updates / lo / 1e6, 1)
        ]

    out = {}
    # double-well ensemble: the reference's default workload (N = 200,
    # 1,000 micro-steps per frame) at 65,536 chains and Δτ = 2e-4, 5 frames
    # per run with one metrics record (fps = frames)
    dw = rep(PRESETS["double_well"], n_chains=65536, dtau=2e-4, frames=5,
             fps=5, seed=2026, grow_after=10**9)
    dw_ups = dw.n_chains * dw.n_sites * dw.loops * dw.frames
    t = ab_timeit({
        "cuda": chain_run(dw, "cuda"),
        "xla": chain_run(dw, "xla"),
        "cuda13": chain_run(rep(dw, rng_impl="threefry13"), "cuda"),
    }, reps=3)
    for k, v in t.items():
        out[f"double_well_{k}_mlups"], out[f"double_well_{k}_spread"] = mlups(dw_ups, v)
    log(f"double well: {t}")

    # anharmonic λφ⁴ chain, N = 1024 x 256 chains (past the kernel's 512
    # sites: XLA path)
    c2 = ChainConfig(
        action="anharmonic", n_sites=1024, dt=0.25, dtau=0.01, n_chains=256,
        loops=1000, frames=8, fps=8, seed=14, bc=BoundaryCondition.PERIODIC,
        formulation=Formulation.DIRECT, grow_after=10**9,
    )
    t = ab_timeit({"xla": chain_run(c2, "auto")}, reps=3)
    out["anharmonic_1024_mlups"], out["anharmonic_1024_spread"] = mlups(
        c2.n_chains * c2.n_sites * c2.loops * c2.frames, t["xla"])

    def sector_run(fn, cfg):
        def run():
            res = fn(cfg, sink=sink())
            jax.block_until_ready(res.state)
        return run

    arms = {
        "phi4_2d_256sq_x16": (runtime.run_field, rep(
            PRESETS["phi4_2d"], n_chains=16, frames=10, fps=10, seed=13,
            grow_after=10**9)),
        "phi4_4d_32p4_x8": (runtime.run_field, rep(
            PRESETS["phi4_4d"], n_chains=8, frames=4, fps=4, seed=9,
            grow_after=10**9)),
        "u1_256sq_x32": (runtime.run_gauge, GaugeConfig(
            group="u1", beta=1.0, shape=(256, 256), n_chains=32, dtau=5e-3,
            loops=100, frames=4, seed=15, grow_after=10**9)),
        "su2_128sq_x16": (runtime.run_gauge, GaugeConfig(
            group="su2", beta=2.0, shape=(128, 128), n_chains=16, dtau=2e-3,
            loops=100, frames=4, seed=19, grow_after=10**9)),
        "su3_64sq_x8": (runtime.run_gauge, GaugeConfig(
            group="su3", beta=5.0, shape=(64, 64), n_chains=8, dtau=1e-3,
            loops=50, frames=4, seed=19, grow_after=10**9)),
    }
    for name, (fn, cfg) in arms.items():
        sites = 1
        for s in cfg.shape:
            sites *= s
        links = sites * (len(cfg.shape) if fn is runtime.run_gauge else 1)
        t = ab_timeit({name: sector_run(fn, cfg)}, reps=3)
        out[f"{name}_mlups"], out[f"{name}_spread"] = mlups(
            cfg.n_chains * links * cfg.loops * cfg.frames, t[name])
        log(f"{name}: {t[name]}")

    ref = oracle.run_reference(200, 0.02, 2e-4, frames=5, loops=1000, seed=7)
    ref_mlups = ref.updates_per_sec / 1e6
    log(f"oracle baseline: {ref_mlups:.1f} MLUPS (serial, host CPU)")
    value = out["double_well_cuda_mlups"]
    print(json.dumps({
        "metric": METRIC,
        "value": value,
        "unit": "MLUPS",
        "vs_baseline": round(value / ref_mlups, 2),
        "device": {"platform": devs[0].platform, "kind": devs[0].device_kind,
                   "count": len(devs)},
        "card": card_name_and_power(),
        "oracle_cpu_mlups": round(ref_mlups, 2),
        **out,
    }))


def main() -> int:
    if "--worker" in sys.argv:
        worker()
        return 0
    try:
        card = card_name_and_power()
    except (OSError, subprocess.SubprocessError) as e:
        log(f"no GPU found ({e}); nothing measured")
        return 1
    log(f"card: {card}")
    sys.path.insert(0, REPO)
    from stochquant.watchdog import run_watchdogged

    def report(att):
        if att.stderr:
            sys.stderr.write(att.stderr)
        if att.timed_out:
            log(f"attempt {att.index}: worker timed out")
        elif not att.ok:
            log(f"attempt {att.index}: worker exit {att.returncode}")

    res = run_watchdogged(
        [os.path.abspath(__file__), "--worker"], python=True,
        timeout_s=1800, attempts=2, backoff_s=10, on_attempt=report,
    )
    lines = res.success.stdout.splitlines() if res.ok else []
    lines = [line for line in lines if line.strip()]
    if not lines:
        log("no result: " + ("worker printed nothing" if res.ok
                             else "every attempt failed"))
        return 1
    print(lines[-1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
