"""Command-line runner — typed replacement for the reference's 13-positional
argv CLI (``tauhost.c:31-43``) + hand-edited preset dicts (``taumain.py:91-128``).

Examples:
    python -m stochquant.cli run --preset double_well --frames 100
    python -m stochquant.cli run --preset harmosc --chains 256 --out ck.npz
    python -m stochquant.cli run --preset phi4_2d --frames 20
    python -m stochquant.cli plot --follow run.jsonl        # live plot
    python -m stochquant.cli reference-import --file V0_2e_0-8.txt --preset double_well
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from stochquant import compile_cache
from stochquant import metrics as metrics_mod
from stochquant import runtime
from stochquant.config import PRESETS, ChainConfig, FieldConfig


def _complex_presets():
    from stochquant.integrators.complex_field import ComplexFieldConfig
    from stochquant.integrators.complex_langevin import (
        ComplexChainConfig,
        ComplexLangevinConfig,
    )

    return {
        "complex_gaussian": ComplexLangevinConfig(action="complex_gaussian"),
        "complex_quartic": ComplexLangevinConfig(
            action="complex_quartic", dtau=5e-4, loops=200
        ),
        "complex_chain": ComplexChainConfig(action="complex_gaussian"),
        "complex_field_2d": ComplexFieldConfig(
            action="complex_gaussian", shape=(32, 32), n_chains=64
        ),
    }


def _gauge_presets():
    from stochquant.integrators.gauge import GaugeConfig

    return {
        "u1_2d": GaugeConfig(group="u1", beta=1.0, shape=(16, 16), n_chains=64),
        "su2_2d": GaugeConfig(group="su2", beta=2.0, shape=(16, 16), n_chains=64),
        "su3_2d": GaugeConfig(group="su3", beta=2.0, shape=(8, 8), n_chains=64),
        "su3_4d": GaugeConfig(
            group="su3", beta=5.7, shape=(4, 4, 4, 4), n_chains=4, dtau=1e-3
        ),
        "su2_4d": GaugeConfig(
            group="su2", beta=2.2, shape=(8, 8, 8, 8), n_chains=8, dtau=1e-3
        ),
        # complex-Langevin gauge theory (complex β) with gauge cooling
        "cu1_2d_complex": GaugeConfig(
            group="cu1", beta=1.0, beta_im=0.5, shape=(16, 16), n_chains=64,
            dtau=5e-3, cooling_rate=0.05,
        ),
        "csu3_2d_complex": GaugeConfig(
            group="csu3", beta=2.0, beta_im=0.5, shape=(8, 8), n_chains=32,
            dtau=2e-3, cooling_rate=0.05,
        ),
    }


def _apply_overrides(cfg, args):
    updates = {}
    if args.frames is not None:
        updates["frames"] = args.frames
    if args.loops is not None:
        updates["loops"] = args.loops
    if args.chains is not None:
        updates["n_chains"] = args.chains
    if args.dtau is not None:
        updates["dtau"] = args.dtau
    if args.seed is not None:
        updates["seed"] = args.seed
    if args.fps is not None:
        updates["fps"] = args.fps
    if getattr(args, "measure_loops", False) and hasattr(cfg, "measure_loops"):
        updates["measure_loops"] = True
    if getattr(args, "scheme", None) is not None and hasattr(cfg, "scheme"):
        from stochquant.config import Scheme

        updates["scheme"] = Scheme[args.scheme.upper()]
    if getattr(args, "rng", None) is not None and hasattr(cfg, "rng_impl"):
        updates["rng_impl"] = args.rng
    return dataclasses.replace(cfg, **updates) if updates else cfg


def cmd_run(args):
    import os

    presets = {**PRESETS, **_complex_presets(), **_gauge_presets()}
    if args.preset not in presets:
        sys.exit(f"unknown preset {args.preset!r}; known: {sorted(presets)}")
    cfg = _apply_overrides(presets[args.preset], args)
    metrics_fh = open(args.metrics, "w") if args.metrics else None
    sink = metrics_mod.MetricsSink(stream=metrics_fh or sys.stdout)
    resume = args.resume
    resume_progress = False
    if args.auto_resume:
        if not args.out:
            sys.exit("--auto-resume requires --out (the checkpoint to resume from)")
        if os.path.exists(args.out):
            resume = args.out
            resume_progress = True
    prof = None
    if args.profile:
        import jax

        jax.profiler.start_trace(args.profile)
        prof = True

    common = dict(
        burn_frames=args.burn,
        sink=sink,
        checkpoint_out=args.out,
        checkpoint_in=resume,
        checkpoint_every=args.checkpoint_every,
        resume_progress=resume_progress,
    )
    try:
        # SIGTERM/SIGINT write a final checkpoint and exit cleanly; with
        # --auto-resume the next invocation picks up where this one stopped.
        # The guard is installed before the first JAX compile so a signal
        # landing mid-compile is deferred into a graceful stop, not a kill.
        with runtime.PreemptionGuard() as guard:
            common["stop"] = guard
            if isinstance(cfg, ChainConfig):
                runtime.run_chain(cfg, backend=args.backend, **common)
            elif isinstance(cfg, FieldConfig):
                runtime.run_field(cfg, backend=args.backend, **common)
            else:
                from stochquant.integrators.gauge import GaugeConfig

                if isinstance(cfg, GaugeConfig):
                    runtime.run_gauge(cfg, backend=args.backend, **common)
                else:
                    runtime.run_complex(cfg, **common)
    finally:
        if metrics_fh is not None:
            metrics_fh.close()
        if prof:
            import jax

            jax.profiler.stop_trace()


def cmd_plot(args):
    from stochquant import viz

    viz.live_plot(args.follow)


def cmd_reference_import(args):
    from stochquant.io import checkpoint as ckpt

    cfg = PRESETS[args.preset]
    if not isinstance(cfg, ChainConfig):
        sys.exit("reference-import only applies to chain presets")
    state = ckpt.import_reference(args.file, cfg)
    ckpt.save(args.out, state, cfg)
    print(f"imported {args.file} -> {args.out}")


def main(argv=None):
    compile_cache.configure()
    p = argparse.ArgumentParser(prog="stochquant")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run a preset simulation")
    r.add_argument("--preset", required=True)
    r.add_argument("--frames", type=int)
    r.add_argument("--loops", type=int)
    r.add_argument("--chains", type=int)
    r.add_argument("--dtau", type=float)
    r.add_argument("--seed", type=int)
    r.add_argument("--fps", type=int, help="frames per metrics record")
    r.add_argument("--burn", type=int, default=0, help="burn-in frames (means reset after)")
    r.add_argument(
        "--backend",
        default="auto",
        choices=list(runtime.BACKENDS),
        help="execution path: cuda (the CUDA chain-frame kernel), xla (the "
        "scan integrators) or auto (cuda where the kernel covers the "
        "config on a GPU, xla otherwise; see runtime.select_path)",
    )
    r.add_argument(
        "--measure-loops",
        action="store_true",
        help="gauge presets: per-frame Polyakov loop + final Wilson-loop table",
    )
    r.add_argument(
        "--scheme", choices=["em", "heun", "lm", "exact"],
        help="integration scheme: em | heun | lm (chains) | exact "
        "(exact-OU propagator — chains: BACKGROUND frozen-omega, any BC; "
        "fields: free_field, per-rfftn-mode)",
    )
    r.add_argument(
        "--rng", choices=["threefry", "threefry13"],
        help="noise generator: threefry (20 rounds, the default) or "
        "threefry13 (reduced-round, faster); both counter-based and "
        "layout-invariant",
    )
    r.add_argument("--out", help="checkpoint output path (.npz)")
    r.add_argument("--resume", help="checkpoint to resume from (.npz)")
    r.add_argument(
        "--checkpoint-every", type=int, default=0, metavar="N",
        help="also write the checkpoint every N frames (preemption safety)",
    )
    r.add_argument(
        "--auto-resume", action="store_true",
        help="if --out already exists, resume from it and count its frames "
        "toward --frames (restartable-after-preemption loop)",
    )
    r.add_argument("--metrics", help="write JSON-lines metrics here instead of stdout")
    r.add_argument("--profile", help="capture a jax.profiler trace into this directory")
    r.set_defaults(fn=cmd_run)

    pl = sub.add_parser("plot", help="live-plot a metrics stream (matplotlib)")
    pl.add_argument("--follow", required=True, help="metrics .jsonl file to tail")
    pl.set_defaults(fn=cmd_plot)

    ri = sub.add_parser("reference-import", help="convert a reference %a checkpoint")
    ri.add_argument("--file", required=True)
    ri.add_argument("--preset", required=True)
    ri.add_argument("--out", default="imported.npz")
    ri.set_defaults(fn=cmd_reference_import)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
