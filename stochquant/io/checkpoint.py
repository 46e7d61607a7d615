"""Full-state checkpointing.

The reference checkpoint drops the RNG state and ignores ω on resume
(tauhost.c:122-124 — flaw F4), so resumed runs are not statistically
continuous.  Here a checkpoint is the complete ``ChainState``/``FieldState``
pytree plus the serialized config: resume-then-run is *bitwise* identical to
an uninterrupted run (tests/test_checkpoint.py).

Format: a single ``.npz`` with one entry per state leaf plus the config
JSON; portable, mmap-friendly, no external deps.  Interop with the
reference's "%a" format lives in io/reference_fmt.py / the C++ codec.
"""

from __future__ import annotations

import json
from typing import Union

import jax
import numpy as np

from stochquant.config import ChainConfig, FieldConfig
from stochquant.integrators import accum as accum_mod
from stochquant.integrators.complex_field import ComplexFieldConfig, ComplexFieldState
from stochquant.integrators.complex_langevin import (
    CLState,
    ComplexChainConfig,
    ComplexChainState,
    ComplexLangevinConfig,
)
from stochquant.integrators.field import FieldState
from stochquant.integrators.gauge import GaugeConfig, GaugeState
from stochquant.integrators.langevin import ChainState

# kind tag -> (state class, config class); tags are stable on-disk identifiers
_KIND = {
    "chain": (ChainState, ChainConfig),
    "field": (FieldState, FieldConfig),
    "complex0d": (CLState, ComplexLangevinConfig),
    "complex_chain": (ComplexChainState, ComplexChainConfig),
    "complex_field": (ComplexFieldState, ComplexFieldConfig),
    "gauge": (GaugeState, GaugeConfig),
}
_STATE_KIND = {cls: kind for kind, (cls, _) in _KIND.items()}


def _prune_stale_shards(path, keep_count=None) -> None:
    """Delete ``{path}.proc*-of-*.npz`` files from a previous generation.

    A checkpoint re-saved under a different process count (or re-saved as a
    single file) must not leave old shard files behind: stale ``proc0-of-4``
    sorts after fresh ``proc0-of-2`` and would silently win in the loader,
    and a leftover shard makes ``is_sharded_checkpoint`` prefer stale sharded
    state over a fresh single-file save.  ``keep_count`` preserves the
    current generation's ``*-of-{keep_count}`` files.  Multi-process safe:
    concurrent deleters tolerate already-gone files."""
    import glob as glob_mod
    import os
    import re

    for f in glob_mod.glob(f"{glob_mod.escape(str(path))}.proc*-of-*.npz"):
        m = re.search(r"\.proc\d+-of-(\d+)\.npz$", f)
        if m and keep_count is not None and int(m.group(1)) == keep_count:
            continue
        try:
            os.remove(f)
        except FileNotFoundError:
            pass  # another process pruned it first


def save(path, state: Union[ChainState, FieldState], cfg, *, frames_done=None) -> None:
    """Write the full state + config (and, when given, the completed-frame
    count — the authoritative resume progress: the step-counter heuristic
    cannot distinguish burn-in from measurement frames)."""
    kind = _STATE_KIND[type(state)]
    payload = {
        f"state_{name}": np.asarray(leaf)
        for name, leaf in zip(state._fields, state)
    }
    meta = {"kind": kind, "config": cfg.to_json(), "version": 1}
    if frames_done is not None:
        meta["frames_done"] = int(frames_done)
    payload["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    with open(path, "wb") as fh:
        np.savez(fh, **payload)
    # a single-file save supersedes any earlier sharded generation at `path`
    _prune_stale_shards(path, keep_count=None)


def read_meta(path) -> dict:
    """Parse just the metadata record of a checkpoint (kind, config JSON,
    version, optional frames_done) without touching the arrays."""
    with np.load(path) as z:
        return json.loads(bytes(z["meta"].tobytes()).decode())


# ---------------------------------------------------------------------------
# Sharded / multi-host checkpointing (SURVEY.md §5 "sharded save/restore").
#
# ``save`` gathers every leaf to one host — which throws on multi-host
# (non-fully-addressable) arrays, so a 32⁴ lattice sharded across hosts
# could not checkpoint at all (VERDICT r1 item 4).  Here each process writes
# only its *addressable* shards plus placement metadata (the global shape
# and the PartitionSpec axis names per leaf); restore rebuilds global arrays
# with ``jax.make_array_from_single_device_arrays`` on the caller's mesh.
# ---------------------------------------------------------------------------


def _shard_key(index, shape) -> str:
    """Canonical string for a shard's global position: 'a:b,c:d,...'."""
    parts = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = dim if sl.stop is None else int(sl.stop)
        parts.append(f"{start}:{stop}")
    return ",".join(parts) if parts else ":"


def _spec_to_json(leaf):
    sharding = getattr(leaf, "sharding", None)
    spec = getattr(sharding, "spec", None)
    if spec is None:
        return []  # replicated (single-device or host numpy)
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            out.append(list(entry))
        else:
            out.append(entry)
    return out


def _spec_from_json(entries):
    from jax.sharding import PartitionSpec as P

    return P(*[tuple(e) if isinstance(e, list) else e for e in entries])


def save_auto(path, state, cfg, *, frames_done=None) -> None:
    """``save`` when every leaf is fully addressable; ``save_sharded``
    otherwise (multi-host arrays cannot be gathered to one host)."""
    leaves = jax.tree_util.tree_leaves(state)
    if any(
        isinstance(l, jax.Array) and not l.is_fully_addressable for l in leaves
    ):
        save_sharded(path, state, cfg, frames_done=frames_done)
    else:
        save(path, state, cfg, frames_done=frames_done)


def read_meta_any(path) -> dict:
    """read_meta for either checkpoint flavor (single-file or sharded)."""
    import glob as glob_mod

    if is_sharded_checkpoint(path):
        return read_meta(sorted(glob_mod.glob(f"{path}.proc*-of-*.npz"))[0])
    return read_meta(path)


def shard_path(path, process_index=None, process_count=None) -> str:
    pid = jax.process_index() if process_index is None else process_index
    n = jax.process_count() if process_count is None else process_count
    return f"{path}.proc{pid}-of-{n}.npz"


def is_sharded_checkpoint(path) -> bool:
    """True if ``path`` names a sharded checkpoint (per-process files)."""
    import glob as glob_mod

    return bool(glob_mod.glob(f"{path}.proc*-of-*.npz"))


def save_sharded(path, state, cfg, *, frames_done=None) -> str:
    """Write this process's addressable shards of a (possibly multi-host)
    state.  Every process must call this; each writes
    ``{path}.proc{i}-of-{n}.npz``.  Returns this process's file path."""
    kind = _STATE_KIND[type(state)]
    payload = {}
    specs = {}
    shapes = {}
    for name, leaf in zip(state._fields, state):
        specs[name] = _spec_to_json(leaf)
        if isinstance(leaf, jax.Array) and hasattr(leaf, "addressable_shards"):
            shapes[name] = list(leaf.shape)
            seen = set()
            for shard in leaf.addressable_shards:
                key = _shard_key(shard.index, leaf.shape)
                if key in seen:
                    continue  # replicated across local devices
                seen.add(key)
                payload[f"shard_{name}__{key}"] = np.asarray(shard.data)
        else:
            arr = np.asarray(leaf)
            shapes[name] = list(arr.shape)
            payload[f"shard_{name}__{_shard_key((slice(None),) * arr.ndim, arr.shape)}"] = arr
    meta = {
        "kind": kind,
        "config": cfg.to_json(),
        "version": 2,
        "sharded": True,
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "specs": specs,
        "shapes": shapes,
    }
    if frames_done is not None:
        meta["frames_done"] = int(frames_done)
    payload["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    out = shard_path(path)
    with open(out, "wb") as fh:
        np.savez(fh, **payload)
    # drop shards from any earlier generation saved under a different
    # process count (they would mix with — and could shadow — this save)
    _prune_stale_shards(path, keep_count=jax.process_count())
    return out


def load_sharded(path, mesh):
    """Restore a sharded checkpoint onto ``mesh``.

    Each process reads whichever per-process files are visible locally and
    materializes only the shards its own devices need (matching by global
    index), so restore scales to multi-host without gathering.  The mesh
    must have the same axis names the state was sharded with; the device
    *count* per axis may even differ as long as the shard boundaries align.
    Returns (state, cfg)."""
    import glob as glob_mod

    from jax.sharding import NamedSharding

    files = sorted(glob_mod.glob(f"{path}.proc*-of-*.npz"))
    if not files:
        raise FileNotFoundError(f"no sharded checkpoint files at {path}.proc*")
    metas = []
    shards = {}  # name -> {key: np.ndarray}
    for f in files:
        with np.load(f) as z:
            metas.append(json.loads(bytes(z["meta"].tobytes()).decode()))
            for k in z.files:
                if not k.startswith("shard_"):
                    continue
                name, key = k[len("shard_"):].rsplit("__", 1)
                shards.setdefault(name, {})[key] = z[k]
    # all shard files must come from ONE save generation: mixing files
    # written under different process counts (or format versions) would
    # silently interleave stale and fresh arrays per key
    gens = {(m.get("version"), m.get("process_count")) for m in metas}
    if len(gens) > 1:
        raise ValueError(
            f"checkpoint {path}: mixed shard generations "
            f"{sorted(gens)} — files from different saves (version, "
            "process_count) found; delete the stale ones"
        )
    meta = metas[0]
    cls, cfg_cls = _KIND[meta["kind"]]
    cfg = cfg_cls.from_json(meta["config"])

    # pre-r3 sharded checkpoints: (C,) runs → (C, 2) pair (see _upgrade_runs)
    if "runs" in shards and len(meta["shapes"].get("runs", ())) == 1:
        shards["runs"] = {
            f"{k},0:2": _upgrade_runs("runs", v) for k, v in shards["runs"].items()
        }
        meta["shapes"]["runs"] = list(meta["shapes"]["runs"]) + [2]

    leaves = []
    for name in cls._fields:
        shape = tuple(meta["shapes"][name])
        spec = _spec_from_json(meta["specs"][name])
        sharding = NamedSharding(mesh, spec)
        available = shards.get(name, {})
        idx_map = sharding.devices_indices_map(shape)
        arrays = []
        devices = []
        for d in sharding.addressable_devices:
            key = _shard_key(idx_map[d], shape)
            if key not in available:
                raise ValueError(
                    f"checkpoint {path}: leaf {name!r} is missing shard {key} "
                    f"(files visible: {len(files)}/{meta['process_count']}; "
                    "restore mesh shard boundaries must align with the saved "
                    "ones)"
                )
            arrays.append(jax.device_put(available[key], d))
            devices.append(d)
        leaves.append(
            jax.make_array_from_single_device_arrays(shape, sharding, arrays)
        )
    return cls(*leaves), cfg


def _upgrade_runs(name: str, a: np.ndarray) -> np.ndarray:
    """Pre-r3 checkpoints store ``runs`` as a (C,) uint32; it is now a
    (C, 2) (lo, hi) 64-bit pair (accum.init_runs).  Upgrade on load with
    hi = 0 — bitwise-continuous resume for counts below 2³²."""
    if name == "runs" and a.ndim == 1:
        return np.stack([a, np.zeros_like(a)], axis=-1)
    return a


# moment channels added in r2; older checkpoints lack them.  Backfilled with
# zeros shaped like the paired second moment — the restored trajectory and
# all other observables stay bitwise continuous, but the backfilled fourth
# moment is only unbiased after a reset_*_means (warned).
_MOMENT_BACKFILL = {"x4_mean": "x2_mean", "mag4_mean": "mag2_mean"}


def load(path):
    """Returns (state, cfg)."""
    backfilled = []
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        cls, cfg_cls = _KIND[meta["kind"]]
        leaves = []
        for name in cls._fields:
            key = f"state_{name}"
            if key in z:
                leaves.append(_upgrade_runs(name, z[key]))
            elif name in _MOMENT_BACKFILL:
                leaves.append(np.zeros_like(z[f"state_{_MOMENT_BACKFILL[name]}"]))
                backfilled.append(name)
            else:
                raise KeyError(f"checkpoint {path} is missing leaf {name!r}")
    if backfilled:
        import warnings

        warnings.warn(
            f"checkpoint {path} predates the {backfilled} channel(s); "
            "backfilled with zeros — the fourth-moment estimates are only "
            "unbiased after the next reset of the running means",
            stacklevel=2,
        )
    cfg = cfg_cls.from_json(meta["config"])
    state = cls(*[jax.numpy.asarray(a) for a in leaves])
    return state, cfg


def export_reference(path, state: ChainState, chain: int = 0) -> None:
    """Write one chain of a ChainState in the reference's "%a" schema so the
    original tauhost can resume from it (its reader re-randomizes ω and RNG
    anyway — flaw F4)."""
    from stochquant.io import reference_fmt
    from stochquant.integrators.langevin import connected_correlator

    corr = np.asarray(connected_correlator(state))[chain]
    reference_fmt.write(
        path,
        xavg=corr,
        xx0=np.asarray(state.xx0_mean)[chain],
        x=np.asarray(state.x_mean)[chain],
        f=np.asarray(state.f)[chain],
        omega=float(np.asarray(state.omega)[chain]),
        runs=int(accum_mod.runs_total(state.runs)[chain]),
        dtau=float(np.asarray(state.dtau)[chain]),
    )


def import_reference(path, cfg: ChainConfig) -> ChainState:
    """Load a reference-format checkpoint into a (replicated) ChainState —
    the cross-validation entry point for data produced by the original code.
    Reference files carry no RNG state (flaw F4); the imported state starts a
    fresh counter stream at ``step=0``."""
    import jax.numpy as jnp

    from stochquant.io import reference_fmt

    d = reference_fmt.read(path, cfg.n_sites)
    C = cfg.n_chains
    rep = lambda a: jnp.broadcast_to(jnp.asarray(a, cfg.jdtype)[None, :], (C, cfg.n_sites))
    return ChainState(
        f=rep(d["f"]),
        omega=jnp.full((C,), d["omega"], cfg.jdtype),
        x_mean=rep(d["x"]),
        xx0_mean=rep(d["xx0"]),
        x2_mean=jnp.zeros((C, cfg.n_sites), cfg.jdtype),
        x4_mean=jnp.zeros((C, cfg.n_sites), cfg.jdtype),
        runs=jnp.stack(
            [
                jnp.full((C,), d["runs"] & 0xFFFFFFFF, jnp.uint32),
                jnp.full((C,), d["runs"] >> 32, jnp.uint32),
            ],
            axis=-1,
        ),
        dtau=jnp.full((C,), min(d["dtau"], cfg.dtau), cfg.jdtype),  # tauhost.c:131-137 clamp
        stab_cnt=jnp.zeros((C,), jnp.int32),
        lrg_vl=jnp.max(jnp.abs(rep(d["f"])), axis=-1),
        spec_mean=jnp.zeros((C, cfg.n_sites // 2 + 1), cfg.jdtype),
        step=jnp.uint32(0),
    )
