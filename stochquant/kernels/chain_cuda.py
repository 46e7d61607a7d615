"""CUDA chain-frame kernel for the batched 1-D Langevin ensemble.

The kernel (``cuda/chain_kernel.cu``, sm_90a, called through ``jax.ffi``)
runs one whole frame of ``cfg.loops`` Euler–Maruyama micro-steps per launch
with one warp per chain and the chain's sites, field and frame sums in
registers.  Noise is Threefry-2x32 keyed by (seed, stream, global chain,
global site, step) as in rng.py, so its bits equal the XLA path's.  The
frame's end — accept/reject, the running-mean merge and the Δτ controller —
is ``langevin.frame_epilogue`` in XLA, the same code the scan path runs.

What the kernel covers (anything else runs on the XLA path, chosen by
``runtime.select_path``): Scheme.EM; the BACKGROUND and DIRECT formulations;
all three boundary conditions; the zero mode; ``threefry`` and
``threefry13``; the harmonic, double-well and anharmonic actions; float32;
3 <= n_sites <= 512 (at most 16 sites per lane).

The per-chain arithmetic (``cuda/chain_math.h``) is also built for the host
(``chain_host``): :func:`host_frame` runs it chain by chain, and
``run_frames(..., host=True)`` puts it in place of the device kernel so the
wrapper, the epilogue and the chain sharding are testable on a CPU.
"""

from __future__ import annotations

import ctypes
import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from stochquant import native, rng
from stochquant.actions.base import QMAction
from stochquant.config import ChainConfig, Formulation, Scheme
from stochquant.integrators import langevin
from stochquant.integrators.langevin import ChainState

__all__ = [
    "unsupported_reason",
    "sites_per_lane",
    "pack_params",
    "chain_frame",
    "run_frames",
    "run_frames_sharded",
    "device_normal_pair",
    "host_frame",
    "host_threefry",
]

#: action registry name -> kernel action id (chain_math.h ActionId)
KERNEL_ACTIONS = {"harmonic": 0, "double_well": 1, "anharmonic": 2}
WARP = 32
MAX_SITES_PER_LANE = 16
MAX_SITES = WARP * MAX_SITES_PER_LANE
N_IPARAMS = 7
N_DPARAMS = 18


def unsupported_reason(action: QMAction, cfg: ChainConfig) -> Optional[str]:
    """Why the kernel cannot run ``cfg``, or None if it can."""
    if cfg.scheme != Scheme.EM:
        return f"scheme {cfg.scheme.name} runs on the XLA path (kernel is EM)"
    if cfg.accumulate_spectrum:
        return "accumulate_spectrum needs an FFT per micro-step (XLA path)"
    name = getattr(action, "name", None)
    if name not in KERNEL_ACTIONS:
        return f"action {name!r} has no kernel form (kernel: {sorted(KERNEL_ACTIONS)})"
    if cfg.dtype != "float32":
        return f"dtype {cfg.dtype} (the kernel is float32)"
    if cfg.rng_impl not in ("threefry", "threefry13"):
        return f"rng_impl {cfg.rng_impl!r}"
    if not 3 <= cfg.n_sites <= MAX_SITES:
        return f"n_sites={cfg.n_sites} outside the kernel's 3..{MAX_SITES}"
    return None


def sites_per_lane(n_sites: int) -> int:
    """Sites each of a warp's 32 lanes holds (the kernel's template S)."""
    return -(-n_sites // WARP)


def _recip32(v: float) -> float:
    """float32 reciprocal of float32(v)."""
    return float(np.float32(1.0) / np.float32(v))


def pack_params(action: QMAction, cfg: ChainConfig):
    """(int32[7], float64[18]) parameter vectors in chain_math.h's layout.

    Float entries are the Python-side values XLA rounds to float32 as it
    folds them, so both paths start from the same constants; a constant
    divisor is passed as its float32 reciprocal, the form XLA's algebraic
    simplifier turns such a division into."""
    reason = unsupported_reason(action, cfg)
    if reason is not None:
        raise ValueError(f"the CUDA chain kernel cannot run this config: {reason}")
    N, dt = cfg.n_sites, cfg.dt
    background = cfg.formulation == Formulation.BACKGROUND
    has_zm = background and action.has_zero_mode and cfg.parisi
    if cfg.ghost_override is not None:
        asym_l, asym_r = cfg.ghost_override
    else:
        asym_l = action.boundary_asymptote(-1)
        asym_r = action.boundary_asymptote(+1)
    p = [0.0] * 7
    if action.name == "harmonic":
        p[0] = action.k
    elif action.name == "double_well":
        e2 = action.eta * action.eta
        w = math.sqrt(2.0 * action.v0 / action.mass) / action.eta
        p = [action.eta, w, 12.0 * action.v0, 4.0 * action.v0, _recip32(e2),
             _recip32(e2 * e2), e2]
    else:  # anharmonic
        p[:3] = [action.mu2, 4.0 * action.lam, 12.0 * action.lam]
    zm_amp = np.float32(action.zero_mode_const()) * np.float32(cfg.noise_amp)
    ip = np.array(
        [N, cfg.loops, rng.rounds_of(cfg.rng_impl), KERNEL_ACTIONS[action.name],
         int(cfg.bc), int(background), int(has_zm)],
        np.int32,
    )
    dp = np.array(
        [action.mass / (dt * dt), dt, _recip32(dt), cfg.noise_amp,
         float(zm_amp),
         (N - 1) * dt, cfg.clamp, float(asym_l), float(asym_r), -dt, N * dt,
         *p],
        np.float64,
    )
    assert ip.shape == (N_IPARAMS,) and dp.shape == (N_DPARAMS,)
    return ip, dp


# --------------------------------------------------------------- device ---

_registered = False


def _register():
    """Build (if the sources changed) and load the CUDA library, and
    register its FFI targets.  Any failure raises: there is no fallback."""
    global _registered
    if _registered:
        return
    lib = native.load("chain_cuda")
    jax.ffi.register_ffi_target(
        "sq_chain_frame", jax.ffi.pycapsule(lib.SqChainFrame), platform="CUDA"
    )
    jax.ffi.register_ffi_target(
        "sq_normal_pair", jax.ffi.pycapsule(lib.SqNormalPair), platform="CUDA"
    )
    _registered = True


def _frame_out_shapes(C: int, N: int):
    f32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)
    return (
        f32(C, N), f32(C),                          # f, omega
        f32(C, N), f32(C, N), f32(C, N), f32(C, N),  # Σx, Σx·x_mid, Σx², Σx⁴
        f32(C),                                     # lrg_vl
        jax.ShapeDtypeStruct((C,), jnp.int32),      # unstable
    )


def _host_kernel(ip, dp, scalars, f, om, lrg, dtau):
    """The kernel's contract on the host library (for CPU tests)."""
    seed, step0, chain0 = (int(v) for v in np.asarray(scalars))
    out = host_frame(
        ip, dp, seed, step0, chain0, np.asarray(f), np.asarray(om),
        np.asarray(lrg), np.asarray(dtau),
    )
    return tuple(out[k] for k in ("f", "omega", "xs", "xxs", "x2s", "x4s",
                                  "lrg_vl", "unstable"))


def chain_frame(
    state: ChainState, action: QMAction, cfg: ChainConfig, chain_offset=0,
    *, host: bool = False,
):
    """One frame: the kernel, then the shared XLA epilogue.

    ``chain_offset``: global index of the first chain in ``state`` (nonzero
    for a shard of the ensemble).  ``host=True`` runs the host build of the
    arithmetic through a callback instead of the device kernel (tests)."""
    ip, dp = pack_params(action, cfg)
    C, N = state.f.shape
    scalars = jnp.stack([
        jnp.uint32(cfg.seed),
        jnp.asarray(state.step, jnp.uint32),
        jnp.asarray(chain_offset, jnp.uint32),
    ])
    args = (scalars, state.f, state.omega, state.lrg_vl, state.dtau)
    if host:
        outs = jax.pure_callback(
            partial(_host_kernel, ip, dp), _frame_out_shapes(C, N), *args
        )
    else:
        _register()
        outs = jax.ffi.ffi_call("sq_chain_frame", _frame_out_shapes(C, N))(
            *args, iparams=ip, dparams=dp
        )
    f, om, xs, xxs, x2s, x4s, lrg, unst = outs
    return langevin.frame_epilogue(
        state, cfg, f, om, (xs, xxs, x2s, x4s), lrg, unst != 0,
        state.step + jnp.uint32(cfg.loops),
    )


@partial(jax.jit, static_argnames=("action", "cfg", "n_frames", "host"))
def run_frames(
    state: ChainState, action: QMAction, cfg: ChainConfig, n_frames: int,
    host: bool = False,
):
    """Drop-in for ``langevin.run_frames``: ``n_frames`` kernel frames in
    one jitted scan, one launch per frame."""
    return lax.scan(
        lambda s, _: chain_frame(s, action, cfg, host=host),
        state, None, length=n_frames,
    )


def run_frames_sharded(
    state: ChainState, action: QMAction, cfg: ChainConfig, n_frames: int,
    mesh, axis: str = "chain", host: bool = False,
):
    """``run_frames`` on an ensemble sharded by chains over ``axis`` of
    ``mesh``: each device runs the kernel on its own chains, keyed by their
    global indices, so the result equals the unsharded run."""
    from jax.sharding import PartitionSpec as P

    row, mat = P(axis), P(axis, None)
    specs = ChainState(
        f=mat, omega=row, x_mean=mat, xx0_mean=mat, x2_mean=mat, x4_mean=mat,
        runs=mat, dtau=row, stab_cnt=row, lrg_vl=row, spec_mean=mat, step=P(),
    )
    metric_specs = {k: P(None, axis) for k in ("stable", "dtau", "max_x")}

    def local(s):
        offset = lax.axis_index(axis).astype(jnp.uint32) * jnp.uint32(
            s.f.shape[0]
        )
        return lax.scan(
            lambda s, _: chain_frame(s, action, cfg, offset, host=host),
            s, None, length=n_frames,
        )

    fn = jax.shard_map(
        local, mesh=mesh, in_specs=(specs,), out_specs=(specs, metric_specs),
        check_vma=False,
    )
    return jax.jit(fn)(state)


def device_normal_pair(k0, k1, c0, c1, rounds: int = 20):
    """Threefry bits and both Box–Muller outputs per counter, computed on
    the GPU by the kernel's own device functions: (b0, b1, z0, z1)."""
    _register()
    arrs = [jnp.asarray(a, jnp.uint32).ravel() for a in (k0, k1, c0, c1)]
    n = arrs[0].shape[0]
    u32 = jax.ShapeDtypeStruct((n,), jnp.uint32)
    f32 = jax.ShapeDtypeStruct((n,), jnp.float32)
    return jax.ffi.ffi_call("sq_normal_pair", (u32, u32, f32, f32))(
        *arrs, rounds=np.int32(rounds)
    )


# ----------------------------------------------------------------- host ---

_u32p = ctypes.POINTER(ctypes.c_uint32)
_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f64p = ctypes.POINTER(ctypes.c_double)


def _host_lib():
    lib = native.load("chain_host")
    if not getattr(lib, "_sq_typed", False):
        lib.sq_chain_frame_host.restype = ctypes.c_int
        lib.sq_chain_frame_host.argtypes = [
            _i32p, _f64p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_int32, _f32p, _f32p, _f32p, _f32p,
            _f32p, _f32p, _f32p, _f32p, _f32p, _f32p, _f32p, _i32p,
        ]
        lib.sq_threefry_host.restype = ctypes.c_int
        lib.sq_threefry_host.argtypes = [
            ctypes.c_int32, ctypes.c_int64, _u32p, _u32p, _u32p, _u32p,
            _u32p, _u32p,
        ]
        lib._sq_typed = True
    return lib


def _ptr(a, t):
    return a.ctypes.data_as(t)


def host_frame(ip, dp, seed, step0, chain0, f, omega, lrg_vl, dtau) -> dict:
    """One kernel frame on the host: numpy in, numpy out.  Returns the
    kernel's outputs: f, omega, the four frame sums, lrg_vl, unstable."""
    ip = np.ascontiguousarray(ip, np.int32)
    dp = np.ascontiguousarray(dp, np.float64)
    f = np.ascontiguousarray(f, np.float32)
    C, N = f.shape
    ins = [np.ascontiguousarray(a, np.float32) for a in (omega, lrg_vl, dtau)]
    out = {
        "f": np.empty((C, N), np.float32),
        "omega": np.empty((C,), np.float32),
        "xs": np.empty((C, N), np.float32),
        "xxs": np.empty((C, N), np.float32),
        "x2s": np.empty((C, N), np.float32),
        "x4s": np.empty((C, N), np.float32),
        "lrg_vl": np.empty((C,), np.float32),
        "unstable": np.empty((C,), np.int32),
    }
    rc = _host_lib().sq_chain_frame_host(
        _ptr(ip, _i32p), _ptr(dp, _f64p), seed, step0, chain0, C,
        _ptr(f, _f32p), *(_ptr(a, _f32p) for a in ins),
        *(_ptr(out[k], _f32p) for k in ("f", "omega", "xs", "xxs", "x2s",
                                        "x4s", "lrg_vl")),
        _ptr(out["unstable"], _i32p),
    )
    if rc:
        raise ValueError(f"sq_chain_frame_host rejected its parameters ({rc})")
    return out


def host_threefry(k0, k1, c0, c1, rounds: int = 20):
    """Threefry-2x32 bits from the kernel's header, built for the host."""
    arrs = [np.ascontiguousarray(np.broadcast_to(a, np.broadcast_shapes(
        *(np.shape(x) for x in (k0, k1, c0, c1)))), np.uint32)
        for a in (k0, k1, c0, c1)]
    n = arrs[0].size
    o0 = np.empty(arrs[0].shape, np.uint32)
    o1 = np.empty(arrs[0].shape, np.uint32)
    rc = _host_lib().sq_threefry_host(
        rounds, n, *(_ptr(a, _u32p) for a in arrs), _ptr(o0, _u32p),
        _ptr(o1, _u32p),
    )
    if rc:
        raise ValueError(f"rounds must be 20 or 13, got {rounds}")
    return o0, o1
