"""The CUDA chain-frame kernel (kernels/chain_cuda.py, cuda/).

On the CPU: the kernel's per-chain arithmetic (cuda/chain_math.h) built for
the host and run through the same wrapper, epilogue and chain sharding as
the device kernel, against ``langevin.run_frames``; the noise bits; the
wrapper's geometry, parameter packing and eligibility; the native build's
source hash.  Tests marked ``gpu`` run the compiled kernel on the card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from stochquant import actions, native, rng
from stochquant.config import (
    BoundaryCondition as BC,
    ChainConfig,
    Formulation as F,
    Scheme,
)
from stochquant.integrators import langevin
from stochquant.kernels import chain_cuda
from stochquant.parallel import make_mesh, shard_chain_state

DW = ChainConfig(
    action="double_well", n_sites=40, dt=0.05, dtau=2e-4, n_chains=6,
    loops=60, seed=11,
)

# (id, config): every formulation / boundary / RNG / action the kernel
# covers, site counts that do and do not fill whole lanes, odd loops
CASES = [
    ("dw_bg_fixed", DW),
    ("dw_bg_periodic", dataclasses.replace(DW, bc=BC.PERIODIC)),
    ("dw_bg_dirichlet", dataclasses.replace(DW, bc=BC.DIRICHLET)),
    ("dw_direct", dataclasses.replace(DW, formulation=F.DIRECT, dtau=1e-4)),
    ("dw_frozen_omega", dataclasses.replace(DW, parisi=False)),
    ("dw_threefry13", dataclasses.replace(DW, rng_impl="threefry13")),
    ("dw_odd_loops", dataclasses.replace(DW, loops=37)),
    ("dw_ghost_override", dataclasses.replace(DW, ghost_override=(-0.5, 0.9))),
    ("harmonic_bg", ChainConfig(
        action="harmonic", n_sites=33, dt=0.1, dtau=1e-3, n_chains=4,
        loops=40, seed=2)),
    ("anharmonic_periodic", ChainConfig(
        action="anharmonic", n_sites=64, dt=0.25, dtau=0.005, n_chains=4,
        loops=50, seed=3, bc=BC.PERIODIC, formulation=F.DIRECT)),
    ("anharmonic_3_sites", ChainConfig(
        action="anharmonic", n_sites=3, dt=0.5, dtau=0.01, n_chains=3,
        loops=20, seed=4, bc=BC.PERIODIC, formulation=F.DIRECT)),
    ("harmonic_dirichlet", ChainConfig(
        action="harmonic", n_sites=16, dt=0.2, dtau=0.01, n_chains=4,
        loops=50, bc=BC.DIRICHLET, formulation=F.DIRECT)),
]

#: host libm (tanhf/logf/cosf/sinf) rounds differently from XLA's CPU
#: lowering by an ulp or so; over these short frames that stays far below
#: the bound
ATOL = 1e-5


def _run_both(cfg, frames=2):
    act = actions.get(cfg.action)
    s0 = langevin.init_chain_state(cfg, act)
    ref, mref = langevin.run_frames(s0, act, cfg, frames)
    out, mout = chain_cuda.run_frames(s0, act, cfg, frames, host=True)
    return ref, mref, out, mout


@pytest.mark.parametrize("cfg", [c for _, c in CASES], ids=[i for i, _ in CASES])
def test_kernel_arithmetic_matches_xla(cfg):
    ref, mref, out, mout = _run_both(cfg)
    np.testing.assert_array_equal(
        np.asarray(mref["stable"]), np.asarray(mout["stable"])
    )
    assert np.asarray(mref["stable"]).any(), "no accepted frame to compare"
    np.testing.assert_array_equal(np.asarray(ref.runs), np.asarray(out.runs))
    np.testing.assert_array_equal(np.asarray(ref.step), np.asarray(out.step))
    np.testing.assert_array_equal(np.asarray(ref.dtau), np.asarray(out.dtau))
    for name in ("f", "omega", "x_mean", "xx0_mean", "x2_mean", "lrg_vl"):
        np.testing.assert_allclose(
            np.asarray(getattr(out, name)), np.asarray(getattr(ref, name)),
            rtol=1e-5, atol=ATOL, err_msg=name,
        )
    np.testing.assert_allclose(
        np.asarray(out.x4_mean), np.asarray(ref.x4_mean), rtol=1e-4, atol=ATOL
    )
    if cfg.bc == BC.DIRICHLET:
        f = np.asarray(out.f)
        assert np.all(f[:, 0] == 0.0) and np.all(f[:, -1] == 0.0)


def test_kernel_rejects_and_rolls_back_like_xla():
    """A hopeless Δτ trips the detector on both paths: the frame is rolled
    back, Δτ shrinks and the step counter still advances."""
    cfg = ChainConfig(
        action="harmonic", n_sites=32, dt=0.1, dtau=5.0, n_chains=2,
        loops=10, bc=BC.PERIODIC, formulation=F.DIRECT,
    )
    act = actions.get(cfg.action)
    s0 = langevin.init_chain_state(cfg, act)
    out, m = chain_cuda.run_frames(s0, act, cfg, 1, host=True)
    assert not np.any(np.asarray(m["stable"]))
    np.testing.assert_array_equal(np.asarray(out.f), np.asarray(s0.f))
    np.testing.assert_array_equal(np.asarray(out.runs), np.asarray(s0.runs))
    np.testing.assert_allclose(np.asarray(out.dtau), 5.0 * cfg.shrink, rtol=1e-6)
    assert int(out.step) == int(s0.step) + cfg.loops


@pytest.mark.parametrize("rounds", [20, 13])
def test_noise_bits_equal_rng(rounds):
    """The kernel's Threefry is rng.threefry2x32 bit for bit, keyed by
    (seed, stream, chain, site, step) as the XLA path keys it."""
    chains = np.array([0, 1, 31, 4097, 65535], np.uint32)[:, None]
    sites = np.arange(200, dtype=np.uint32)[None, :]
    k1 = np.uint32(rng.Stream.FIELD) ^ (chains << np.uint32(8))
    for step in (0, 2, 998, 2**31 + 5):
        want = rng.threefry2x32(np.uint32(7), k1, sites, np.uint32(step), rounds)
        got = chain_cuda.host_threefry(np.uint32(7), k1, sites, np.uint32(step), rounds)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g)


def test_host_threefry_rejects_other_round_counts():
    with pytest.raises(ValueError, match="20 or 13"):
        chain_cuda.host_threefry(0, 0, np.arange(4), 0, rounds=12)


@pytest.mark.parametrize(
    "n_sites,lanes_used",
    [(3, 3), (32, 32), (33, 17), (100, 25), (200, 29), (512, 32)],
)
def test_geometry_sites_per_lane(n_sites, lanes_used):
    """One warp per chain: S = ceil(N/32) consecutive sites per lane (200
    sites -> 7 per lane, padded to 224, lanes 29-31 idle)."""
    S = chain_cuda.sites_per_lane(n_sites)
    assert S * chain_cuda.WARP >= n_sites > (S - 1) * chain_cuda.WARP
    assert S <= chain_cuda.MAX_SITES_PER_LANE
    assert -(-n_sites // S) == lanes_used


def _dw(**kw):
    return dataclasses.replace(DW, **kw)


@pytest.mark.parametrize(
    "action,cfg,match",
    [
        ("double_well", _dw(scheme=Scheme.HEUN), "HEUN"),
        ("double_well", _dw(scheme=Scheme.LM), "LM"),
        ("harmonic", _dw(action="harmonic", scheme=Scheme.EXACT), "EXACT"),
        ("double_well", _dw(accumulate_spectrum=True), "spectrum"),
        ("poeschl_teller", _dw(action="poeschl_teller"), "no kernel form"),
        ("double_well", _dw(dtype="float64"), "float32"),
        ("double_well", _dw(n_sites=513), "n_sites"),
        ("double_well", _dw(n_sites=2), "n_sites"),
    ],
)
def test_eligibility(action, cfg, match):
    act = actions.get(action)
    reason = chain_cuda.unsupported_reason(act, cfg)
    assert reason is not None and match in reason
    with pytest.raises(ValueError, match=match):
        chain_cuda.pack_params(act, cfg)


def test_pack_params_layout():
    act = actions.get("double_well")
    ip, dp = chain_cuda.pack_params(act, DW)
    assert ip.dtype == np.int32 and ip.shape == (chain_cuda.N_IPARAMS,)
    assert dp.dtype == np.float64 and dp.shape == (chain_cuda.N_DPARAMS,)
    n, loops, rounds, aid, bc, bg, zm = ip.tolist()
    assert (n, loops, rounds) == (40, 60, 20)
    assert aid == chain_cuda.KERNEL_ACTIONS["double_well"]
    assert (bc, bg, zm) == (int(BC.FIXED_BG), 1, 1)
    assert dp[0] == pytest.approx(1.0 / 0.05**2)         # m/Δt²
    assert dp[2] == pytest.approx(20.0)                   # 1/Δt
    assert dp[7:9].tolist() == [-0.8, 0.8]                 # asymptotes
    assert dp[9:11].tolist() == pytest.approx([-0.05, 40 * 0.05])
    assert dp[11] == 0.8 and dp[17] == pytest.approx(0.64)  # η, η²
    assert dp[15] == float(np.float32(1) / np.float32(0.64))  # 1/η² in f32
    _, dp13 = chain_cuda.pack_params(act, dataclasses.replace(DW, parisi=False))
    ip13, _ = chain_cuda.pack_params(act, dataclasses.replace(DW, parisi=False))
    assert ip13[6] == 0


def test_chain_sharded_run_is_bitwise_the_unsharded_run():
    """Each device runs the kernel on its own chains keyed by their global
    indices, so splitting the ensemble changes nothing."""
    cfg = dataclasses.replace(DW, n_chains=8, loops=20)
    act = actions.get(cfg.action)
    s0 = langevin.init_chain_state(cfg, act)
    ref, mref = chain_cuda.run_frames(s0, act, cfg, 2, host=True)
    mesh = make_mesh([("chain", 4)])
    out, mout = chain_cuda.run_frames_sharded(
        shard_chain_state(s0, mesh), act, cfg, 2, mesh, host=True
    )
    for name, a, b in zip(ref._fields, ref, out):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
    for k in mref:
        np.testing.assert_array_equal(np.asarray(mref[k]), np.asarray(mout[k]))


def test_native_rebuilds_when_sources_change(tmp_path, monkeypatch):
    """Libraries are keyed by a hash of their sources: an edit builds a new
    library, an unchanged tree reuses the old one."""
    src = tmp_path / "lib.cpp"
    src.write_text('extern "C" int sq_answer() { return 41; }\n')
    monkeypatch.setattr(native, "_PKG", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setitem(native.LIBS, "probe", (["lib.cpp"], [], "cxx"))
    p1 = native.build("probe")
    assert native.build("probe") == p1
    src.write_text('extern "C" int sq_answer() { return 42; }\n')
    p2 = native.build("probe")
    assert p2 != p1
    import ctypes

    assert ctypes.CDLL(p2).sq_answer() == 42


# --------------------------------------------------------------- gpu ----


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [c for _, c in CASES], ids=[i for i, _ in CASES])
def test_device_kernel_matches_xla(gpu, cfg):
    """The compiled kernel against the XLA scan on the card: equal stable
    flags, state within the kernel-vs-XLA rounding bound."""
    act = actions.get(cfg.action)
    s0 = langevin.init_chain_state(cfg, act)
    ref, mref = langevin.run_frames(s0, act, cfg, 2)
    out, mout = chain_cuda.run_frames(s0, act, cfg, 2)
    np.testing.assert_array_equal(
        np.asarray(mref["stable"]), np.asarray(mout["stable"])
    )
    for name in ("f", "omega", "x_mean", "xx0_mean", "x2_mean", "lrg_vl"):
        np.testing.assert_allclose(
            np.asarray(getattr(out, name)), np.asarray(getattr(ref, name)),
            rtol=1e-5, atol=ATOL, err_msg=name,
        )


@pytest.mark.gpu
@pytest.mark.parametrize("rounds", [20, 13])
def test_device_noise_bits_equal_rng(gpu, rounds):
    chains = np.array([0, 1, 31, 4097, 65535], np.uint32)[:, None]
    k1 = np.broadcast_to(np.uint32(rng.Stream.FIELD) ^ (chains << np.uint32(8)), (5, 200))
    c0 = np.broadcast_to(np.arange(200, dtype=np.uint32), (5, 200))
    k0 = np.full((5, 200), 3, np.uint32)
    c1 = np.full((5, 200), 1234, np.uint32)
    b0, b1, z0, z1 = chain_cuda.device_normal_pair(k0, k1, c0, c1, rounds)
    w0, w1 = rng.threefry2x32(k0.ravel(), k1.ravel(), c0.ravel(), c1.ravel(), rounds)
    np.testing.assert_array_equal(np.asarray(b0), np.asarray(w0))
    np.testing.assert_array_equal(np.asarray(b1), np.asarray(w1))
    n0, n1 = rng.normal_pair(k0.ravel(), k1.ravel(), c0.ravel(), c1.ravel(), rounds)
    np.testing.assert_allclose(np.asarray(z0), np.asarray(n0), atol=1e-6)
    np.testing.assert_allclose(np.asarray(z1), np.asarray(n1), atol=1e-6)


@pytest.mark.gpu
def test_device_sharded_chains_on_one_card(gpu):
    """run_frames_sharded over a one-device mesh is the unsharded run."""
    cfg = dataclasses.replace(DW, n_chains=64, loops=50)
    act = actions.get(cfg.action)
    s0 = langevin.init_chain_state(cfg, act)
    ref, _ = chain_cuda.run_frames(s0, act, cfg, 2)
    mesh = make_mesh([("chain", 1)])
    out, _ = chain_cuda.run_frames_sharded(s0, act, cfg, 2, mesh)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jnp.asarray(out.f).dtype == jnp.float32
