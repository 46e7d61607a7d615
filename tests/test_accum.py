"""Two-level observable accumulation: precision gates (VERDICT r1 weak 1).

The reference accumulates running means in double (tauhost.c:255-271,
tau_kernel.cl:144-145); fp32 per-sample running means silently stall near
n ≈ 10⁶–10⁷ samples.  These tests pin the hardened scheme (frame sums +
per-frame merge, integrators/accum.py) against fp64 shadows at counts far
past the stall point.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from stochquant.integrators import accum


def test_merge_tracks_fp64_shadow_over_2e7_samples():
    """20k frames × 1000 samples = 2×10⁷ samples — 4× past the fp32
    per-sample stall (2²⁴ ≈ 1.7×10⁷) — must track the exact fp64 mean to
    ~1e-5 relative."""
    rs = np.random.RandomState(7)
    loops = 1000
    n_frames = 20_000
    # per-frame means drawn around 1.0 (worst case: increments tiny vs mean)
    frame_means = (1.0 + 0.1 * rs.standard_normal(n_frames)).astype(np.float64)
    frame_sums = (frame_means * loops).astype(np.float32)

    mean32 = jnp.zeros((), jnp.float32)
    runs = 0
    for s in frame_sums:
        n_new = jnp.float32(runs + loops)
        mean32 = accum.merge_frame_sum(mean32, jnp.float32(s), loops, n_new)
        runs += loops

    exact = np.cumsum(frame_sums.astype(np.float64))[-1] / (n_frames * loops)
    rel = abs(float(mean32) - exact) / abs(exact)
    assert rel < 1e-5, (float(mean32), exact, rel)


def _frame_delta(run_frames, init_state, replace_big, loops):
    """Run one frame twice: from a fresh state (frame mean = merged result at
    runs=0) and from a state preloaded with runs≫2²⁴ and mean=1 — the same
    trajectory both times (the frame sum is count-independent), so the big-run
    merge is exactly checkable in fp64."""
    fresh, _ = run_frames(init_state, 1)
    big0 = replace_big(init_state)
    big1, _ = run_frames(big0, 1)
    return fresh, big0, big1


def test_chain_mean_does_not_stall_past_2pow24():
    from stochquant import actions
    from stochquant.config import ChainConfig
    from stochquant.integrators import langevin

    cfg = ChainConfig(
        action="harmonic", n_sites=16, dt=0.2, dtau=1e-3, n_chains=2,
        loops=100, seed=11,
    )
    act = actions.get(cfg.action)
    s0 = langevin.init_chain_state(cfg, act)
    BIG = 20_000_000  # > 2**24: the old per-sample scheme froze here

    run = lambda s, n: langevin.run_frames(s, act, cfg, n)
    fresh, big0, big1 = _frame_delta(
        run,
        s0,
        lambda s: s._replace(
            runs=s.runs.at[:, 0].set(BIG),
            x_mean=jnp.ones_like(s.x_mean),
        ),
        cfg.loops,
    )
    frame_mean = np.asarray(fresh.x_mean, np.float64)  # merge at runs=0 = S/loops
    expected = 1.0 + (frame_mean - 1.0) * cfg.loops / (BIG + cfg.loops)
    got = np.asarray(big1.x_mean, np.float64)
    delta = got - 1.0
    want = expected - 1.0
    # increments are ~5e-6·(M_f − 1); the fp32 quantization error of one merge
    # is ≤ ulp(1.0) ≈ 6e-8 — demand the delta is present and within 5%+ulp
    assert np.all(np.abs(delta - want) < 0.05 * np.abs(want) + 2e-7), (
        delta[:, :4], want[:, :4]
    )
    assert np.any(delta != 0.0), "mean stalled at large count"


def test_field_mean_does_not_stall_past_2pow24():
    from stochquant.actions import phi4 as phi4_mod
    from stochquant.config import FieldConfig
    from stochquant.integrators import field as field_mod

    cfg = FieldConfig(action="phi4", shape=(8, 8), dtau=0.01, n_chains=2,
                      loops=10, seed=3)
    act = phi4_mod.get_field(cfg.action)
    s0 = field_mod.init_field_state(cfg)
    BIG = 20_000_000

    run = lambda s, n: field_mod.run_field_frames(s, act, cfg, n)
    fresh, big0, big1 = _frame_delta(
        run,
        s0,
        lambda s: s._replace(
            runs=s.runs.at[:, 0].set(BIG),
            phi2_mean=jnp.ones_like(s.phi2_mean),
        ),
        cfg.loops,
    )
    frame_mean = np.asarray(fresh.phi2_mean, np.float64)
    expected = 1.0 + (frame_mean - 1.0) * cfg.loops / (BIG + cfg.loops)
    got = np.asarray(big1.phi2_mean, np.float64)
    assert np.all(
        np.abs((got - 1.0) - (expected - 1.0)) < 0.05 * np.abs(expected - 1.0) + 2e-7
    )
    assert np.any(got != 1.0), "mean stalled at large count"


def test_kernel_epilogue_merge_matches_xla_at_large_count():
    """The CUDA chain kernel's frame (its host build here) goes through the
    same merge expression as the XLA path — at runs ≫ 2²⁴ the counts must
    stay bitwise identical and the merges agree."""
    from stochquant import actions
    from stochquant.config import ChainConfig
    from stochquant.integrators import langevin
    from stochquant.kernels import chain_cuda

    cfg = ChainConfig(
        action="double_well", n_sites=32, dt=0.05, dtau=1e-4, n_chains=4,
        loops=20, seed=5,
    )
    act = actions.get(cfg.action)
    s0 = langevin.init_chain_state(cfg, act)
    s0 = s0._replace(
        runs=s0.runs.at[:, 0].set(20_000_000),
        x_mean=jnp.ones_like(s0.x_mean),
        x2_mean=jnp.full_like(s0.x2_mean, 0.5),
    )
    a, _ = langevin.run_frames(s0, act, cfg, 2)
    b, _ = chain_cuda.run_frames(s0, act, cfg, 2, host=True)
    np.testing.assert_array_equal(np.asarray(a.runs), np.asarray(b.runs))
    np.testing.assert_allclose(
        np.asarray(a.f), np.asarray(b.f), rtol=2e-6, atol=2e-6
    )
    # the merged means must have moved off 1.0 (no stall) and the two paths'
    # merge deltas must agree (same expression, trajectory noise ≤ ulp)
    da = np.asarray(a.x_mean, np.float64) - 1.0
    db = np.asarray(b.x_mean, np.float64) - 1.0
    assert np.any(da != 0.0) and np.any(db != 0.0), "mean stalled at large count"
    np.testing.assert_allclose(da, db, rtol=0.1, atol=2.5e-7)


def test_runs_counter_survives_uint32_overflow():
    """4.3e9 accepted micro-steps used to wrap the uint32 `runs` silently
    (VERDICT r2 item 5); the (lo, hi) pair must carry across 2**32 and keep
    merging with the correct total count."""
    from stochquant.actions import phi4 as phi4_mod
    from stochquant.config import FieldConfig
    from stochquant.integrators import field as field_mod

    cfg = FieldConfig(action="phi4", shape=(8, 8), dtau=0.01, n_chains=2,
                      loops=10, seed=3)
    act = phi4_mod.get_field(cfg.action)
    s0 = field_mod.init_field_state(cfg)
    NEAR = 2**32 - 4  # + one frame of 10 accepted samples crosses 2**32
    s0 = s0._replace(
        runs=s0.runs.at[:, 0].set(np.uint32(NEAR)),
        phi2_mean=jnp.ones_like(s0.phi2_mean),
    )
    s1, m = field_mod.run_field_frames(s0, act, cfg, 1)
    assert np.all(np.asarray(m["stable"])), "frame must be accepted for this gate"
    total = accum.runs_total(s1.runs)
    np.testing.assert_array_equal(total, np.uint64(NEAR + cfg.loops))
    assert np.all(np.asarray(s1.runs)[:, 1] == 1), "carry into the high word"
    # the merge weight at n≈2³² is loops/n ≈ 2.3e-9: far below fp32 ulp of a
    # mean of O(1) — the mean must *not* move (and must not blow up)
    got = np.asarray(s1.phi2_mean)
    assert np.all(np.isfinite(got))

    # helper self-checks: runs_after crosses the boundary (to f32 relative
    # accuracy — the count feeds only the merge *weight*, ulp(2³²) = 512)
    r = jnp.asarray([[2**32 - 4, 0]], jnp.uint32)
    n = float(accum.runs_after(r, 10)[0])
    assert abs(n - (2**32 + 6)) <= 2**32 * 2**-23, n
    b = accum.bump_runs(r, 10, jnp.asarray([True]))
    np.testing.assert_array_equal(np.asarray(b), [[6, 1]])
    nb = accum.bump_runs(r, 10, jnp.asarray([False]))
    np.testing.assert_array_equal(np.asarray(nb), np.asarray(r))
