"""Wall-clock timing helpers for the benchmark.

Callers end each timed call with a device sync (``block_until_ready`` or a
host read of a result): JAX returns before the device finishes, so a timing
without one measures the enqueue.
"""

from __future__ import annotations

import time

__all__ = ["ab_timeit"]


def _summary(ts):
    ts = sorted(ts)
    return ts[len(ts) // 2], ts[0], ts[-1]


def ab_timeit(runs, reps=5):
    """Paired A/B timing in ONE process: warm every variant once, then
    round-robin the timed reps so machine drift hits all variants equally.
    Returns {name: (median, min, max)}."""
    for r in runs.values():
        r()
    ts = {k: [] for k in runs}
    for _ in range(reps):
        for k, r in runs.items():
            t0 = time.perf_counter()
            r()
            ts[k].append(time.perf_counter() - t0)
    return {k: _summary(v) for k, v in ts.items()}
