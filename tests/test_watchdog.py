"""Watchdogged subprocess runner (the child-process pattern bench.py uses)."""

import os
import subprocess
import sys

from stochquant.watchdog import run_watchdogged

_BENCH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench.py"
)


def test_success_first_try():
    res = run_watchdogged(
        ["-c", "print('payload'); import sys; sys.exit(0)"],
        python=True, timeout_s=30, attempts=2, backoff_s=0,
    )
    assert res.ok
    assert res.success.index == 0
    assert "payload" in res.success.stdout


def test_retry_then_give_up_on_failure():
    seen = []
    res = run_watchdogged(
        ["-c", "import sys; sys.exit(3)"],
        python=True, timeout_s=30, attempts=2, backoff_s=0,
        on_attempt=seen.append,
    )
    assert not res.ok
    assert [a.returncode for a in res.attempts] == [3, 3]
    assert len(seen) == 2


def test_timeout_kills_and_records():
    res = run_watchdogged(
        ["-c", "import time; time.sleep(60)"],
        python=True, timeout_s=1.0, attempts=1, backoff_s=0,
    )
    assert not res.ok
    assert res.attempts[0].timed_out
    assert res.attempts[0].elapsed_s < 30


def test_recovers_after_transient_failure(tmp_path):
    marker = tmp_path / "marker"
    code = (
        "import os, sys\n"
        f"p = {str(marker)!r}\n"
        "if os.path.exists(p):\n"
        "    print('second try ok')\n"
        "    sys.exit(0)\n"
        "open(p, 'w').close()\n"
        "sys.exit(1)\n"
    )
    res = run_watchdogged(
        ["-c", code], python=True, timeout_s=30, attempts=3, backoff_s=0
    )
    assert res.ok
    assert res.success.index == 1
    assert "second try ok" in res.success.stdout


def test_retry_starts_after_previous_child_exited(tmp_path):
    """Attempts never overlap: each child has the card to itself."""
    log = tmp_path / "log"
    code = (
        "import os, sys, time\n"
        f"p = {str(log)!r}\n"
        "open(p, 'a').write(f'start {time.time()}\\n')\n"
        "time.sleep(0.3)\n"
        "open(p, 'a').write(f'end {time.time()}\\n')\n"
        "sys.exit(1)\n"
    )
    res = run_watchdogged(
        ["-c", code], python=True, timeout_s=30, attempts=3, backoff_s=0
    )
    assert not res.ok and len(res.attempts) == 3
    events = [line.split() for line in log.read_text().splitlines()]
    assert [e[0] for e in events] == ["start", "end"] * 3
    times = [float(e[1]) for e in events]
    assert times == sorted(times)


def test_bench_exits_nonzero_without_gpu(tmp_path):
    """bench.py finds no card (no nvidia-smi on PATH): it exits nonzero
    before starting a worker and prints no result."""
    env = dict(os.environ, PATH=str(tmp_path))
    out = subprocess.run(
        [sys.executable, _BENCH], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, timeout=120,
    )
    assert out.returncode != 0
    assert out.stdout.strip() == b""
    assert b"no GPU found" in out.stderr
