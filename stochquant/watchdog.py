"""Run a command in a child process under a wall-clock watchdog.

A process that initialises a JAX backend on a GPU reserves most of the
card's memory, so measurement work that needs the card runs in a child
process while the parent stays off JAX; a child that hangs or crashes is
killed or reaped, and the next attempt starts only after it has exited.
``bench.py`` runs its worker this way.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import time
from typing import Callable, Optional, Sequence

__all__ = ["Attempt", "WatchdogResult", "run_watchdogged"]


@dataclasses.dataclass
class Attempt:
    """One child-process attempt."""

    index: int
    returncode: Optional[int]  # None = killed by the watchdog timeout
    elapsed_s: float
    stdout: str
    stderr: str

    @property
    def timed_out(self) -> bool:
        return self.returncode is None

    @property
    def ok(self) -> bool:
        return self.returncode == 0


@dataclasses.dataclass
class WatchdogResult:
    """Outcome of :func:`run_watchdogged`: the attempt log plus the first
    successful attempt (or None if every attempt failed)."""

    attempts: list
    success: Optional[Attempt]

    @property
    def ok(self) -> bool:
        return self.success is not None


def run_watchdogged(
    argv: Sequence[str],
    *,
    timeout_s: float = 1500.0,
    attempts: int = 3,
    backoff_s: float = 90.0,
    python: bool = False,
    on_attempt: Optional[Callable[[Attempt], None]] = None,
) -> WatchdogResult:
    """Run ``argv`` in a child process under a wall-clock watchdog, retrying
    on timeout or non-zero exit.

    argv: the command; with ``python=True`` it is prefixed with
      ``sys.executable`` (the common "re-run this script as a worker" case).
    timeout_s: watchdog per attempt — on expiry the child is killed
      (``subprocess.run``'s timeout kills the direct child; workers must not
      daemonize grandchildren).
    attempts: total tries before giving up.
    backoff_s: sleep between attempts.
    on_attempt: optional callback invoked with each finished
      :class:`Attempt` (e.g. for logging).

    Returns a :class:`WatchdogResult`; ``result.success.stdout`` carries the
    worker's output on success.  Never raises on worker failure — inspect
    ``result.ok``.
    """
    cmd = ([sys.executable] if python else []) + list(argv)
    log: list = []
    for i in range(attempts):
        t0 = time.perf_counter()
        try:
            out = subprocess.run(
                cmd,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                timeout=timeout_s,
            )
            att = Attempt(
                index=i,
                returncode=out.returncode,
                elapsed_s=time.perf_counter() - t0,
                stdout=out.stdout.decode(errors="replace"),
                stderr=out.stderr.decode(errors="replace"),
            )
        except subprocess.TimeoutExpired as e:
            att = Attempt(
                index=i,
                returncode=None,
                elapsed_s=time.perf_counter() - t0,
                stdout=(e.stdout or b"").decode(errors="replace"),
                stderr=(e.stderr or b"").decode(errors="replace"),
            )
        log.append(att)
        if on_attempt is not None:
            on_attempt(att)
        if att.ok:
            return WatchdogResult(attempts=log, success=att)
        if i + 1 < attempts:
            time.sleep(backoff_s)
    return WatchdogResult(attempts=log, success=None)
