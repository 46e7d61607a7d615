"""Multi-host execution helpers.

The same shard_map program spans hosts: each process contributes its local
devices to one global mesh; the links within a host carry the intra-host
halo traffic and the network the cross-host edges (SURVEY.md §2.5
"Multi-host").  The reference has no
multi-device story at all (one OpenCL queue, ``tauhost.c:252``).

Usage (one process per host):

    from stochquant.parallel import distributed
    distributed.initialize()                  # jax.distributed handshake
    mesh = distributed.global_mesh([("chain", 2), ("x", n_total // 2)])
    ...

Single-host multi-process testing: run N processes with
``initialize(coordinator, num_processes=N, process_id=i)`` — exercised by
tests/test_multiprocess.py via subprocesses on CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Wrapper over ``jax.distributed.initialize`` (no-op if single-process
    and no coordinator is configured)."""
    if coordinator_address is None and num_processes is None and (
        "JAX_COORDINATOR_ADDRESS" not in os.environ
    ):
        return  # single-process run
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def global_mesh(axes: Sequence[Tuple[str, int]]) -> Mesh:
    """Mesh over *all* processes' devices (jax.devices() is global after
    ``initialize``).  Axis sizes must multiply to the global device count.
    Axes are laid out so the fastest-varying axis maps to devices within a
    host and the slowest spans hosts — put the halo-exchange axis last so
    halos stay within a host."""
    names = [n for n, _ in axes]
    sizes = [s for _, s in axes]
    devs = jax.devices()
    n = int(np.prod(sizes))
    if n != len(devs):
        raise ValueError(
            f"mesh {dict(axes)} needs {n} devices; global count is {len(devs)}"
        )
    return Mesh(np.asarray(devs).reshape(sizes), tuple(names))


def process_local_chains(total_chains: int) -> Tuple[int, int]:
    """(chains on this process, offset of the first) for host-sharded inputs."""
    nproc = jax.process_count()
    pid = jax.process_index()
    per = total_chains // nproc
    if per * nproc != total_chains:
        raise ValueError(f"{total_chains} chains not divisible by {nproc} processes")
    return per, pid * per
