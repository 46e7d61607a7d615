"""Multi-process single-host test (SURVEY.md §4): two jax.distributed CPU
processes form one global mesh; the chain ensemble sharded across them must
reproduce the single-process run bitwise."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]; outdir = sys.argv[4]
jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=nproc, process_id=pid)
assert jax.device_count() == 2 * nproc, jax.devices()

import numpy as np
from stochquant import actions
from stochquant.config import ChainConfig
from stochquant.integrators import langevin
from stochquant.parallel import distributed, make_mesh
from jax.sharding import NamedSharding, PartitionSpec as P

cfg = ChainConfig(action="double_well", n_sites=16, dt=0.1, dtau=5e-4,
                  n_chains=8, loops=10, seed=77)
act = actions.get(cfg.action)
mesh = distributed.global_mesh([("chain", 2 * nproc)])

# build the full initial state on every process (deterministic), then place
# it on the global mesh via host-local shards
state = langevin.init_chain_state(cfg, act)
def place(path_leaf_spec):
    leaf, spec = path_leaf_spec
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(sharding, np.asarray(leaf))
from stochquant.parallel.mesh import chain_state_sharding
specs = langevin.ChainState(
    f=P("chain"), omega=P("chain"), x_mean=P("chain"), xx0_mean=P("chain"),
    x2_mean=P("chain"), x4_mean=P("chain"), runs=P("chain"), dtau=P("chain"),
    stab_cnt=P("chain"), lrg_vl=P("chain"), spec_mean=P("chain"), step=P(),
)
# make_array_from_process_local_data takes each process's OWN shard of the
# chain axis
per, off = distributed.process_local_chains(cfg.n_chains)
import jax.tree as jt
def place(leaf, spec):
    arr = np.asarray(leaf)
    if spec == P("chain"):
        arr = arr[off : off + per]
    return jax.make_array_from_process_local_data(NamedSharding(mesh, spec), arr)
global_state = jt.map(place, state, specs)

out, metrics = langevin.run_frames(global_state, act, cfg, 3)
local = jax.tree.map(
    lambda x: np.concatenate([np.asarray(s.data) for s in x.addressable_shards])
    if x.ndim else np.asarray(x), out)
np.savez(os.path.join(outdir, f"proc{pid}.npz"),
         **{name: leaf for name, leaf in zip(out._fields, local)})
print("WORKER_OK", pid)
"""


@pytest.mark.slow
def test_two_process_chain_dp_matches_single(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), "2", str(port), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for pid, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{pid} failed:\n{o[-3000:]}"
        assert f"WORKER_OK {pid}" in o

    # single-process reference
    from stochquant import actions
    from stochquant.config import ChainConfig
    from stochquant.integrators import langevin

    cfg = ChainConfig(action="double_well", n_sites=16, dt=0.1, dtau=5e-4,
                      n_chains=8, loops=10, seed=77)
    act = actions.get(cfg.action)
    ref, _ = langevin.run_frames(langevin.init_chain_state(cfg, act), act, cfg, 3)

    d0 = np.load(tmp_path / "proc0.npz")
    d1 = np.load(tmp_path / "proc1.npz")
    # each process saved its addressable half of the chain axis
    for name in ["f", "omega", "x_mean", "xx0_mean", "x2_mean", "runs", "dtau"]:
        got = np.concatenate([d0[name], d1[name]])
        np.testing.assert_array_equal(got, np.asarray(getattr(ref, name)), err_msg=name)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_RESUME_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
outdir = sys.argv[4]; phase = sys.argv[5]
jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=nproc, process_id=pid)

import numpy as np
import jax.tree as jt
from jax.sharding import NamedSharding, PartitionSpec as P
from stochquant import actions
from stochquant.config import ChainConfig
from stochquant.integrators import langevin
from stochquant.io import checkpoint as ckpt
from stochquant.parallel import distributed

cfg = ChainConfig(action="double_well", n_sites=16, dt=0.1, dtau=5e-4,
                  n_chains=8, loops=10, seed=77)
act = actions.get(cfg.action)
mesh = distributed.global_mesh([("chain", 2 * nproc)])
ckpath = os.path.join(outdir, "shard_ck")

if phase == "first":
    state = langevin.init_chain_state(cfg, act)
    specs = langevin.ChainState(
        f=P("chain"), omega=P("chain"), x_mean=P("chain"), xx0_mean=P("chain"),
        x2_mean=P("chain"), x4_mean=P("chain"), runs=P("chain"), dtau=P("chain"),
        stab_cnt=P("chain"), lrg_vl=P("chain"), spec_mean=P("chain"), step=P())
    per, off = distributed.process_local_chains(cfg.n_chains)
    def place(leaf, spec):
        arr = np.asarray(leaf)
        if spec == P("chain"):
            arr = arr[off : off + per]
        return jax.make_array_from_process_local_data(
            NamedSharding(mesh, spec), arr)
    gs = jt.map(place, state, specs)
    out, _ = langevin.run_frames(gs, act, cfg, 2)
    # each process writes ONLY its addressable shards (no gather)
    ckpt.save_sharded(ckpath, out, cfg, frames_done=2)
else:
    state, lcfg = ckpt.load_sharded(ckpath, mesh)
    assert lcfg.n_chains == cfg.n_chains
    out, _ = langevin.run_frames(state, act, cfg, 1)
    local = jax.tree.map(
        lambda x: np.concatenate([np.asarray(s.data) for s in x.addressable_shards])
        if x.ndim else np.asarray(x), out)
    np.savez(os.path.join(outdir, f"resume{pid}.npz"),
             **{n: l for n, l in zip(out._fields, local)})
print("WORKER_OK", pid, phase)
"""


@pytest.mark.slow
def test_two_process_sharded_checkpoint_kill_resume(tmp_path):
    """save → processes exit → NEW processes load_sharded and continue: the
    continuation must equal the uninterrupted single-process run bitwise
    (SURVEY.md §5 sharded save/restore; VERDICT r1 item 4)."""
    script = tmp_path / "worker.py"
    script.write_text(_RESUME_WORKER)
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")

    for phase in ("first", "resume"):
        port = _free_port()
        procs = [
            subprocess.Popen(
                [sys.executable, str(script), str(pid), "2", str(port),
                 str(tmp_path), phase],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
            for pid in range(2)
        ]
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
        for pid, (p, o) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"{phase} proc{pid} failed:\n{o[-3000:]}"
            assert f"WORKER_OK {pid} {phase}" in o
    # both processes wrote their own shard file in phase one
    assert (tmp_path / "shard_ck.proc0-of-2.npz").exists()
    assert (tmp_path / "shard_ck.proc1-of-2.npz").exists()

    from stochquant import actions
    from stochquant.config import ChainConfig
    from stochquant.integrators import langevin

    cfg = ChainConfig(action="double_well", n_sites=16, dt=0.1, dtau=5e-4,
                      n_chains=8, loops=10, seed=77)
    act = actions.get(cfg.action)
    ref, _ = langevin.run_frames(langevin.init_chain_state(cfg, act), act, cfg, 3)

    d0 = np.load(tmp_path / "resume0.npz")
    d1 = np.load(tmp_path / "resume1.npz")
    for name in ["f", "omega", "x_mean", "xx0_mean", "x2_mean", "runs", "dtau"]:
        got = np.concatenate([d0[name], d1[name]])
        np.testing.assert_array_equal(got, np.asarray(getattr(ref, name)), err_msg=name)
