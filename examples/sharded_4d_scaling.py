"""Config 4's scaling story end-to-end on a VIRTUAL mesh (no pod needed).

Runs the 4-D φ⁴ lattice through the shard_map halo runner
(parallel/halo.py) under the decompositions a multi-device run uses:

  1. dim-0 slab ring,
  2. dims-0+1 2-D decomposition,
  3. chain-DP × lattice hybrid,

and checks each against the unsharded integrator BITWISE — the
global-counter noise makes every placement produce the identical
trajectory, so scaling out is a pure layout decision.

Run (CPU, 8 virtual devices):

  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/sharded_4d_scaling.py

On a machine with 8 GPUs the same code runs on the cards; XLA hands the
ring ``ppermute``s to NCCL.
"""

import dataclasses
import os

import numpy as np

import jax

if "host_platform_device_count" in os.environ.get("XLA_FLAGS", ""):
    # virtual-device run requested: pin the CPU backend before any jax init
    jax.config.update("jax_platforms", "cpu")
if len(jax.devices()) < 8:
    raise SystemExit(
        "run with XLA_FLAGS=--xla_force_host_platform_device_count=8 "
        "(or on a machine with >= 8 devices)"
    )

from stochquant.actions import phi4
from stochquant.config import FieldConfig
from stochquant.integrators import field
from stochquant.parallel import make_mesh, shard_field_state
from stochquant.parallel.halo import make_halo_runner

base = FieldConfig(
    action="phi4", shape=(16, 8, 4, 32), dtau=0.005, n_chains=2, loops=8,
    seed=42, grow_after=10**9,
)
act = phi4.get_field(base.action)
s0 = field.init_field_state(base)
ref, _ = field.run_field_frames(s0, act, base, 2)
print(f"unsharded reference: <phi^2> = {np.asarray(ref.phi2_mean).mean():.6f}")

geometries = [
    ("dim-0 slab ring (8-way)", ("x", None, None, None), [("x", 8)], None),
    ("dims 0+1 (2x4)", ("x", "y", None, None), [("x", 2), ("y", 4)], None),
    ("chains x dims 0+1", ("x", "y", None, None),
     [("chain", 2), ("x", 2), ("y", 2)], "chain"),
]
for name, axes, mesh_shape, chain_ax in geometries:
    cfg = dataclasses.replace(
        base, mesh_axes=axes, mesh_chain_axis=chain_ax
    )
    mesh = make_mesh(mesh_shape)
    runner = make_halo_runner(act, cfg, mesh)
    out, metrics = runner(shard_field_state(s0, mesh, cfg), 2)
    bitwise = np.array_equal(np.asarray(ref.phi), np.asarray(out.phi))
    print(f"{name:28s} devices={mesh.devices.size}  "
          f"bitwise={'YES' if bitwise else 'NO'}  "
          f"stable={float(np.asarray(metrics['stable']).mean()):.2f}")
    assert bitwise
print("every placement reproduced the identical trajectory.")
