"""Sharded-vs-unsharded equivalence on the 8-device virtual CPU mesh — the
de-facto race detector of the framework (SURVEY.md §5): counter-keyed noise
makes trajectories layout-invariant, so any sharding must reproduce the
single-device run bitwise (field trajectories) / to float tolerance
(cross-shard-reduced observables)."""

import dataclasses

import jax
import numpy as np
import pytest

from stochquant import actions
from stochquant.actions import phi4
from stochquant.config import BoundaryCondition, ChainConfig, FieldConfig, Formulation
from stochquant.integrators import field, langevin
from stochquant.parallel import make_mesh, shard_chain_state, shard_field_state


def test_chain_dp_sharded_bitwise_equal():
    """Chains sharded 8-way: every state leaf bitwise equal to unsharded."""
    cfg = ChainConfig(
        action="double_well",
        n_sites=32,
        dt=0.05,
        dtau=0.001,
        n_chains=16,
        loops=25,
        seed=31,
    )
    act = actions.get(cfg.action)
    s0 = langevin.init_chain_state(cfg, act)
    ref, ref_metrics = langevin.run_frames(s0, act, cfg, 4)

    mesh = make_mesh([("chain", 8)])
    s0_sh = shard_chain_state(s0, mesh)
    out, out_metrics = langevin.run_frames(s0_sh, act, cfg, 4)
    for name, a, b in zip(ref._fields, ref, out):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
    np.testing.assert_array_equal(
        np.asarray(ref_metrics["stable"]), np.asarray(out_metrics["stable"])
    )


@pytest.mark.parametrize(
    "mesh_axes,mesh_shape",
    [
        ((("x", None)), [("x", 8)]),
        ((("x", "y")), [("x", 4), ("y", 2)]),
    ],
)
def test_field_lattice_sharded_matches(mesh_axes, mesh_shape):
    """2-D φ⁴ with the lattice domain-decomposed: φ trajectory bitwise equal
    (stencil + noise are exact under sharding); reduced observables equal to
    float tolerance (sum reassociation)."""
    cfg = FieldConfig(
        action="phi4",
        shape=(16, 16),
        dtau=0.01,
        n_chains=4,
        loops=10,
        seed=13,
    )
    act = phi4.get_field("phi4")
    s0 = field.init_field_state(cfg)
    ref, _ = field.run_field_frames(s0, act, cfg, 3)

    cfg_sh = dataclasses.replace(cfg, mesh_axes=tuple(mesh_axes))
    mesh = make_mesh(mesh_shape)
    s0_sh = shard_field_state(s0, mesh, cfg_sh)
    out, _ = field.run_field_frames(s0_sh, act, cfg, 3)

    np.testing.assert_array_equal(np.asarray(ref.phi), np.asarray(out.phi))
    np.testing.assert_allclose(
        np.asarray(ref.mag_mean), np.asarray(out.mag_mean), rtol=1e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(ref.corr_mean), np.asarray(out.corr_mean), rtol=1e-4, atol=1e-6
    )


def test_field_chain_plus_lattice_sharding():
    """chains × lattice 2-D mesh (2×2×2): the full hybrid layout."""
    cfg = FieldConfig(
        action="free_field",
        shape=(8, 8),
        dtau=0.02,
        n_chains=4,
        loops=10,
        seed=17,
    )
    act = phi4.get_field("free_field")
    s0 = field.init_field_state(cfg)
    ref, _ = field.run_field_frames(s0, act, cfg, 2)

    cfg_sh = dataclasses.replace(cfg, mesh_axes=("x", "y"), mesh_chain_axis="chain")
    mesh = make_mesh([("chain", 2), ("x", 2), ("y", 2)])
    s0_sh = shard_field_state(s0, mesh, cfg_sh)
    out, _ = field.run_field_frames(s0_sh, act, cfg, 2)
    np.testing.assert_array_equal(np.asarray(ref.phi), np.asarray(out.phi))
    np.testing.assert_allclose(
        np.asarray(ref.phi2_mean), np.asarray(out.phi2_mean), rtol=1e-5, atol=1e-7
    )


def test_4d_lattice_sharded():
    """4-D φ⁴ (config 4 shape, tiny) sharded over two lattice dims."""
    cfg = FieldConfig(
        action="phi4",
        shape=(4, 4, 4, 4),
        dtau=0.01,
        n_chains=2,
        loops=5,
        seed=41,
    )
    act = phi4.get_field("phi4")
    s0 = field.init_field_state(cfg)
    ref, _ = field.run_field_frames(s0, act, cfg, 2)

    cfg_sh = dataclasses.replace(cfg, mesh_axes=("x", "y", None, None))
    mesh = make_mesh([("x", 2), ("y", 2)])
    s0_sh = shard_field_state(s0, mesh, cfg_sh)
    out, _ = field.run_field_frames(s0_sh, act, cfg, 2)
    np.testing.assert_array_equal(np.asarray(ref.phi), np.asarray(out.phi))
