"""Config serialization and preset sanity."""

import dataclasses

import pytest

from stochquant import actions
from stochquant.config import (
    PRESETS,
    BoundaryCondition,
    ChainConfig,
    FieldConfig,
    Formulation,
    Scheme,
    Sweep,
)


def test_chain_config_json_roundtrip():
    cfg = ChainConfig(
        action="double_well",
        n_sites=48,
        dt=0.125,
        dtau=3e-4,
        scheme=Scheme.HEUN,
        bc=BoundaryCondition.PERIODIC,
        formulation=Formulation.DIRECT,
        ghost_override=(-0.8, 0.8),
        accumulate_spectrum=True,
        dtau_max=0.1,
    )
    back = ChainConfig.from_json(cfg.to_json())
    assert back == cfg
    assert isinstance(back.scheme, Scheme)
    assert isinstance(back.bc, BoundaryCondition)


def test_field_config_json_roundtrip():
    cfg = FieldConfig(
        action="phi4",
        shape=(8, 8, 8),
        sweep=Sweep.CHECKERBOARD,
        mesh_axes=("x", None, "y"),
        mesh_chain_axis="chain",
    )
    back = FieldConfig.from_json(cfg.to_json())
    assert back == cfg
    assert isinstance(back.sweep, Sweep)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_presets_resolve_actions(name):
    cfg = PRESETS[name]
    if isinstance(cfg, ChainConfig):
        act = actions.get(cfg.action)
        assert act is not None
        # reference preset workload scales (taumain.py:91-128)
        if name == "double_well":
            assert (cfg.n_sites, cfg.dt, cfg.dtau) == (200, 0.02, 0.002)
        if name == "harmosc":
            assert (cfg.n_sites, cfg.dt, cfg.dtau) == (100, 0.1, 0.3)
    else:
        assert actions.get_field(cfg.action) is not None


def test_configs_hashable_for_jit_static_args():
    for cfg in PRESETS.values():
        hash(cfg)
