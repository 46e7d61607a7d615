"""Parallelism: mesh construction, sharded state placement (GSPMD), explicit
shard_map halo exchange, and multi-host initialization."""

from stochquant.parallel.mesh import (  # noqa: F401
    chain_state_sharding,
    field_state_sharding,
    make_mesh,
    shard_chain_state,
    shard_field_state,
)
from stochquant.parallel.gauge_halo import (  # noqa: F401
    gauge_state_sharding,
    shard_gauge_state,
)
