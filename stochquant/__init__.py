"""stochquant — a stochastic-quantization (Parisi–Wu Langevin) framework in
JAX.

Built from scratch against the capabilities of the OpenCL reference
``SebTanz/StochQuant`` (see SURVEY.md): lattice Langevin simulation of
Euclidean path integrals — 1-D quantum mechanics (harmonic, anharmonic,
double-well with instanton background + collective coordinate) and D-dim
scalar φ⁴ field theory — with device-side observables, adaptive step-size
control, full-state checkpointing, batched-chain data parallelism and
shard_map lattice domain decomposition with halo exchange.

Compute path: JAX/XLA, with a CUDA frame kernel (kernels/chain_cuda.py) for
the 1-D chain ensemble on NVIDIA GPUs.  Native helpers (the CUDA kernel,
the reference-format codec, the exact-reference oracle) are built from
``stochquant/cuda`` and ``stochquant/cc`` by ``stochquant/native.py``.
"""

from stochquant import rng  # noqa: F401
from stochquant.config import (  # noqa: F401
    BoundaryCondition,
    ChainConfig,
    FieldConfig,
    Formulation,
    PRESETS,
    Scheme,
    Sweep,
)

__version__ = "0.1.0"
