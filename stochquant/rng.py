"""Counter-based random numbers for lattice Langevin dynamics.

The reference (``/root/reference/tau_kernel.cl:269-284``) draws noise from a
single *shared* 48-bit LCG seed that every work-item read-modify-writes
non-atomically (design flaw F2 in SURVEY.md): streams collide and the
trajectory depends on hardware scheduling.  Here noise is a pure function of

    ``(seed, stream, chain, global site index, micro-step index)``

via Threefry-2x32 (20 rounds).  Because the counter encodes *global* site
coordinates, the generated field is bit-identical no matter how the lattice
is sharded across devices — the lynchpin of the sharded-vs-unsharded bitwise
tests (SURVEY.md §4) — and the exact same integer program runs unchanged
inside the CUDA chain kernel (cuda/chain_math.h, uint32 ops only).

Key/counter layout (one Threefry call yields two uint32 → one Box–Muller
normal per site per step):

    k0 = seed
    k1 = stream ^ (chain_index << 8)
    c0 = global site linear index
    c1 = micro-step index
"""

from __future__ import annotations

import enum

import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = [
    "Stream",
    "threefry2x32",
    "uniform_from_bits",
    "normal",
    "normal_pair",
]


class Stream(enum.IntEnum):
    """Independent noise streams (folded into the Threefry key)."""

    FIELD = 0        # per-site Langevin noise
    COLLECTIVE = 1   # collective-coordinate (zero-mode / omega) noise
    INIT = 2         # cold-start field initialisation
    COMPLEX = 3      # imaginary-part noise (complex Langevin, if enabled)


_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = np.uint32(0x1BD11BDA)

#: Round counts: 20 is Random123's default (large safety margin); 13 is the
#: library's documented minimum that still passes the full BigCrush battery
#: (Salmon et al., SC'11, Table 2) — ~35% fewer key-schedule ops on the
#: noise-generation critical path.  Selected per run via
#: ``rng_impl='threefry13'`` (still counter-based and layout-invariant; a
#: *different* stream than the 20-round default).
_DEFAULT_ROUNDS = 20


def rounds_of(rng_impl: str) -> int:
    """Threefry round count for a config's ``rng_impl`` string."""
    return 13 if rng_impl == "threefry13" else _DEFAULT_ROUNDS


def _rotl(x, r):
    return lax.shift_left(x, jnp.uint32(r)) | lax.shift_right_logical(
        x, jnp.uint32(32 - r)
    )


def threefry2x32(k0, k1, c0, c1, rounds: int = _DEFAULT_ROUNDS):
    """Threefry-2x32.  All args uint32 arrays (broadcastable).

    Returns two uint32 arrays of the broadcast shape.  At the default 20
    rounds this matches the Random123 known-answer vectors
    (tests/test_rng.py); ``rounds=13`` is the Threefry-2x32-13 reduced-round
    variant (same mix/injection schedule, stopped after 13 rounds — the
    final partial 4-round group gets no key injection, as in Random123).
    """
    k0 = jnp.asarray(k0, jnp.uint32)
    k1 = jnp.asarray(k1, jnp.uint32)
    ks = (k0, k1, _PARITY ^ k0 ^ k1)
    x0 = jnp.asarray(c0, jnp.uint32) + ks[0]
    x1 = jnp.asarray(c1, jnp.uint32) + ks[1]
    for i in range(rounds):
        x0 = x0 + x1
        x1 = _rotl(x1, _ROTATIONS[i % 8])
        x1 = x1 ^ x0
        if (i + 1) % 4 == 0:
            j = (i + 1) // 4
            x0 = x0 + ks[j % 3]
            x1 = x1 + ks[(j + 1) % 3] + jnp.uint32(j)
    return x0, x1


def uniform_from_bits(bits):
    """uint32 → float32 uniform in the open interval (0, 1).

    Uses the top 24 bits (exactly representable in float32) plus a half-ulp
    offset so the result is never 0 (safe under ``log``) and never 1.
    """
    top = lax.shift_right_logical(jnp.asarray(bits, jnp.uint32), jnp.uint32(8))
    # route through int32 (exact: top < 2^24)
    top_f = top.astype(jnp.int32).astype(jnp.float32)
    return top_f * jnp.float32(2.0**-24) + jnp.float32(2.0**-25)


_TWO_PI = 6.283185307179586


def normal_pair(k0, k1, c0, c1, rounds: int = _DEFAULT_ROUNDS):
    """Two independent N(0,1) float32 draws per counter (full Box–Muller)."""
    b0, b1 = threefry2x32(k0, k1, c0, c1, rounds)
    u1 = uniform_from_bits(b0)
    u2 = uniform_from_bits(b1)
    r = jnp.sqrt(jnp.float32(-2.0) * jnp.log(u1))
    theta = jnp.float32(_TWO_PI) * u2
    return r * jnp.cos(theta), r * jnp.sin(theta)


def normal(seed, stream, chain, site, step, rounds: int = _DEFAULT_ROUNDS):
    """One N(0,1) float32 per (chain, site) element.

    Args:
      seed: python int or uint32 scalar — experiment seed.
      stream: a :class:`Stream` member (or uint32 scalar).
      chain: uint32 array of global chain indices, broadcastable vs ``site``.
      site: uint32 array of *global* site linear indices.
      step: uint32 scalar (or array) — global micro-step counter.

    The output is a deterministic pure function of global coordinates, hence
    identical under any sharding of the chain/site axes.
    """
    k0 = jnp.uint32(seed)
    k1 = jnp.uint32(stream) ^ lax.shift_left(
        jnp.asarray(chain, jnp.uint32), jnp.uint32(8)
    )
    z0, _ = normal_pair(
        k0, k1, jnp.asarray(site, jnp.uint32), jnp.asarray(step, jnp.uint32),
        rounds,
    )
    return z0


def global_site_index(local_shape, global_shape, offsets=None):
    """uint32 array of shape ``local_shape`` holding *global* linear site ids.

    ``local_shape`` is the shard-local lattice block, ``global_shape`` the full
    lattice, ``offsets`` the block's origin in global coordinates (defaults to
    all-zero, i.e. unsharded).  Linearisation is C order over ``global_shape``,
    so a shard holding a strided sub-block still produces exactly its slice of
    the global id field — this is what makes noise sharding-invariant.
    """
    if offsets is None:
        offsets = (0,) * len(local_shape)
    ids = jnp.zeros(local_shape, jnp.uint32)
    stride = 1
    strides = []
    for d in reversed(global_shape):
        strides.append(stride)
        stride *= d
    strides = list(reversed(strides))
    for axis, (n, off, s) in enumerate(zip(local_shape, offsets, strides)):
        coord = lax.broadcasted_iota(jnp.uint32, local_shape, axis) + jnp.uint32(off)
        ids = ids + coord * jnp.uint32(s)
    return ids


def _ids_for_shape(shape, global_lattice_shape, chain_offset, lattice_offsets):
    chains = shape[0]
    local_lattice = shape[1:]
    if global_lattice_shape is None:
        global_lattice_shape = local_lattice
    site_ids = global_site_index(local_lattice, global_lattice_shape, lattice_offsets)
    site_ids = jnp.broadcast_to(site_ids[None], (chains,) + local_lattice)
    chain_shape = (chains,) + (1,) * len(local_lattice)
    chain_ids = (
        lax.broadcasted_iota(jnp.uint32, chain_shape, 0) + jnp.uint32(chain_offset)
    )
    chain_ids = jnp.broadcast_to(chain_ids, site_ids.shape)
    return chain_ids, site_ids


def normal_for_shape(
    seed,
    stream,
    step,
    shape,
    global_lattice_shape=None,
    chain_offset=0,
    lattice_offsets=None,
    rounds: int = _DEFAULT_ROUNDS,
):
    """N(0,1) field of ``shape = (chains, *lattice)`` from global coordinates.

    For sharded execution pass the full ``global_lattice_shape`` plus this
    shard's ``chain_offset`` / per-dimension ``lattice_offsets``; every shard
    then generates exactly its slice of the one global noise field.
    """
    chain_ids, site_ids = _ids_for_shape(
        shape, global_lattice_shape, chain_offset, lattice_offsets
    )
    return normal(seed, stream, chain_ids, site_ids, step, rounds)


def normal_pair_for_shape(
    seed,
    stream,
    step,
    shape,
    global_lattice_shape=None,
    chain_offset=0,
    lattice_offsets=None,
    rounds: int = _DEFAULT_ROUNDS,
):
    """Both Box–Muller outputs per counter (site, ``step``): the noise fields
    for micro-steps ``step`` and ``step+1`` from ONE Threefry evaluation —
    half the RNG/transcendental cost of two ``normal_for_shape`` calls.
    Layout-invariant for the same reason as ``normal_for_shape``.
    """
    chain_ids, site_ids = _ids_for_shape(
        shape, global_lattice_shape, chain_offset, lattice_offsets
    )
    k0 = jnp.uint32(seed)
    k1 = jnp.uint32(stream) ^ lax.shift_left(chain_ids, jnp.uint32(8))
    return normal_pair(k0, k1, site_ids, jnp.asarray(step, jnp.uint32), rounds)
