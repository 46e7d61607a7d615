"""Gauge observables beyond the plaquette: Wilson loops, Polyakov loops,
and the Wilson gradient flow (smearing).

The reference measures only a two-point correlator of its 1-D QM field
(``tau_kernel.cl:144-145``); these are the standard gauge-sector analogs for
the gauge model family.  All three gauge groups (u1/su2/su3) share one
implementation through a tiny per-group algebra adapter (multiplication,
inverse, normalized real trace) over the per-direction link fields — loops
are measurement-time code, so plain ``jnp.roll`` composition is the right
tool (the hot path stays in the integrators/kernels).

Observables:

* ``wilson_loop(action, links, mu, nu, R, T)`` — ⟨(1/N)ReTr W_{R×T}⟩ per
  chain, averaged over lattice translations.  In 2-D the exact value is
  w₁(β)^{R·T} with w₁ the one-plaquette mean — the test gate.
* ``polyakov_loop(action, links, axis)`` — the complex trace of the
  straight winding line, averaged over the transverse volume; the
  deconfinement order parameter.
* ``wilson_flow(action, links, ndim, eps, steps)`` — integrates the gradient
  flow dU/dt = Z(U)·U with Z the (β-independent) Wilson-action drift, using
  Lüscher's 3-stage Runge–Kutta (Commun.Math.Phys. 293 (2010) 899, §C);
  strictly decreases the action and drives ⟨plaquette⟩ → 1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from stochquant.actions import gauge as ga

__all__ = [
    "wilson_loop",
    "wilson_loop_table",
    "polyakov_loop",
    "wilson_flow",
    "creutz_ratio",
]


class _Algebra:
    """Per-group view of a link state as D per-direction fields with a
    product, inverse, lattice shift, and normalized real trace."""

    def select(self, links, mu):
        raise NotImplementedError

    def mul(self, a, b):
        raise NotImplementedError

    def inv(self, a):
        raise NotImplementedError

    def shift(self, a, d, n):
        """a(x + n·d̂); lattice axes start at 1 on per-direction fields."""
        raise NotImplementedError

    def trace_over_n(self, a):
        """(1/N)·(ReTr, ImTr) as a pair of real (C, *L) arrays."""
        raise NotImplementedError


class _U1(_Algebra):
    # multiplicative group e^{iθ} carried additively in the angle
    def select(self, links, mu):
        return links[:, mu]

    def mul(self, a, b):
        return a + b

    def inv(self, a):
        return -a

    def shift(self, a, d, n):
        return jnp.roll(a, -n, axis=1 + d)

    def trace_over_n(self, a):
        return jnp.cos(a), jnp.sin(a)


class _SU2(_Algebra):
    # quaternion tuples (w, x, y, z); links layout (C, 4, D, *L)
    def select(self, links, mu):
        return tuple(links[:, c, mu] for c in range(4))

    def mul(self, a, b):
        return ga.qmul(a, b)

    def inv(self, a):
        return ga.qconj(a)

    def shift(self, a, d, n):
        return tuple(jnp.roll(c, -n, axis=1 + d) for c in a)

    def trace_over_n(self, a):
        # (1/2)Tr(w + i x⃗·σ) = w; SU(2) traces are real
        return a[0], jnp.zeros_like(a[0])


class _SU3(_Algebra):
    # complex 3×3 matrices on trailing axes; links layout (C, D, *L, 3, 3)
    def select(self, links, mu):
        return links[:, mu]

    def mul(self, a, b):
        return ga.mmul(a, b)

    def inv(self, a):
        return ga.dag(a)

    def shift(self, a, d, n):
        return jnp.roll(a, -n, axis=1 + d)

    def trace_over_n(self, a):
        t = jnp.trace(a, axis1=-2, axis2=-1) / 3.0
        return jnp.real(t), jnp.imag(t)


class _CU1(_U1):
    # complexified U(1): θ ∈ ℂ carried additively; the loop trace is the
    # holomorphic e^{iθ} (valid complex-Langevin observable)
    def trace_over_n(self, a):
        w = jnp.exp(1j * a)
        return jnp.real(w), jnp.imag(w)


class _CSUN(_SU3):
    # SL(N,ℂ) matrix links: same layout as SU(3) but daggers → inverses
    # (the holomorphic continuation of the loop observables)
    def __init__(self, n: int):
        self.n = n

    def inv(self, a):
        from stochquant.actions.gauge_complex import inv22, inv33

        return inv22(a) if self.n == 2 else inv33(a)

    def trace_over_n(self, a):
        t = jnp.trace(a, axis1=-2, axis2=-1) / self.n
        return jnp.real(t), jnp.imag(t)


def _algebra(action: ga.GaugeAction) -> _Algebra:
    from stochquant.actions.gauge_complex import ComplexSUNWilson, ComplexU1Wilson

    if isinstance(action, ComplexU1Wilson):
        return _CU1()
    if isinstance(action, ComplexSUNWilson):
        return _CSUN(action.N)
    if isinstance(action, ga.U1Wilson):
        return _U1()
    if isinstance(action, ga.SU2Wilson):
        return _SU2()
    if isinstance(action, ga.SU3Wilson):
        return _SU3()
    raise TypeError(f"no loop algebra for {type(action).__name__}")


def _line(alg: _Algebra, u_mu, mu: int, length: int):
    """Π_{k=0}^{length−1} U_μ(x + k·μ̂) — the straight Wilson line starting
    at every x simultaneously (log-depth doubling: O(log R) products)."""
    assert length >= 1
    prod = u_mu  # line of length 1
    done = 1
    while done < length:
        step = min(done, length - done)
        # append a (possibly shorter) shifted copy of the existing line's
        # first `step` links: line(x, done+step) = line(x, done)·line(x+done·μ̂, step)
        tail = prod if step == done else _line(alg, u_mu, mu, step)
        prod = alg.mul(prod, alg.shift(tail, mu, done))
        done += step
    return prod


def wilson_loop(action, links, mu: int, nu: int, R: int, T: int):
    """⟨(1/N)ReTr W_{R×T}(μ,ν)⟩ per chain: planar R×T rectangle, averaged
    over all lattice positions.  Shape (C,)."""
    alg = _algebra(action)
    u_mu = alg.select(links, mu)
    u_nu = alg.select(links, nu)
    bottom = _line(alg, u_mu, mu, R)                      # x → x+Rμ̂
    right = alg.shift(_line(alg, u_nu, nu, T), mu, R)     # x+Rμ̂ → x+Rμ̂+Tν̂
    top = alg.inv(alg.shift(bottom, nu, T))               # x+Rμ̂+Tν̂ → x+Tν̂
    left = alg.inv(_line(alg, u_nu, nu, T))               # x+Tν̂ → x
    w = alg.mul(alg.mul(bottom, right), alg.mul(top, left))
    re, _ = alg.trace_over_n(w)
    return jnp.mean(re, axis=tuple(range(1, re.ndim)))


def wilson_loop_table(action, links, mu: int, nu: int, rmax: int, tmax: int):
    """W(R,T) for all 1 ≤ R ≤ rmax, 1 ≤ T ≤ tmax; shape (C, rmax, tmax).
    The static potential is V(R) = −∂_T log W(R,T); see creutz_ratio."""
    cols = []
    for r in range(1, rmax + 1):
        cols.append(
            jnp.stack(
                [wilson_loop(action, links, mu, nu, r, t) for t in range(1, tmax + 1)],
                axis=-1,
            )
        )
    return jnp.stack(cols, axis=-2)


def creutz_ratio(w_table, r: int, t: int):
    """χ(r,t) = −log[ W(r,t)·W(r−1,t−1) / (W(r,t−1)·W(r−1,t)) ] — the lattice
    string-tension estimator.  ``w_table`` is ``wilson_loop_table`` output
    (1-indexed in R/T); r, t ≥ 2."""
    w = w_table
    i, j = r - 1, t - 1
    return -jnp.log(
        (w[..., i, j] * w[..., i - 1, j - 1])
        / (w[..., i, j - 1] * w[..., i - 1, j])
    )


def polyakov_loop(action, links, axis: int):
    """Trace of the straight winding line along lattice ``axis``, averaged
    over the transverse volume.  Returns the complex (C,) ⟨(1/N)Tr P⟩."""
    alg = _algebra(action)
    u = alg.select(links, axis)
    # full winding: length = lattice extent along `axis`
    ref = u[0] if isinstance(u, tuple) else u
    extent = ref.shape[1 + axis]
    line = _line(alg, u, axis, extent)
    re, im = alg.trace_over_n(line)
    red = tuple(range(1, re.ndim))
    return jax.lax.complex(jnp.mean(re, axis=red), jnp.mean(im, axis=red))


def wilson_flow(action, links, ndim: int, eps: float, steps: int):
    """Integrate the Wilson gradient flow for ``steps`` steps of size
    ``eps`` in flow time, with Lüscher's 3-stage RK (W0/W1/W2 scheme):

        Z_i = ε·Z(W_i);  W₁ = e^{(1/4)Z₀}W₀;
        W₂ = e^{(8/9)Z₁ − (17/36)Z₀}W₁;  W₃ = e^{(3/4)Z₂ − (8/9)Z₁ + (17/36)Z₀}W₂

    Z(U) is the flow drift — the Wilson-action Langevin drift at β_flow = N
    (the conventional flow normalization dU/dt = −g₀²·∂S; any constant only
    rescales flow time, so we reuse ``action.drift`` and scale out β).
    Returns the flowed links (same layout as the input state)."""
    scale = action.N if hasattr(action, "N") else (2 if isinstance(action, ga.SU2Wilson) else 1)
    # drift carries a factor β; normalize to β_flow = N (u1: N = 1)
    znorm = float(scale) / float(action.beta)

    def z(u):
        f = action.drift(u, ndim)
        return jnp.asarray(eps * znorm, f.dtype) * f

    w = links
    for _ in range(steps):
        z0 = z(w)
        w = action.apply_update(w, 0.25 * z0)
        z1 = z(w)
        w = action.apply_update(w, (8.0 / 9.0) * z1 - (17.0 / 36.0) * z0)
        z2 = z(w)
        w = action.apply_update(w, 0.75 * z2 - (8.0 / 9.0) * z1 + (17.0 / 36.0) * z0)
    return w
