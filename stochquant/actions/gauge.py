"""Lattice gauge theory building blocks: link variables + Wilson plaquette
actions for U(1), SU(2) and SU(3), with hand-derived Langevin drifts.

Stochastic quantization of gauge fields is the original Parisi–Wu program
(the reference implements only its 1-D QM corner); this module is the
model-family extension.  Layouts are chosen for elementwise device math:

* U(1) links are stored as compact angles θ_μ(x) — shape ``(C, D, *L)``
  (chains, direction, lattice) — so the update is pure elementwise math on
  one big array and the drift is a sum of `jnp.roll` stencils.
* SU(2) links are stored as real quaternions q = (w, x, y, z) representing
  U = w·1 + i(x σ₁ + y σ₂ + z σ₃), shape ``(C, 4, D, *L)`` — no complex
  2×2 matrices: multiplication/conjugation/exponentials are a handful of
  fused multiply-adds, and re-unitarization is one rsqrt.
* SU(3) links are complex 3×3 matrices on the two trailing axes, shape
  ``(C, D, *L, 3, 3)`` — batched tiny matmuls the compiler vectorizes; the
  group exponential is the exact Cayley–Hamilton closed form
  (:func:`expi_su3`) and re-unitarization one Newton step
  (:func:`project_su3`).

Wilson action (both groups, each unordered plaquette counted once):

    S[U] = β Σ_x Σ_{μ<ν} ( 1 − (1/N) Re Tr U_{μν}(x) ),
    U_{μν}(x) = U_μ(x) U_ν(x+μ̂) U_μ†(x+ν̂) U_ν†(x).

Exact known answers used by the tests (2-D, character expansion):
⟨(1/N)ReTr U_p⟩ = I₁(β)/I₀(β) for U(1) and I₂(β)/I₁(β) for SU(2).

Langevin drifts (generators T_a = σ_a/2, noise ⟨η_aη_b⟩ = 2δ_ab):

* U(1): F_μ(x) = −∂S/∂θ_μ(x) = −β Σ_{ν≠μ} [sin P_{μν}(x) − sin P_{μν}(x−ν̂)]
  with P antisymmetric in (μ,ν); verified against ``jax.grad`` of the action
  (tests/test_gauge.py).
* SU(2): f_a = −D_a S = −(β/2)·vec_a(U·V) where V is the staple sum and
  vec the quaternion imaginary part; the update is the exact group
  exponential U ← exp(i ω⃗·σ/2) U via Rodrigues' formula.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Callable

import jax
import jax.numpy as jnp
import numpy as np

_GAUGE_REGISTRY: Dict[str, Callable[..., "GaugeAction"]] = {}


def register_gauge(name: str):
    def wrap(cls):
        _GAUGE_REGISTRY[name] = cls
        cls.name = name
        return cls

    return wrap


def get_gauge(name: str, **params) -> "GaugeAction":
    try:
        cls = _GAUGE_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown gauge action {name!r}; known: {sorted(_GAUGE_REGISTRY)}")
    return cls(**params)


def gauge_names():
    return sorted(_GAUGE_REGISTRY)


def shift(arr, d: int, sign: int, lat_start: int):
    """arr(x + sign·d̂): roll by −sign along lattice axis d (axes start at
    ``lat_start``)."""
    return jnp.roll(arr, -sign, axis=lat_start + d)


# ---------------------------------------------------------------------------
# quaternion algebra for SU(2):  U = w + i(x σ₁ + y σ₂ + z σ₃)
# (iσ_a)(iσ_b) = −δ_ab − i ε_abc σ_c  →  vector part a0·b⃗ + b0·a⃗ − a⃗×b⃗
# ---------------------------------------------------------------------------


def qmul(a, b):
    """Quaternion product of U = w + i x⃗·σ representations.

    a, b: tuples (w, x, y, z) of same-shape arrays."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + bw * ax - (ay * bz - az * by),
        aw * by + bw * ay - (az * bx - ax * bz),
        aw * bz + bw * az - (ax * by - ay * bx),
    )


def qconj(a):
    """U† (unitary inverse for |U| = 1)."""
    aw, ax, ay, az = a
    return (aw, -ax, -ay, -az)


def qnormalize(a, eps=1e-30):
    aw, ax, ay, az = a
    inv = 1.0 / jnp.sqrt(aw * aw + ax * ax + ay * ay + az * az + eps)
    return (aw * inv, ax * inv, ay * inv, az * inv)


def qexp_su2(vx, vy, vz):
    """exp(i v⃗·σ/2) as a quaternion (Rodrigues): (cos|v|/2, sin(|v|/2)·v̂).

    Grad-safe at v⃗ = 0: both `where` branches stay finite under autodiff
    (the naive sqrt(v·v) has an infinite gradient at zero), so the drift
    consistency test can differentiate through the group exponential."""
    n2 = vx * vx + vy * vy + vz * vz
    ns = jnp.sqrt(jnp.maximum(n2, 1e-24))
    half = 0.5 * ns
    small = n2 < 1e-12
    s = jnp.where(small, 0.5 - n2 / 48.0, jnp.sin(half) / ns)
    w = jnp.where(small, 1.0 - n2 / 8.0, jnp.cos(half))
    return (w, s * vx, s * vy, s * vz)


@dataclasses.dataclass(frozen=True)
class GaugeAction:
    """Wilson plaquette action; β multiplies Σ_p (1 − (1/N)ReTr U_p).

    Subclasses provide the full group-agnostic integrator interface so
    :mod:`stochquant.integrators.gauge` contains zero per-group code:
    ``state_shape``/``noise_shape`` fix the layouts, ``drift`` returns a
    tangent-space force with the same structure as
    ``noise_to_tangent(η)``, ``apply_update`` is the exact group step
    ``U ← exp(i Σ_a ω_a T_a) U``, and ``drift_norm`` reduces a force to a
    per-chain max generator-space magnitude for step control.
    """

    beta: float = 1.0

    #: number of real degrees of freedom per link in the state layout
    components: int = 1

    #: dtype of scalar observables (complexified actions report complex
    #: mean plaquettes — see actions/gauge_complex.py)
    obs_dtype: str = "float32"

    def init_links(self, shape):
        raise NotImplementedError

    def action(self, links, ndim: int):
        raise NotImplementedError

    def drift(self, links, ndim: int):
        raise NotImplementedError

    def mean_plaquette(self, links, ndim: int):
        raise NotImplementedError

    def state_shape(self, n_chains: int, ndim: int, lattice) -> tuple:
        raise NotImplementedError

    def noise_shape(self, n_chains: int, ndim: int, lattice) -> tuple:
        """Shape of the iid-N(0,1) *real* noise array drawn per micro-step."""
        raise NotImplementedError

    def noise_to_tangent(self, eta):
        """Map real noise components onto the tangent object that pairs with
        ``drift``'s output (identity for U(1)/SU(2); generator contraction
        for matrix groups)."""
        return eta

    def drift_norm(self, f):
        """Per-chain max over links of the generator-space force magnitude
        √(Σ_a f_a²); shape (C,)."""
        raise NotImplementedError

    def apply_update(self, links, omega):
        """Exact group step: U ← exp(i Σ_a ω_a T_a) U (additive for U(1))."""
        raise NotImplementedError

    def hot_start(self, links, eta):
        """Randomized links given identity ``links`` and one ``noise_shape``
        draw ``eta`` (disordered start, far from the cold identity)."""
        return self.apply_update(links, self.noise_to_tangent(eta))

    def unitarity_norm(self, links, ndim: int):
        """Distance from the unitary submanifold, (C,) ≥ 0.  Identically 0
        for compact-group actions; complexified actions override."""
        import jax.numpy as _jnp

        return _jnp.zeros((links.shape[0],), _jnp.float32)

    # --- domain-decomposition support (parallel/gauge_halo.py, r4) --------
    # The state layouts differ per group, so the halo runner asks each
    # action where the lattice dims live and for a per-SITE plaquette
    # density it can owned-mask and psum across shards.

    def lattice_axes(self, ndim: int) -> tuple:
        """Axes of the STATE array holding the lattice dims."""
        raise NotImplementedError

    def noise_lattice_axes(self, ndim: int) -> tuple:
        """Axes of the ``noise_shape`` array holding the lattice dims."""
        raise NotImplementedError

    def plaquette_site_mean(self, links, ndim: int):
        """(C, *L) local plaquette density: per-site mean over unordered
        orientations of the plaquette observable (whose lattice mean is
        ``mean_plaquette``)."""
        raise NotImplementedError


@register_gauge("u1")
@dataclasses.dataclass(frozen=True)
class U1Wilson(GaugeAction):
    """Compact U(1): links e^{iθ}, state = θ of shape (C, D, *L)."""

    components: int = 1

    def plaquette_angle(self, theta, mu: int, nu: int, ndim: int):
        """P_{μν}(x) = θ_μ(x) + θ_ν(x+μ̂) − θ_μ(x+ν̂) − θ_ν(x); lattice axes
        start at 2 for the (C, D, *L) layout."""
        t_mu = theta[:, mu]
        t_nu = theta[:, nu]
        ls = 1  # after selecting direction, lattice axes start at 1
        return (
            t_mu
            + shift(t_nu, mu, +1, ls)
            - shift(t_mu, nu, +1, ls)
            - t_nu
        )

    def action(self, theta, ndim: int):
        """Total action per chain: β Σ_x Σ_{μ<ν} (1 − cos P)."""
        C = theta.shape[0]
        s = jnp.zeros((C,), theta.dtype)
        for mu in range(ndim):
            for nu in range(mu + 1, ndim):
                p = self.plaquette_angle(theta, mu, nu, ndim)
                s = s + jnp.sum(1.0 - jnp.cos(p), axis=tuple(range(1, p.ndim)))
        return self.beta * s

    def drift(self, theta, ndim: int):
        """−∂S/∂θ_μ(x) = −β Σ_{ν≠μ}[ sin P_{μν}(x) − sin P_{μν}(x−ν̂) ]."""
        out = []
        ls = 1
        for mu in range(ndim):
            acc = jnp.zeros_like(theta[:, mu])
            for nu in range(ndim):
                if nu == mu:
                    continue
                # antisymmetric P_{μν} — compute with μ first regardless of order
                p = self.plaquette_angle(theta, mu, nu, ndim)
                sp = jnp.sin(p)
                acc = acc + sp - shift(sp, nu, -1, ls)
            out.append(-self.beta * acc)
        return jnp.stack(out, axis=1)

    def mean_plaquette(self, theta, ndim: int):
        """⟨cos P⟩ averaged over sites and unordered plaquette orientations,
        per chain."""
        C = theta.shape[0]
        tot = jnp.zeros((C,), theta.dtype)
        n = 0
        for mu in range(ndim):
            for nu in range(mu + 1, ndim):
                p = self.plaquette_angle(theta, mu, nu, ndim)
                tot = tot + jnp.mean(jnp.cos(p), axis=tuple(range(1, p.ndim)))
                n += 1
        return tot / n

    def lattice_axes(self, ndim):
        return tuple(range(2, 2 + ndim))  # (C, D, *L)

    def noise_lattice_axes(self, ndim):
        return tuple(range(2, 2 + ndim))

    def plaquette_site_mean(self, theta, ndim: int):
        acc = None
        n = 0
        for mu in range(ndim):
            for nu in range(mu + 1, ndim):
                c = jnp.cos(self.plaquette_angle(theta, mu, nu, ndim))
                acc = c if acc is None else acc + c
                n += 1
        return acc / n

    def init_links(self, shape):
        """Cold start: all links at the identity (θ = 0)."""
        return jnp.zeros(shape, jnp.float32)

    def state_shape(self, n_chains, ndim, lattice):
        return (n_chains, ndim) + tuple(lattice)

    def noise_shape(self, n_chains, ndim, lattice):
        return (n_chains, ndim) + tuple(lattice)

    def drift_norm(self, f):
        return jnp.max(jnp.abs(f), axis=tuple(range(1, f.ndim)))

    def apply_update(self, theta, omega):
        """θ ← wrap(θ + ω): the group step for e^{iθ} links."""
        t = theta + omega
        return t - jnp.float32(2.0 * np.pi) * jnp.round(t / jnp.float32(2.0 * np.pi))

    def hot_start(self, theta, eta):
        """Spread angles over (−π, π) — a disordered start."""
        return jnp.float32(np.pi) * jnp.tanh(eta)


@register_gauge("su2")
@dataclasses.dataclass(frozen=True)
class SU2Wilson(GaugeAction):
    """SU(2) Wilson: quaternion links, state shape (C, 4, D, *L)."""

    components: int = 4

    @staticmethod
    def _link(q, mu: int):
        """Quaternion tuple for direction μ; each component (C, *L)."""
        return tuple(q[:, c, mu] for c in range(4))

    def _staple_sum(self, q, mu: int, ndim: int):
        """Σ_{ν≠μ} (forward + backward) staples V such that Tr(U_μ(x)·V)
        sums every plaquette containing the link (x, μ)."""
        ls = 1  # lattice axes start at 1 for (C, *L) components
        sh = lambda t, d, s: tuple(shift(c, d, s, ls) for c in t)
        u_mu = self._link(q, mu)
        acc = None
        for nu in range(ndim):
            if nu == mu:
                continue
            u_nu = self._link(q, nu)
            # forward: U_ν(x+μ̂) U_μ†(x+ν̂) U_ν†(x)
            f = qmul(
                qmul(sh(u_nu, mu, +1), qconj(sh(u_mu, nu, +1))), qconj(u_nu)
            )
            # backward: U_ν†(x+μ̂−ν̂) U_μ†(x−ν̂) U_ν(x−ν̂)
            b = qmul(
                qmul(qconj(sh(sh(u_nu, mu, +1), nu, -1)), qconj(sh(u_mu, nu, -1))),
                sh(u_nu, nu, -1),
            )
            term = tuple(ff + bb for ff, bb in zip(f, b))
            acc = term if acc is None else tuple(a + t for a, t in zip(acc, term))
        return acc

    def drift(self, q, ndim: int):
        """Lie-algebra drift f_a = −D_a S = −(β/2)·vec_a(U·V_staple),
        returned with shape (C, 3, D, *L)."""
        per_mu = []
        for mu in range(ndim):
            u = self._link(q, mu)
            v = self._staple_sum(q, mu, ndim)
            w = qmul(u, v)
            per_mu.append(jnp.stack([-0.5 * self.beta * w[1],
                                     -0.5 * self.beta * w[2],
                                     -0.5 * self.beta * w[3]], axis=1))
        # each entry (C, 3, *L) → (C, 3, D, *L)
        return jnp.stack(per_mu, axis=2)

    def plaquette(self, q, mu: int, nu: int):
        """½Tr U_{μν}(x) = scalar part of the plaquette quaternion, (C, *L)."""
        ls = 1
        sh = lambda t, d, s: tuple(shift(c, d, s, ls) for c in t)
        u_mu = self._link(q, mu)
        u_nu = self._link(q, nu)
        p = qmul(
            qmul(u_mu, sh(u_nu, mu, +1)),
            qmul(qconj(sh(u_mu, nu, +1)), qconj(u_nu)),
        )
        return p[0]

    def action(self, q, ndim: int):
        C = q.shape[0]
        s = jnp.zeros((C,), q.dtype)
        for mu in range(ndim):
            for nu in range(mu + 1, ndim):
                w = self.plaquette(q, mu, nu)
                s = s + jnp.sum(1.0 - w, axis=tuple(range(1, w.ndim)))
        return self.beta * s

    def mean_plaquette(self, q, ndim: int):
        C = q.shape[0]
        tot = jnp.zeros((C,), q.dtype)
        n = 0
        for mu in range(ndim):
            for nu in range(mu + 1, ndim):
                w = self.plaquette(q, mu, nu)
                tot = tot + jnp.mean(w, axis=tuple(range(1, w.ndim)))
                n += 1
        return tot / n

    def lattice_axes(self, ndim):
        return tuple(range(3, 3 + ndim))  # (C, 4, D, *L)

    def noise_lattice_axes(self, ndim):
        return tuple(range(3, 3 + ndim))  # (C, 3, D, *L)

    def plaquette_site_mean(self, q, ndim: int):
        acc = None
        n = 0
        for mu in range(ndim):
            for nu in range(mu + 1, ndim):
                w = self.plaquette(q, mu, nu)
                acc = w if acc is None else acc + w
                n += 1
        return acc / n

    def apply_update(self, q, omega):
        """U ← exp(i ω⃗·σ/2) U for ω of shape (C, 3, D, *L); exact group
        step + re-unitarization (one rsqrt) against float drift."""
        r = qexp_su2(omega[:, 0], omega[:, 1], omega[:, 2])
        u = tuple(q[:, c] for c in range(4))
        new = qmul(r, u)
        new = qnormalize(new)
        return jnp.stack(new, axis=1)

    def init_links(self, shape):
        """Cold start at the identity: q = (1, 0, 0, 0).  ``shape`` is the
        full (C, 4, D, *L) state shape."""
        q = jnp.zeros(shape, jnp.float32)
        return q.at[:, 0].set(1.0)

    def state_shape(self, n_chains, ndim, lattice):
        return (n_chains, 4, ndim) + tuple(lattice)

    def noise_shape(self, n_chains, ndim, lattice):
        return (n_chains, 3, ndim) + tuple(lattice)

    def drift_norm(self, f):
        """Max over (direction, sites) of √(Σ_a f_a²); f is (C, 3, D, *L)."""
        return jnp.max(
            jnp.sqrt(jnp.sum(f * f, axis=1)), axis=tuple(range(1, f.ndim - 1))
        )


# ---------------------------------------------------------------------------
# SU(3): complex 3×3 matrix links.
#
# Layout (C, D, *L, 3, 3) complex — the 3×3 algebra lives on the two
# trailing (minor) axes, so every product is a batched tiny matmul that XLA
# vectorizes; all lattice shifts are rolls over the middle axes.
# ---------------------------------------------------------------------------


def mmul(a, b):
    """Batched 3×3 matrix product on the trailing axes.

    precision=HIGHEST: XLA's default precision may run f32 (and the f32
    halves of complex64) contractions at reduced precision on an
    accelerator (TF32 on NVIDIA GPUs, ~1e-3 relative error).  The
    3-element contraction cost is negligible; exact fp32 keeps the gauge
    update and its observables at float32 accuracy."""
    return jnp.einsum(
        "...ab,...bc->...ac", a, b, precision=jax.lax.Precision.HIGHEST
    )


def dag(a):
    """Hermitian conjugate on the trailing axes."""
    return jnp.conj(jnp.swapaxes(a, -1, -2))


def retr(a):
    """Re Tr on the trailing axes."""
    return jnp.real(jnp.trace(a, axis1=-2, axis2=-1))


# Gell-Mann generators T_a = λ_a/2 (Tr T_aT_b = δ_ab/2), constant (8,3,3).
_S3 = 1.0 / np.sqrt(3.0)
_GELLMANN = 0.5 * np.array(
    [
        [[0, 1, 0], [1, 0, 0], [0, 0, 0]],
        [[0, -1j, 0], [1j, 0, 0], [0, 0, 0]],
        [[1, 0, 0], [0, -1, 0], [0, 0, 0]],
        [[0, 0, 1], [0, 0, 0], [1, 0, 0]],
        [[0, 0, -1j], [0, 0, 0], [1j, 0, 0]],
        [[0, 0, 0], [0, 0, 1], [0, 1, 0]],
        [[0, 0, 0], [0, 0, -1j], [0, 1j, 0]],
        [[_S3, 0, 0], [0, _S3, 0], [0, 0, -2 * _S3]],
    ],
    dtype=np.complex64,
)


def expi_su3(q):
    """exp(iQ) for hermitian traceless 3×3 Q — exact Cayley–Hamilton closed
    form (Morningstar & Peardon, hep-lat/0311018 §III):

        exp(iQ) = f₀·1 + f₁·Q + f₂·Q²,

    with f_j functions of the two invariants c₁ = ½Tr Q², c₀ = det Q.
    Branch handling: c₀ < 0 via the symmetry f_j(−c₀) = (−1)^j f_j(c₀)*;
    the |c₀| → c₀^max degenerate corner is kept off the pole by clamping
    the arccos argument; Q → 0 falls back to a 4-term Taylor series (also
    makes autodiff through the exponential exact at Q = 0).  Verified
    against ``scipy.linalg.expm`` in tests/test_gauge.py.
    """
    cdtype = q.dtype
    q2 = mmul(q, q)
    c1 = 0.5 * jnp.real(jnp.trace(q2, axis1=-2, axis2=-1))
    c0 = jnp.real(jnp.trace(mmul(q2, q), axis1=-2, axis2=-1)) / 3.0

    small = c1 < 1e-8
    c1s = jnp.where(small, 1.0, c1)  # benign point for the closed form

    c0a = jnp.abs(c0)
    c0max = 2.0 * (c1s / 3.0) ** 1.5
    theta = jnp.arccos(jnp.clip(c0a / c0max, 0.0, 1.0 - 1e-6))
    u = jnp.sqrt(c1s / 3.0) * jnp.cos(theta / 3.0)
    w = jnp.sqrt(c1s) * jnp.sin(theta / 3.0)

    w2 = w * w
    xi0 = jnp.where(
        w2 < 1e-4,
        1.0 - w2 / 6.0 * (1.0 - w2 / 20.0 * (1.0 - w2 / 42.0)),
        jnp.sin(w) / jnp.where(w2 < 1e-4, 1.0, w),
    )
    cosw = jnp.cos(w)
    e2iu = jnp.exp(2j * u.astype(cdtype))
    emiu = jnp.exp(-1j * u.astype(cdtype))
    u2 = u * u

    h0 = (u2 - w2) * e2iu + emiu * (8.0 * u2 * cosw + 2j * u * (3.0 * u2 + w2) * xi0)
    h1 = 2.0 * u * e2iu - emiu * (2.0 * u * cosw - 1j * (3.0 * u2 - w2) * xi0)
    h2 = e2iu - emiu * (cosw + 3j * u * xi0)

    denom = 9.0 * u2 - w2
    f0 = h0 / denom
    f1 = h1 / denom
    f2 = h2 / denom

    # c0 < 0: f_j(c0) = (−1)^j conj(f_j(|c0|))
    neg = c0 < 0.0
    f0 = jnp.where(neg, jnp.conj(f0), f0)
    f1 = jnp.where(neg, -jnp.conj(f1), f1)
    f2 = jnp.where(neg, jnp.conj(f2), f2)

    eye = jnp.eye(3, dtype=cdtype)
    closed = (
        f0[..., None, None] * eye + f1[..., None, None] * q + f2[..., None, None] * q2
    )
    # Q → 0: exp(iQ) ≈ 1 + iQ − Q²/2 − iQ³/6 (error O(|Q|⁴) ≤ 1e-16 under
    # the c1 < 1e-8 gate)
    taylor = eye + 1j * q - 0.5 * q2 - (1j / 6.0) * mmul(q2, q)
    return jnp.where(small[..., None, None], taylor, closed)


def project_su3(u):
    """Nudge u back onto SU(3) against float roundoff drift: one Newton step
    toward the nearest unitary, U ← U(3·1 − U†U)/2 (quadratic convergence
    for ‖U†U − 1‖ ≪ 1), then divide out the det phase so det U = 1."""
    u = mmul(u, 1.5 * jnp.eye(3, dtype=u.dtype) - 0.5 * mmul(dag(u), u))
    d = (
        u[..., 0, 0] * (u[..., 1, 1] * u[..., 2, 2] - u[..., 1, 2] * u[..., 2, 1])
        - u[..., 0, 1] * (u[..., 1, 0] * u[..., 2, 2] - u[..., 1, 2] * u[..., 2, 0])
        + u[..., 0, 2] * (u[..., 1, 0] * u[..., 2, 1] - u[..., 1, 1] * u[..., 2, 0])
    )
    phase = jnp.exp((-1j / 3.0) * jnp.angle(d).astype(u.dtype))
    return u * phase[..., None, None]


@register_gauge("su3")
@dataclasses.dataclass(frozen=True)
class SU3Wilson(GaugeAction):
    """SU(3) Wilson: matrix links, state shape (C, D, *L, 3, 3) complex64.

    Langevin drift (generators T_a = λ_a/2, ⟨η_aη_b⟩ = 2δ_ab):

        f_a = −D_a S = (β/(2N)) Tr[T_a · i(M − M†)],   M = U_μ(x)·V_μ(x)

    with V the staple sum; as a matrix, H = Σ_a f_a T_a =
    (β/(4N))·[G − (Tr G/N)·1] with G = i(M − M†) — the traceless-hermitian
    projection.  Update U ← exp(iΩ)U via the exact Cayley–Hamilton
    exponential, plus a one-Newton-step re-unitarization against fp32 drift
    (the SU(2) path's rsqrt analog)."""

    components: int = 18  # 9 complex entries

    N: int = 3

    def state_shape(self, n_chains, ndim, lattice):
        return (n_chains, ndim) + tuple(lattice) + (3, 3)

    def noise_shape(self, n_chains, ndim, lattice):
        return (n_chains, 8, ndim) + tuple(lattice)

    def noise_to_tangent(self, eta):
        """(C, 8, D, *L) real → (C, D, *L, 3, 3) hermitian Σ_a η_a T_a."""
        t = jnp.asarray(_GELLMANN)
        return jnp.einsum(
            "ca...,aij->c...ij", eta.astype(jnp.complex64), t,
            precision=jax.lax.Precision.HIGHEST,
        )

    def init_links(self, shape):
        eye = jnp.eye(3, dtype=jnp.complex64)
        return jnp.broadcast_to(eye, shape)

    def _shifted(self, u, d, sign):
        """u(x + sign·d̂) for a (C, *L, 3, 3) per-direction link field:
        lattice axes run from 1 to ndim−2 exclusive of the matrix axes."""
        return jnp.roll(u, -sign, axis=1 + d)

    def plaquette(self, links, mu: int, nu: int):
        """U_{μν}(x) as matrices, (C, *L, 3, 3)."""
        u_mu = links[:, mu]
        u_nu = links[:, nu]
        return mmul(
            mmul(u_mu, self._shifted(u_nu, mu, +1)),
            mmul(dag(self._shifted(u_mu, nu, +1)), dag(u_nu)),
        )

    def action(self, links, ndim: int):
        C = links.shape[0]
        s = jnp.zeros((C,), jnp.float32)
        for mu in range(ndim):
            for nu in range(mu + 1, ndim):
                w = retr(self.plaquette(links, mu, nu)) / self.N
                s = s + jnp.sum(1.0 - w, axis=tuple(range(1, w.ndim)))
        return self.beta * s

    def mean_plaquette(self, links, ndim: int):
        C = links.shape[0]
        tot = jnp.zeros((C,), jnp.float32)
        n = 0
        for mu in range(ndim):
            for nu in range(mu + 1, ndim):
                w = retr(self.plaquette(links, mu, nu)) / self.N
                tot = tot + jnp.mean(w, axis=tuple(range(1, w.ndim)))
                n += 1
        return tot / n

    def lattice_axes(self, ndim):
        return tuple(range(2, 2 + ndim))  # (C, D, *L, 3, 3)

    def noise_lattice_axes(self, ndim):
        return tuple(range(3, 3 + ndim))  # (C, 8, D, *L)

    def plaquette_site_mean(self, links, ndim: int):
        acc = None
        n = 0
        for mu in range(ndim):
            for nu in range(mu + 1, ndim):
                w = retr(self.plaquette(links, mu, nu)) / self.N
                acc = w if acc is None else acc + w
                n += 1
        return acc / n

    def _staple_sum(self, links, mu: int, ndim: int):
        """Σ_{ν≠μ} forward + backward staples V_μ(x), (C, *L, 3, 3), such
        that Σ_p containing (x,μ) ReTr U_p = ReTr[U_μ(x) V_μ(x)]."""
        sh = self._shifted
        u_mu = links[:, mu]
        acc = None
        for nu in range(ndim):
            if nu == mu:
                continue
            u_nu = links[:, nu]
            # forward: U_ν(x+μ̂) U_μ†(x+ν̂) U_ν†(x)
            f = mmul(mmul(sh(u_nu, mu, +1), dag(sh(u_mu, nu, +1))), dag(u_nu))
            # backward: U_ν†(x+μ̂−ν̂) U_μ†(x−ν̂) U_ν(x−ν̂)
            b = mmul(
                mmul(dag(sh(sh(u_nu, mu, +1), nu, -1)), dag(sh(u_mu, nu, -1))),
                sh(u_nu, nu, -1),
            )
            term = f + b
            acc = term if acc is None else acc + term
        return acc

    def drift(self, links, ndim: int):
        """Tangent force H = Σ_a f_a T_a, (C, D, *L, 3, 3) hermitian
        traceless; verified against ∂_s S(e^{isT}U)|₀ in tests."""
        per_mu = []
        for mu in range(ndim):
            m = mmul(links[:, mu], self._staple_sum(links, mu, ndim))
            g = 1j * (m - dag(m))
            tr = jnp.trace(g, axis1=-2, axis2=-1)
            h = (self.beta / (4.0 * self.N)) * (
                g - (tr / self.N)[..., None, None] * jnp.eye(3, dtype=g.dtype)
            )
            per_mu.append(h)
        return jnp.stack(per_mu, axis=1)

    def drift_norm(self, f):
        """√(Σ_a f_a²) = √(2 Tr H²) = √2·‖H‖_F per link; max over links."""
        n = jnp.sqrt(2.0 * jnp.sum(jnp.abs(f) ** 2, axis=(-2, -1)))
        return jnp.max(n, axis=tuple(range(1, n.ndim)))

    def apply_update(self, links, omega):
        """U ← exp(iΩ)U, exact group exponential + re-unitarization."""
        return project_su3(mmul(expi_su3(omega), links))
