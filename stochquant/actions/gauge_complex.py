"""Complexified gauge actions for complex Langevin: ℂ* (complexified U(1))
and SL(N,ℂ) (complexified SU(N)) Wilson theories with gauge cooling.

Complex Langevin extends stochastic quantization to complex actions — here a
complex coupling β = β_r + i·β_i (the gauge-theory analog of the complex
couplings in ``actions/complex_actions.py``; the sign-problem use case the
CL literature targets).  The reference implements only real-action 1-D QM
(SURVEY.md §2.1 K8); this module is part of the model-family extension and
reuses the group-agnostic integrator (`integrators/gauge.py`) unchanged.

Complexification (Parisi–Wu with holomorphic drift):

* links live in the complexified group — θ ∈ ℂ for U(1), U ∈ SL(N,ℂ) for
  SU(N) — and the drift is the *holomorphic* derivative of the analytically
  continued Wilson action

      S[U] = β Σ_p (1 − (1/2N)·(Tr U_p + Tr U_p⁻¹)),

  which reduces to the real Wilson action on the unitary submanifold
  (U_p⁻¹ = U_p† there).  Noise is real (NI = 0, the standard stable choice).

* Holomorphic drift, derived exactly as in the unitary case but with
  daggers → inverses (``actions/gauge.py:SU3Wilson.drift`` docstring):

      H(x,μ) = (iβ/(4N))·traceless[ M − M̃ ],
      M = U_μ(x)·V_μ(x),   M̃ = W_μ(x)·U_μ(x)⁻¹,

  V the staple sum with inverses, W the sum of inverse staples.  At unitary
  links and real β this equals the real-path drift (gated by the tests).

* **Gauge cooling** (Seiler–Sexty–Stamatescu, arXiv:1211.3709): the drift
  dynamics explores gauge orbits of SL(N,ℂ), whose non-compact directions
  let the unitarity norm grow without changing any observable.  Cooling
  applies gauge transforms G(x) = exp(−ε·V_gc(x)) (hermitian, non-unitary)
  descending the unitarity norm

      N_u = (1/(D·Vol))·Σ_{x,μ} (1/N)·Tr[ U U† + (U U†)⁻¹ − 2 ] ≥ 0,

  with V_gc(x) = Σ_μ [U_μ(x)U_μ(x)† − U_μ(x−μ̂)†U_μ(x−μ̂) − (inverse
  counterparts)], the exact gradient of N_u along the gauge orbit.  For
  U(1) the orbit is abelian and cooling is a plain gradient step on Im θ.

Matrix exponentials here are Taylor-series with Horner evaluation
(:func:`expm_taylor`): Langevin/cooling steps are O(√Δτ) small, so a
12-term series is exact to fp32 — no eigendecompositions on the device.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from stochquant.actions.gauge import (
    GaugeAction,
    _GELLMANN,
    dag,
    mmul,
    register_gauge,
    shift,
)

__all__ = [
    "ComplexU1Wilson",
    "ComplexSUNWilson",
    "expm_taylor",
    "inv33",
    "inv22",
]


def expm_taylor(a, order: int = 12):
    """exp(A) for small batched square matrices via Horner-evaluated Taylor.

    For ‖A‖ ≲ 0.5 (always true for Langevin increments ∼ √Δτ and cooling
    steps ∼ ε) the order-12 remainder is < 2⁻⁴⁶ — below fp32 resolution."""
    eye = jnp.eye(a.shape[-1], dtype=a.dtype)
    out = eye + a / order
    for k in range(order - 1, 0, -1):
        out = eye + mmul(a, out) / k
    return out


def inv22(u):
    """Closed-form inverse of batched 2×2 matrices (trailing axes)."""
    det = u[..., 0, 0] * u[..., 1, 1] - u[..., 0, 1] * u[..., 1, 0]
    adj = jnp.stack(
        [
            jnp.stack([u[..., 1, 1], -u[..., 0, 1]], axis=-1),
            jnp.stack([-u[..., 1, 0], u[..., 0, 0]], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def inv33(u):
    """Closed-form inverse of batched 3×3 matrices via the adjugate
    (cofactor transpose) — no linear solves in the hot path."""
    a, b, c = u[..., 0, 0], u[..., 0, 1], u[..., 0, 2]
    d, e, f = u[..., 1, 0], u[..., 1, 1], u[..., 1, 2]
    g, h, i = u[..., 2, 0], u[..., 2, 1], u[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    row0 = jnp.stack([A, -(b * i - c * h), b * f - c * e], axis=-1)
    row1 = jnp.stack([B, a * i - c * g, -(a * f - c * d)], axis=-1)
    row2 = jnp.stack([C, -(a * h - b * g), a * e - b * d], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2) / det[..., None, None]


@register_gauge("cu1")
@dataclasses.dataclass(frozen=True)
class ComplexU1Wilson(GaugeAction):
    """Complexified compact U(1): links e^{iθ}, θ ∈ ℂ, state complex64
    (C, D, *L); coupling β = beta + i·beta_im.

    Holomorphic drift is the analytic continuation of the real-path formula
    (``actions/gauge.py:U1Wilson.drift``); observables (mean plaquette
    ⟨cos P⟩) are complex.
    """

    beta_im: float = 0.0
    components: int = 2
    obs_dtype: str = "complex64"

    @property
    def beta_c(self):
        return jnp.complex64(self.beta + 1j * self.beta_im)

    def plaquette_angle(self, theta, mu: int, nu: int, ndim: int):
        t_mu = theta[:, mu]
        t_nu = theta[:, nu]
        ls = 1
        return t_mu + shift(t_nu, mu, +1, ls) - shift(t_mu, nu, +1, ls) - t_nu

    def action(self, theta, ndim: int):
        C = theta.shape[0]
        s = jnp.zeros((C,), theta.dtype)
        for mu in range(ndim):
            for nu in range(mu + 1, ndim):
                p = self.plaquette_angle(theta, mu, nu, ndim)
                s = s + jnp.sum(1.0 - jnp.cos(p), axis=tuple(range(1, p.ndim)))
        return self.beta_c * s

    def drift(self, theta, ndim: int):
        """−∂S/∂θ_μ(x), holomorphic (complex sin of complex P)."""
        out = []
        ls = 1
        for mu in range(ndim):
            acc = jnp.zeros_like(theta[:, mu])
            for nu in range(ndim):
                if nu == mu:
                    continue
                p = self.plaquette_angle(theta, mu, nu, ndim)
                sp = jnp.sin(p)
                acc = acc + sp - shift(sp, nu, -1, ls)
            out.append(-self.beta_c * acc)
        return jnp.stack(out, axis=1)

    def mean_plaquette(self, theta, ndim: int):
        C = theta.shape[0]
        tot = jnp.zeros((C,), theta.dtype)
        n = 0
        for mu in range(ndim):
            for nu in range(mu + 1, ndim):
                p = self.plaquette_angle(theta, mu, nu, ndim)
                tot = tot + jnp.mean(jnp.cos(p), axis=tuple(range(1, p.ndim)))
                n += 1
        return tot / n

    def init_links(self, shape):
        return jnp.zeros(shape, jnp.complex64)

    def state_shape(self, n_chains, ndim, lattice):
        return (n_chains, ndim) + tuple(lattice)

    def noise_shape(self, n_chains, ndim, lattice):
        return (n_chains, ndim) + tuple(lattice)

    def noise_to_tangent(self, eta):
        return eta.astype(jnp.complex64)

    def drift_norm(self, f):
        return jnp.max(jnp.abs(f), axis=tuple(range(1, f.ndim)))

    def apply_update(self, theta, omega):
        """θ ← θ + ω, real part wrapped to (−π, π] (imaginary part is the
        non-compact direction — left to cooling / the runaway detector)."""
        t = theta + omega
        re = jnp.real(t)
        two_pi = jnp.float32(2.0 * np.pi)
        return t - two_pi * jnp.round(re / two_pi)

    def hot_start(self, theta, eta):
        return (jnp.float32(np.pi) * jnp.tanh(eta)).astype(jnp.complex64)

    # -- complex-Langevin safety surface ------------------------------------

    def unitarity_norm(self, theta, ndim: int):
        """Mean Im(θ)² per chain — 0 iff the configuration is unitary."""
        im = jnp.imag(theta)
        return jnp.mean(im * im, axis=tuple(range(1, theta.ndim)))

    def cool(self, theta, ndim: int, rate: float, steps: int):
        """Gauge-cooling gradient steps on Im θ.

        Gauge orbit: Im θ_μ(x) → Im θ_μ(x) + b(x) − b(x+μ̂).  The descent
        step is b(x) = −ε·Σ_μ[Imθ_μ(x) − Imθ_μ(x−μ̂)] (a lattice divergence;
        the gradient's factor 2 is absorbed into ε).  Re θ is untouched —
        cooling is exactly gauge.

        The composite map Imθ ← (1 − ε·DᵀD)·Imθ has spectral radius bound
        4·ndim for the lattice operator DᵀD, so ε is clamped to 1/(4·ndim)
        — the monotone-descent bound — making any configured cooling_rate
        safe (the SU(N) path normalizes its step adaptively; this is the
        abelian analog)."""
        eff = min(float(rate), 1.0 / (4.0 * ndim))
        ls = 1
        for _ in range(steps):
            im = jnp.imag(theta)
            div = jnp.zeros_like(im[:, 0])
            for mu in range(ndim):
                div = div + im[:, mu] - shift(im[:, mu], mu, -1, ls)
            b = -eff * div  # (C, *L)
            delta = jnp.stack(
                [b - shift(b, mu, +1, ls) for mu in range(ndim)], axis=1
            )
            theta = theta + 1j * delta.astype(jnp.float32)
        return theta


def _sun_generators(n: int) -> np.ndarray:
    """Fundamental generators T_a (Tr T_aT_b = δ_ab/2): Pauli/2 for N=2,
    Gell-Mann/2 for N=3."""
    if n == 2:
        pauli = np.array(
            [
                [[0, 1], [1, 0]],
                [[0, -1j], [1j, 0]],
                [[1, 0], [0, -1]],
            ],
            dtype=np.complex64,
        )
        return 0.5 * pauli
    if n == 3:
        return np.asarray(_GELLMANN)
    raise NotImplementedError(n)


@dataclasses.dataclass(frozen=True)
class ComplexSUNWilson(GaugeAction):
    """SL(N,ℂ) Wilson theory (complexified SU(N)) with matrix links,
    state (C, D, *L, N, N) complex64 and β = beta + i·beta_im.

    Action  S = β Σ_p (1 − (1/2N)(Tr U_p + Tr U_p⁻¹))  — the holomorphic
    continuation of the real Wilson action (they agree on SU(N)).
    """

    beta_im: float = 0.0
    N: int = 3
    components: int = 18  # 2·N² real dof per link (overridden per group)
    obs_dtype: str = "complex64"

    @property
    def beta_c(self):
        return jnp.complex64(self.beta + 1j * self.beta_im)

    def _inv(self, u):
        return inv22(u) if self.N == 2 else inv33(u)

    def state_shape(self, n_chains, ndim, lattice):
        return (n_chains, ndim) + tuple(lattice) + (self.N, self.N)

    def noise_shape(self, n_chains, ndim, lattice):
        return (n_chains, self.N * self.N - 1, ndim) + tuple(lattice)

    def noise_to_tangent(self, eta):
        t = jnp.asarray(_sun_generators(self.N))
        return jnp.einsum(
            "ca...,aij->c...ij", eta.astype(jnp.complex64), t,
            precision=jax.lax.Precision.HIGHEST,
        )

    def init_links(self, shape):
        eye = jnp.eye(self.N, dtype=jnp.complex64)
        return jnp.broadcast_to(eye, shape)

    def _shifted(self, u, d, sign):
        return jnp.roll(u, -sign, axis=1 + d)

    def plaquette(self, links, mu: int, nu: int):
        """U_{μν}(x) with inverses in place of daggers (C, *L, N, N)."""
        u_mu = links[:, mu]
        u_nu = links[:, nu]
        return mmul(
            mmul(u_mu, self._shifted(u_nu, mu, +1)),
            mmul(self._inv(self._shifted(u_mu, nu, +1)), self._inv(u_nu)),
        )

    def _tr_sym(self, p):
        """(1/2N)(Tr U_p + Tr U_p⁻¹) — for SL(N,C) the inverse trace is the
        other holomorphic invariant (= conj on the unitary submanifold)."""
        t1 = jnp.trace(p, axis1=-2, axis2=-1)
        t2 = jnp.trace(self._inv(p), axis1=-2, axis2=-1)
        return (t1 + t2) / (2.0 * self.N)

    def action(self, links, ndim: int):
        C = links.shape[0]
        s = jnp.zeros((C,), jnp.complex64)
        for mu in range(ndim):
            for nu in range(mu + 1, ndim):
                w = self._tr_sym(self.plaquette(links, mu, nu))
                s = s + jnp.sum(1.0 - w, axis=tuple(range(1, w.ndim)))
        return self.beta_c * s

    def mean_plaquette(self, links, ndim: int):
        C = links.shape[0]
        tot = jnp.zeros((C,), jnp.complex64)
        n = 0
        for mu in range(ndim):
            for nu in range(mu + 1, ndim):
                w = self._tr_sym(self.plaquette(links, mu, nu))
                tot = tot + jnp.mean(w, axis=tuple(range(1, w.ndim)))
                n += 1
        return tot / n

    def _staples(self, links, mu: int, ndim: int):
        """(V, W): V the staple sum with inverses (Σ Tr U_p = Tr[U_μ V]),
        W the inverse-staple sum (Σ Tr U_p⁻¹ = Tr[W U_μ⁻¹])."""
        sh = self._shifted
        inv = self._inv
        u_mu = links[:, mu]
        v = w = None
        for nu in range(ndim):
            if nu == mu:
                continue
            u_nu = links[:, nu]
            # forward: U_ν(x+μ̂) U_μ⁻¹(x+ν̂) U_ν⁻¹(x)
            fv = mmul(mmul(sh(u_nu, mu, +1), inv(sh(u_mu, nu, +1))), inv(u_nu))
            # backward: U_ν⁻¹(x+μ̂−ν̂) U_μ⁻¹(x−ν̂) U_ν(x−ν̂)
            bv = mmul(
                mmul(inv(sh(sh(u_nu, mu, +1), nu, -1)), inv(sh(u_mu, nu, -1))),
                sh(u_nu, nu, -1),
            )
            term_v = fv + bv
            term_w = inv(fv) + inv(bv)
            v = term_v if v is None else v + term_v
            w = term_w if w is None else w + term_w
        return v, w

    def drift(self, links, ndim: int):
        """Holomorphic tangent drift H = (iβ/(4N))·traceless[M − M̃],
        M = U V, M̃ = W U⁻¹; equals the real-path hermitian drift at unitary
        links and real β (tests/test_gauge_complex.py)."""
        inv = self._inv
        eye = jnp.eye(self.N, dtype=jnp.complex64)
        per_mu = []
        for mu in range(ndim):
            u = links[:, mu]
            v, w = self._staples(links, mu, ndim)
            g = mmul(u, v) - mmul(w, inv(u))
            tr = jnp.trace(g, axis1=-2, axis2=-1)
            h = (1j * self.beta_c / (4.0 * self.N)) * (
                g - (tr / self.N)[..., None, None] * eye
            )
            per_mu.append(h)
        return jnp.stack(per_mu, axis=1)

    def drift_norm(self, f):
        n = jnp.sqrt(2.0 * jnp.sum(jnp.abs(f) ** 2, axis=(-2, -1)))
        return jnp.max(n, axis=tuple(range(1, n.ndim)))

    def apply_update(self, links, omega):
        """U ← exp(iΩ)U (Ω complex traceless → general SL(N,C) step) with a
        det-phase renormalization U ← U/det(U)^{1/N} against float drift."""
        u = mmul(expm_taylor(1j * omega), links)
        det = (
            u[..., 0, 0] * u[..., 1, 1] - u[..., 0, 1] * u[..., 1, 0]
            if self.N == 2
            else u[..., 0, 0]
            * (u[..., 1, 1] * u[..., 2, 2] - u[..., 1, 2] * u[..., 2, 1])
            - u[..., 0, 1] * (u[..., 1, 0] * u[..., 2, 2] - u[..., 1, 2] * u[..., 2, 0])
            + u[..., 0, 2] * (u[..., 1, 0] * u[..., 2, 1] - u[..., 1, 1] * u[..., 2, 0])
        )
        # det is exp-small-perturbation of 1: N-th root via log is exact and
        # branch-safe there
        root = jnp.exp(jnp.log(det) / self.N)
        return u / root[..., None, None]

    # -- complex-Langevin safety surface ------------------------------------

    def unitarity_norm(self, links, ndim: int):
        """N_u = ⟨(1/N)Tr[UU† + (UU†)⁻¹ − 2]⟩ ≥ 0, = 0 iff unitary."""
        uu = mmul(links, dag(links))
        tr = jnp.real(jnp.trace(uu, axis1=-2, axis2=-1))
        tri = jnp.real(jnp.trace(self._inv(uu), axis1=-2, axis2=-1))
        val = (tr + tri - 2.0 * self.N) / self.N
        return jnp.mean(val, axis=tuple(range(1, val.ndim)))

    def _cooling_force(self, links, ndim: int):
        """Hermitian traceless V_gc(x) = ∇N_u along the gauge orbit:
        Σ_μ [UU†−(UU†)⁻¹]_μ(x) − [U†U−(U†U)⁻¹]_μ(x−μ̂) (both the UU† and
        inverse terms of N_u contribute, keeping cooling a strict descent
        direction for the full norm)."""
        inv = self._inv
        acc = None
        for mu in range(ndim):
            u = links[:, mu]
            uu = mmul(u, dag(u))
            a = uu - inv(uu)
            uu_b = mmul(dag(u), u)
            b = uu_b - inv(uu_b)
            term = a - jnp.roll(b, +1, axis=1 + mu)  # b at x−μ̂
            acc = term if acc is None else acc + term
        tr = jnp.trace(acc, axis1=-2, axis2=-1)
        eye = jnp.eye(self.N, dtype=jnp.complex64)
        return acc - (tr / self.N)[..., None, None] * eye

    def cool(self, links, ndim: int, rate: float, steps: int):
        """SSS gauge cooling: U_μ(x) ← G(x) U_μ(x) G(x+μ̂)⁻¹ with
        G = exp(−ε V_gc) (hermitian, det 1) — exactly gauge, so every
        holomorphic observable is invariant.

        The step is adaptively normalized per site, ε_eff = ε/max(1, ‖V_gc‖_F)
        (Aarts–Attanasio–Jäger–Sexty-style adaptive cooling): the raw
        gradient grows exponentially with the distance from the unitary
        manifold, and an unnormalized step both overshoots the descent and
        leaves the Taylor expm's convergence region."""
        for _ in range(steps):
            vgc = self._cooling_force(links, ndim)
            vnorm = jnp.sqrt(jnp.sum(jnp.abs(vgc) ** 2, axis=(-2, -1), keepdims=True))
            eps = rate / jnp.maximum(1.0, jnp.real(vnorm))
            g = expm_taylor(-eps * vgc)
            gi = expm_taylor(eps * vgc)
            new = []
            for mu in range(ndim):
                gi_up = jnp.roll(gi, -1, axis=mu + 1)  # G⁻¹(x+μ̂)
                new.append(mmul(mmul(g, links[:, mu]), gi_up))
            links = jnp.stack(new, axis=1)
        return links


@register_gauge("csu2")
@dataclasses.dataclass(frozen=True)
class ComplexSU2Wilson(ComplexSUNWilson):
    N: int = 2
    components: int = 8


@register_gauge("csu3")
@dataclasses.dataclass(frozen=True)
class ComplexSU3Wilson(ComplexSUNWilson):
    N: int = 3
