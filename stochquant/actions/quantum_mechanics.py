"""Registered 1-D quantum-mechanical actions.

Parameter defaults reproduce the reference's physics constants — η=0.8,
V₀=2, m=1 (``tau_kernel.cl:19-22``) — in exactly one place (fixes flaw F6).
Potentials 1 (Pöschl–Teller) and 2 (quartic) were *advertised* by the
reference's Windows presets (``taumain_windows.py:111-129``) but never
implemented in its kernel (SURVEY.md K8, undefined behaviour); here they are
real.
"""

from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp

from stochquant.actions.base import QMAction, register


@register("harmonic")
@dataclasses.dataclass(frozen=True)
class HarmonicOscillator(QMAction):
    """V(x) = ½·k·x².  Default k=2 matches the reference's V''≡2
    (``tau_kernel.cl:206-209``), i.e. angular frequency ω₀=√(k/m)=√2.

    Continuum ground-state ⟨x²⟩ = 1/(2·m·ω₀); the exact *finite-Δt* value
    used by the regression tests is in observables/exact.py.
    """

    k: float = 2.0

    def V(self, x):
        return 0.5 * self.k * x * x

    def dV(self, x):
        return self.k * x

    def ddV(self, x):
        return jnp.full_like(x, self.k)

    @property
    def omega0(self) -> float:
        return math.sqrt(self.k / self.mass)


@register("double_well")
@dataclasses.dataclass(frozen=True)
class DoubleWell(QMAction):
    """V(x) = V₀·((x/η)² − 1)², the reference's potID 3.

    Derivatives match ``tau_kernel.cl:190-195`` (V'' = (12V₀x²/η² − 4V₀)/η²).
    Background: the instanton/kink x_cl(t, ω) = η·tanh(√(2V₀/m)·(t−ω)/η)
    (``tau_kernel.cl:184-189``) with ω the kink-center collective coordinate;
    its translational-zero-mode normalization is √3·2^(−5/4)·V₀^(−1/4)/√η
    (``tau_kernel.cl:196-200``).
    """

    v0: float = 2.0
    eta: float = 0.8
    has_zero_mode = True

    def V(self, x):
        u = (x / self.eta) ** 2 - 1.0
        return self.v0 * u * u

    def dV(self, x):
        e2 = self.eta * self.eta
        return 4.0 * self.v0 * x * (x * x - e2) / (e2 * e2)

    def ddV(self, x):
        e2 = self.eta * self.eta
        return (12.0 * self.v0 * x * x / e2 - 4.0 * self.v0) / e2

    def x_cl(self, t, omega):
        w = math.sqrt(2.0 * self.v0 / self.mass) / self.eta
        return self.eta * jnp.tanh(w * (t - omega))

    def boundary_asymptote(self, side: int):
        return side * self.eta

    def zero_mode_const(self) -> float:
        return (
            math.sqrt(3.0)
            * 2.0 ** (-5.0 / 4.0)
            * self.v0 ** (-1.0 / 4.0)
            / math.sqrt(self.eta)
        )


@register("anharmonic")
@dataclasses.dataclass(frozen=True)
class AnharmonicOscillator(QMAction):
    """V(x) = ½·μ²·x² + λ·x⁴ (the λφ⁴ quartic oscillator, reference potID 2
    — declared by the Windows launcher, never implemented in the kernel)."""

    mu2: float = 1.0
    lam: float = 1.0

    def V(self, x):
        x2 = x * x
        return 0.5 * self.mu2 * x2 + self.lam * x2 * x2

    def dV(self, x):
        return self.mu2 * x + 4.0 * self.lam * x * x * x

    def ddV(self, x):
        return self.mu2 + 12.0 * self.lam * x * x


@register("poeschl_teller")
@dataclasses.dataclass(frozen=True)
class PoeschlTeller(QMAction):
    """V(x) = −V₀ / cosh²(x/a) (reference potID 1 — declared by the Windows
    launcher, never implemented in the kernel).  Derivatives via autodiff."""

    v0: float = 1.0
    a: float = 1.0

    def V(self, x):
        c = jnp.cosh(x / self.a)
        return -self.v0 / (c * c)
