"""Action registry — 1-D quantum mechanics, D-dim scalar fields, complex
actions.  ``actions.get(name)`` resolves QM actions (the reference's potID
dispatch, ``tau_kernel.cl:215-246``, as a registry instead of if-chains)."""

from stochquant.actions.base import QMAction, get, names, register  # noqa: F401
from stochquant.actions.quantum_mechanics import (  # noqa: F401
    AnharmonicOscillator,
    DoubleWell,
    HarmonicOscillator,
    PoeschlTeller,
)
from stochquant.actions.phi4 import (  # noqa: F401
    FieldAction,
    FreeField,
    ScalarPhi4,
    field_names,
    get_field,
    periodic_laplacian,
)
from stochquant.actions.complex_actions import (  # noqa: F401
    ComplexAction,
    ComplexGaussian,
    ComplexQuartic,
    complex_names,
    get_complex,
)
from stochquant.actions.gauge import (  # noqa: F401
    GaugeAction,
    SU2Wilson,
    U1Wilson,
    gauge_names,
    get_gauge,
)
from stochquant.actions.gauge_complex import (  # noqa: F401
    ComplexSUNWilson,
    ComplexU1Wilson,
)

# potID ↔ name mapping of the reference CLI (tauhost.c:35, tau_kernel.cl:215-246
# for 0/3; taumain_windows.py:101-139 declare 1/2).
POT_ID_TO_NAME = {0: "harmonic", 1: "poeschl_teller", 2: "anharmonic", 3: "double_well"}
NAME_TO_POT_ID = {v: k for k, v in POT_ID_TO_NAME.items()}
