"""Observables: exact Gaussian answers, streaming estimators, and
autocorrelation-aware statistical analysis."""

from stochquant.observables.gauge_loops import (  # noqa: F401
    creutz_ratio,
    polyakov_loop,
    wilson_flow,
    wilson_loop,
    wilson_loop_table,
)
from stochquant.observables.exact import (  # noqa: F401
    em_stationary_cov,
    free_field_x2,
    harmonic_drift_matrix,
    harmonic_x2_continuum,
    target_cov,
)
