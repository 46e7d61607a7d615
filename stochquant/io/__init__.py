"""I/O: full-state checkpoints (npz) and reference "%a" format interop."""

from stochquant.io import reference_fmt  # noqa: F401
from stochquant.io.checkpoint import (  # noqa: F401
    export_reference,
    import_reference,
    load,
    save,
)
