"""Compatibility shim — memchecker lives in the correctness plane.

The port's copy of ``ompi_tpu/core/memchecker.py``: the
buffer-definedness shadow tracker is
:mod:`ompi_tpu_torch.check.memchecker` (the reference's
opal/mca/memchecker is a correctness tool, not core infrastructure), and
this module re-exports its surface so ``from ompi_tpu_torch.core import
memchecker`` works as it does in the JAX package. State is shared: every
function closes over the check-plane module's shadow map.
"""

from ompi_tpu_torch.check.memchecker import (  # noqa: F401
    MemcheckError, check_defined, enabled, mark_defined,
    mark_undefined, reset_for_testing,
)
