"""MPI extensions — the mpiext pattern.

Reference: ompi/mpiext/ (compile-time API extensions, each a directory of
MPIX_* symbols: ftmpi (ULFM), cuda / rocm (MPIX_Query_cuda_support),
affinity, shortfloat) and the JAX package's ``ompi_tpu.ext``. Extensions
register their MPIX_* objects in :data:`REGISTRY`, and
``ompi_tpu_torch.ext.MPIX_*`` resolves through it, so user code probes a
capability as Open MPI's users probe MPIX_Query_cuda_support.

Built in:
  - cuda: ``MPIX_Query_cuda_support``, Open MPI's own name; the
    reference's ``MPIX_Query_tpu_support`` is its analog
    (``compat.ext_name`` maps one name to the other);
  - shortfloat: the ``MPIX_FLOAT16`` and ``MPIX_BFLOAT16`` datatypes;
  - ftmpi (ULFM, reference ``ext/__init__.py:67-75``):
    ``MPIX_Comm_revoke`` / ``shrink`` / ``agree`` / ``iagree`` /
    ``get_failed`` / ``ack_failed``, bound to :mod:`ompi_tpu_torch.ft`.
"""

from __future__ import annotations

from typing import Dict

REGISTRY: Dict[str, object] = {}

#: the ULFM extension's names
FTMPI_NAMES = ("MPIX_Comm_revoke", "MPIX_Comm_shrink", "MPIX_Comm_agree",
               "MPIX_Comm_iagree", "MPIX_Comm_get_failed",
               "MPIX_Comm_ack_failed")


def register(name: str, obj) -> None:
    """Extensions call this at import (each mpiext adds its MPIX_*
    prototypes to mpi-ext.h)."""
    REGISTRY[name] = obj


def available() -> list:
    return sorted(REGISTRY)


def __getattr__(name: str):
    if name in REGISTRY:
        return REGISTRY[name]
    raise AttributeError(
        f"no MPI extension provides {name!r}; available: {available()}")


def _query_cuda_support() -> bool:
    """MPIX_Query_cuda_support (ompi/mpiext/cuda): True when the cuda
    accelerator component is selected and sees a device. A failure of the
    device runtime is not caught: it raises, so no answer hides a card
    that is missing or broken."""
    from ompi_tpu_torch import accelerator

    accel = accelerator.current()
    return accel.NAME == "cuda" and accel.num_devices() > 0


register("MPIX_Query_cuda_support", _query_cuda_support)


def _ftmpi() -> None:
    from ompi_tpu_torch import ft

    register("MPIX_Comm_revoke", ft.revoke)
    register("MPIX_Comm_shrink", ft.shrink)
    register("MPIX_Comm_agree", ft.agree)
    register("MPIX_Comm_iagree", ft.iagree)
    register("MPIX_Comm_get_failed", ft.get_failed)
    register("MPIX_Comm_ack_failed", ft.ack_failed)


_ftmpi()


def _shortfloat() -> None:
    from ompi_tpu_torch.datatype import datatype as dt

    register("MPIX_FLOAT16", dt.FLOAT16)
    register("MPIX_BFLOAT16", dt.BFLOAT16)


_shortfloat()
