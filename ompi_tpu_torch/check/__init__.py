"""check — the correctness plane (seventh plane).

The port's copy of ``ompi_tpu/check``. Reference: the compile-time
``MPI_PARAM_CHECK`` argument-validation path every ``ompi/mpi/c/*.c``
binding carries, the ``opal/mca/memchecker`` shadow-state framework,
and the MUST/Marmot class of MPI correctness tools layered over PMPI.
Two halves behind one CLI (``python -m ompi_tpu_torch.check``):

- :mod:`lint` — a static AST pass over user programs *and* this
  framework with MPI-aware rules (requests started but never waited,
  ``Pready`` outside a started partitioned region, collectives under
  rank-dependent branches, buffer reuse before Wait, leaked handles)
  plus repo-convention rules (bare ``ValueError``/``TypeError`` on
  public API paths, unregistered pvars, unguarded observability hot
  paths). Findings print as ``file:line: RULE message`` and suppress
  with ``# check: disable=RULE``.
- :mod:`sanitizer` — a runtime MPI sanitizer riding the PMPI
  interposition chain (:func:`ompi_tpu_torch.profile.attach_tool`):
  argument validation on every API entry, a request registry that
  reports leaks and use-after-free at Finalize, and (level 2)
  cross-rank collective signature matching through the kvstore so a
  mismatched collective raises a named :class:`MPIError` at the call
  instead of hanging until the watchdog fires.
- :mod:`memchecker` — buffer-definedness shadow tracking of host
  buffers (``core/memchecker`` re-exports it); a tensor, on the CPU or
  the card, is never shadowed, as the JAX package never shadows a jax
  array.

Opt-in via the ``check_level`` cvar or the short ``OMPI_TPU_CHECK``
env knob (0=off, 1=param checks + request registry, 2=+signature
matching); disabled, instrumented sites pay one attribute load and
one branch (``sanitizer.SANITIZER is None`` — the flight recorder's
guard discipline).
"""

from __future__ import annotations

import os

from ompi_tpu_torch.core import cvar

_level_var = cvar.register(
    "check_level", 0, int,
    help="Runtime MPI sanitizer level: 0 off (no interposition, "
         "one-branch guards compile to nothing), 1 validates "
         "arguments on every API entry and tracks request "
         "leaks/use-after-free, 2 adds cross-rank collective "
         "signature matching through the kvstore (a mismatched "
         "collective raises a named MPIError instead of hanging). "
         "Equivalently: OMPI_TPU_CHECK=<level>.",
    level=4, choices=[0, 1, 2])


def level() -> int:
    """Effective sanitizer level: cvar check_level (incl. the
    OMPI_TPU_CHECK_LEVEL env form) or the short OMPI_TPU_CHECK env
    knob (bare truthy values mean level 1)."""
    lv = _level_var.get()
    if lv:
        return int(lv)
    raw = os.environ.get("OMPI_TPU_CHECK", "").strip().lower()
    if raw in ("", "0", "false", "no", "off"):
        return 0
    try:
        return max(0, min(2, int(raw)))
    except ValueError:
        return 1


def requested() -> bool:
    return level() > 0


def start(rank: int = 0) -> None:
    """Bring the sanitizer up (idempotent); called by the instance
    init engine (runtime.state.init_instance) when requested()."""
    from ompi_tpu_torch.check import sanitizer

    sanitizer.enable(rank=rank, level=level())


def stop() -> None:
    from ompi_tpu_torch.check import sanitizer

    sanitizer.disable()


def get_sanitizer():
    from ompi_tpu_torch.check import sanitizer

    san = sanitizer.SANITIZER
    if san is None:
        return None
    return san
