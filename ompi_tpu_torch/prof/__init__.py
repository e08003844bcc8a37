"""ompi_tpu_torch.prof — wall-clock attribution profiler.

The port's copy of ``ompi_tpu.prof``: answers "where did the wall go".
Three sub-planes, all riding the existing substrate:

- the **phase ledger** (:mod:`ompi_tpu_torch.prof.ledger`): ``staging``
  / ``compile`` / ``train`` / ``teardown`` phases as nestable spans +
  ``prof_phase_*_ns`` pvars;
- **transfer instrumentation**: h2d/d2h copy spans with bytes,
  bandwidth gauges and log2 size/latency histograms, emitted by the
  accelerator's copy sites (``accelerator/cuda.py``) and coll/device's
  staging of a host operand;
- **compile observability** and the ``python -m ompi_tpu_torch.prof``
  attribution CLI.

What a "compile" is in the port (a stated difference, ROADMAP queue 3):
the port compiles nothing with XLA. ``prof_compile_{misses,ns}`` count
the port's counterparts of building a compiled program — a per-comm
arena planned and mapped for a new size class (``coll/cuda._arena``,
which coll/device's schedules and coll/cuda's rings ride, as coll/xla's
``_Ctx.plan`` / ``compiled`` are per-comm caches) and a kernel library's
first load or ``nvcc`` build (``cuda_kernels.lib()``, ``gemm_lib()``, the
osc kernels' ``lib()``) — and ``prof_compile_hits`` an arena reused.
jax's persistent compilation cache has no counterpart: its two cvars
are registered so the reference's ``--mca`` settings still parse, and
:func:`wire_compile_cache` returns None; ``prof_compile_cache_{hits,
misses}`` stay 0.

Enable with ``--mca prof_enable 1`` (or ``OMPI_TPU_PROF=1``); off by
default at the usual one-branch cost per instrumented site.
"""

from __future__ import annotations

from typing import Optional

from ompi_tpu_torch.core import cvar
from ompi_tpu_torch.prof.ledger import (  # noqa: F401  (public re-exports)
    PROFILER, Profiler, current_phase, disable, enable,
    overlap_seconds, phase, phase_seconds, requested,
)

_cache_dir_var = cvar.register(
    "compile_cache_dir", "", str,
    help="Directory for jax's persistent XLA compilation cache in the "
         "JAX package. The port compiles no XLA program: the setting is "
         "accepted and has no effect.",
    level=4)
_cache_min_var = cvar.register(
    "compile_cache_min_secs", -1.0, float,
    help="jax_persistent_cache_min_compile_time_secs in the JAX package; "
         "accepted and without effect in the port.",
    level=7)


def wire_compile_cache() -> Optional[str]:
    """The reference points jax's persistent compilation cache at
    ``compile_cache_dir`` (its runtime init calls this); the port has no
    XLA cache to point: always None."""
    return None
