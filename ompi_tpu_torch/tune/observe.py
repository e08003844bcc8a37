"""The tune observatory's guard and the switchpoint-table error surfacing
(``ompi_tpu/tune/observe.py:144``, ``:169-182``).

:data:`OBSERVER` is the reference's process-wide guard: None (the
observatory comes with ROADMAP item 10b), so every hook pays one branch.
:func:`table_error` is what coll/cuda's and coll/hier's switchpoint
readers call when a table file does not load: the reader then goes on
with the built-in thresholds, as the reference's do.

It also emits the MPI_T event ``tune_table_error`` (``:49``,
``:180-181``) when a tool listens.
"""

from __future__ import annotations

from ompi_tpu_torch.core import events, output, pvar

_out = output.stream("tune")

TUNE_TABLE_ERROR = events.register_type(
    "tune_table_error",
    "a switchpoint-table cvar points at a malformed/unreadable file",
    ("cvar", "path", "error"))

#: the live observer (None: off). A live one has ``timed(component, op,
#: provider, comm, nbytes, dtype, launcher, mesh=) -> launcher``.
OBSERVER = None

_warned_tables: set = set()


def table_error(var_name: str, path: str, exc: BaseException) -> None:
    """A switchpoint-table file failed to load: count it
    (``tune_table_errors``, every attempt), warn once per path, and emit
    the ``tune_table_error`` MPI_T event for listening tools."""
    pvar.record("tune_table_errors")
    if path not in _warned_tables:
        _warned_tables.add(path)
        _out.verbose(0, "WARNING: %s %s unreadable (%s) — falling "
                        "back to built-in thresholds; fix the path "
                        "or the JSON (tune_table_errors counts every "
                        "load attempt)", var_name, path, exc)
    if events.active("tune_table_error"):
        events.emit("tune_table_error", cvar=var_name, path=path,
                    error=repr(exc))
