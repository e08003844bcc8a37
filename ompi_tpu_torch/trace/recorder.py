"""The span-recorder guard (``ompi_tpu/trace/recorder.py:54-60``).

Instrumented sites do ``if recorder.RECORDER is not None: ...``: a
module attribute load and one branch, nothing built on the None path.
The recorder comes with ROADMAP item 10; coll/hier's launch funnel reads
the guard already.
"""

from __future__ import annotations

import time

#: the live recorder (None: off). A live one has ``record(name, subsys,
#: t0_ns, t1_ns, args)``.
RECORDER = None


def now() -> int:
    """The span clock: monotonic nanoseconds."""
    return time.monotonic_ns()
