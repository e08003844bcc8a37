"""The flight-recorder guard (``ompi_tpu/telemetry/flight.py:36``).

The reference's watchdog records each in-flight collective here
(``enter`` before the launch, ``exit`` after) so a hang dump can name
it. The recorder comes with ROADMAP item 10; its call sites (coll/hier's
slots) read :data:`FLIGHT` and pay one branch while it is None.
"""

from __future__ import annotations

#: the live recorder (None: off). A live one has ``enter(op, comm_cid,
#: nbytes) -> token`` and ``exit(token)``.
FLIGHT = None
