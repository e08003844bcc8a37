"""Architecture descriptor (reference: opal/util/arch.c and
``ompi_tpu.core.arch``).

Every process publishes its byte order through the modex (ob1 does, at
enable). The port knows only its native order: the heterogeneous
conversion the reference's ``arch`` cvar forces (and ob1's byte swap,
ob1.py:283-286, :351, :704) waits with the datatype engine in ROADMAP
queue 1 item 4, so ob1 refuses a peer that advertises another order.
"""

from __future__ import annotations

import sys


def native() -> str:
    return sys.byteorder
