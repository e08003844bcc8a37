"""The skew recorder's guard (``ompi_tpu/skew/record.py``).

The flight recorder's exit feeds completed collectives to it and the
trace export's ``skew`` lane reads it; both pay one branch while it is
None. The recorder comes with ROADMAP item 10b.
"""

from __future__ import annotations

#: the live skew recorder (None: off)
SKEW = None
