"""BTL — byte transfer layer (host transports).

The port's counterpart of ``ompi_tpu.btl`` (reference: opal/mca/btl/,
btl.h:1172-1240). Components, in priority order: ``self`` (loopback),
``sm`` (shared-memory rings) and ``tcp`` (sockets). Each delivers framed
active-message bytes to the PML callback, reliable and ordered per
(sender, receiver) direction. Importing the package registers the three
with the ``btl`` framework (``btl.base.framework``), which the Bml opens.
"""

from ompi_tpu_torch.btl.base import Bml, Btl, set_recv_callback  # noqa: F401
from ompi_tpu_torch.btl.self_btl import SelfBtl  # noqa: F401
from ompi_tpu_torch.btl.sm import SmBtl  # noqa: F401
from ompi_tpu_torch.btl.tcp import TcpBtl  # noqa: F401
