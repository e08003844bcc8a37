"""Architecture descriptor (reference: opal/util/arch.c and
``ompi_tpu.core.arch``).

Every process publishes its byte order through the modex (ob1 does, at
enable), and the convertor consults the peer's to decide the
heterogeneous conversion (opal_copy_functions_heterogeneous.c). The
descriptor is the byte order string; the ``arch`` cvar (the reference's
name, so ``OMPI_TPU_ARCH`` sets it in both packages) can force it for a
cross-endian test on one machine: the forced rank then byteswaps its
outgoing wire so that its advertisement is true.
"""

from __future__ import annotations

import sys

from ompi_tpu_torch.core import cvar

_arch_var = cvar.register(
    "arch", "auto", str,
    help="Advertised byte order: 'auto' (the machine's real order), or "
         "force 'little'/'big': a forced rank byteswaps its outgoing wire "
         "data to match, which runs the whole heterogeneous conversion "
         "path on one machine.",
    choices=["auto", "little", "big"], level=6)


def native() -> str:
    return sys.byteorder


def advertised() -> str:
    a = _arch_var.get()
    return native() if a == "auto" else a
