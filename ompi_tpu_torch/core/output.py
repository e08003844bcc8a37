"""Verbosity streams — framework-scoped diagnostics.

Reference: opal/util/output.c (per-framework opal_output streams with MCA
verbosity cvars like ``coll_base_verbose``).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict

from ompi_tpu_torch.core import cvar

_streams: Dict[str, "Stream"] = {}
_lock = threading.Lock()


class Stream:
    def __init__(self, framework: str) -> None:
        self.framework = framework
        self.var = cvar.register(
            f"{framework}_verbose", 0, int,
            help=f"Verbosity level for the {framework} framework (0..100)",
            level=8)

    @property
    def level(self) -> int:
        return self.var.get()

    def verbose(self, level: int, msg: str, *args) -> None:
        if self.level >= level:
            if args:
                msg = msg % args
            pid = os.getpid()
            ts = time.strftime("%H:%M:%S")
            sys.stderr.write(f"[{ts}:{pid}] {self.framework}: {msg}\n")


def stream(framework: str) -> Stream:
    with _lock:
        st = _streams.get(framework)
        if st is None:
            st = Stream(framework)
            _streams[framework] = st
        return st

