"""Verbosity streams and show_help — framework-scoped diagnostics.

Reference: opal/util/output.c (per-framework opal_output streams with MCA
verbosity cvars like ``coll_base_verbose``) and opal/util/show_help.c
(templated user-facing error messages; ``ompi_tpu/core/output.py:71``).
:func:`show_help` renders this module's topics through
:mod:`ompi_tpu_torch.util.show_help`, once per topic in a process.
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

    def error(self, msg: str, *args) -> None:
        if args:
            msg = msg % args
        sys.stderr.write(f"[{os.getpid()}] {self.framework} ERROR: {msg}\n")


def stream(framework: str) -> Stream:
    with _lock:
        st = _streams.get(framework)
        if st is None:
            st = Stream(framework)
            _streams[framework] = st
        return st



_HELP = {
    "no-component": (
        "No usable component found for framework '%s'.\n"
        "Requested: %s. Available: %s.\n"
        "Check the OMPI_TPU_%s environment variable."),
}


def show_help(topic: str, *args) -> str:
    """Render a templated help message (reference: opal_show_help) and
    print it to stderr the first time ``topic`` is shown in this
    process; returns the text either way."""
    from ompi_tpu_torch.util import show_help as _sh

    tmpl = _HELP.get(topic)
    if tmpl is None:
        msg = f"unknown help topic {topic!r} (args: {args!r})"
    else:
        msg = tmpl % args if args else tmpl
    _sh.add_topic("output", {topic: msg.replace("%", "%%")})
    _sh.show("output", topic)
    return _sh.render("output", topic)
