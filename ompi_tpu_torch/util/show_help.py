"""show_help — tagged, templated user-facing diagnostics.

The port's copy of ``ompi_tpu.util.show_help`` (reference:
opal/util/show_help.c and the help-*.txt files): user-visible errors
are keyed by (topic, tag), rendered from templates with %-style
substitution, printed once per (topic, tag) in a process, and framed so
they stand out from debug noise. Topics are dicts registered by the
owning module; ``core/output.show_help`` renders the output streams'
and the registry's messages through this module.
"""

from __future__ import annotations

import sys
import threading
from typing import Dict, Set, Tuple

_topics: Dict[str, Dict[str, str]] = {}
_seen: Set[Tuple[str, str]] = set()
_lock = threading.Lock()

_FRAME = "-" * 64


def add_topic(topic: str, messages: Dict[str, str]) -> None:
    """Register a topic's tagged message templates."""
    with _lock:
        _topics.setdefault(topic, {}).update(messages)


def render(topic: str, tag: str, **subst) -> str:
    tpl = _topics.get(topic, {}).get(tag)
    if tpl is None:
        return (f"[{topic}:{tag}] (no help text registered) "
                f"args={subst!r}")
    try:
        body = tpl % subst if subst else tpl
    except (KeyError, ValueError):
        body = f"{tpl}\n(help substitution failed: {subst!r})"
    return f"{_FRAME}\n{body.rstrip()}\n{_FRAME}"


def show(topic: str, tag: str, once: bool = True, **subst) -> None:
    """Print a framed help message to stderr; ``once`` drops repeats of
    the same (topic, tag) in this process."""
    with _lock:
        if once and (topic, tag) in _seen:
            return
        _seen.add((topic, tag))
    print(render(topic, tag, **subst), file=sys.stderr)


def reset_for_testing() -> None:
    with _lock:
        _seen.clear()


# the runtime plane's topic (the reference's "ft" topic comes with the
# failure detector, ROADMAP queue 1 item 9)
add_topic("launcher", {
    "rank-died": (
        "A rank exited abnormally, so the launcher is terminating the\n"
        "whole job (mpirun behavior).\n"
        "  rank:   %(rank)s\n"
        "  cause:  %(cause)s"),
})
