"""MCA-style framework / component registry with priority selection.

The port's copy of ``ompi_tpu.core.registry`` (reference: opal/mca/base —
the register -> open -> select -> close lifecycle,
mca_base_framework.h:173-226, include / exclude selection lists,
mca_base_components_select.c, and priority-based querying). Components
are Python classes registered under a framework name; the include /
exclude list is the cvar named after the framework (``--mca btl
self,tcp``, ``OMPI_TPU_BTL=^sm``): entries prefixed with ``^`` exclude,
and a list may not mix the two.

The port's three selection points stand on it: ``btl`` (the BML's
transports), ``accelerator`` (``cuda`` over ``null``) and ``coll`` (the
components :func:`ompi_tpu_torch.coll.comm_select` stacks).

Where the port differs: a component whose ``open()`` raises is logged
and skipped as in the reference, and its exception is kept in
:attr:`Framework.failures`, so a selection point can refuse to go on
without it (the accelerator framework raises when the ``cuda`` component
failed to open on the ``cuda`` platform rather than serving ``null``).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Type

from ompi_tpu_torch.core import cvar, output


class Component:
    """Base class of every component (reference: mca_base_component_t).

    Subclasses set ``NAME`` and ``PRIORITY`` and may override the
    lifecycle hooks. ``open()`` returning False disqualifies the
    component (reference: a query returning priority < 0,
    coll_base_comm_select.c:456-471).
    """

    NAME: str = "base"
    PRIORITY: int = 0

    def open(self) -> bool:  # component-wide init; False = unavailable
        return True

    def close(self) -> None:
        pass


class Framework:
    """One MCA framework: a named slot holding competing components."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._components: Dict[str, Type[Component]] = {}
        self._opened: Optional[List[Component]] = None
        self._lock = threading.Lock()
        #: component name -> the exception its open() raised (last open)
        self.failures: Dict[str, BaseException] = {}
        self.out = output.stream(name)
        cvar.register(
            name, "", str,
            help=f"Comma list of {name} components to include "
                 f"(prefix ^ to exclude)", level=2)

    def register(self, cls: Type[Component]) -> Type[Component]:
        self._components[cls.NAME] = cls
        return cls

    def component(self, name: str) -> Optional[Type[Component]]:
        return self._components.get(name)

    def names(self) -> List[str]:
        return sorted(self._components)

    def _filtered(self) -> List[Type[Component]]:
        spec = (cvar.get(self.name, "") or "").strip()
        comps = list(self._components.values())
        if not spec:
            return comps
        entries = [e.strip() for e in spec.split(",") if e.strip()]
        excludes = {e[1:] for e in entries if e.startswith("^")}
        includes = [e for e in entries if not e.startswith("^")]
        if includes and excludes:
            raise ValueError(
                f"framework {self.name}: cannot mix include and exclude "
                f"entries in '{spec}' (reference semantics)")
        if includes:
            return [self._components[n] for n in includes
                    if n in self._components]
        return [c for c in comps if c.NAME not in excludes]

    def open_components(self, **kwargs: Any) -> List[Component]:
        """Open every selectable component, highest priority first."""
        with self._lock:
            if self._opened is not None:
                return self._opened
            self.failures = {}
            opened: List[Component] = []
            for cls in self._filtered():
                try:
                    comp = cls(**kwargs) if kwargs else cls()
                    ok = comp.open()
                except Exception as exc:  # unusable component: skip, log
                    self.failures[cls.NAME] = exc
                    self.out.verbose(
                        1, "component %s failed to open: %s", cls.NAME, exc)
                    continue
                if ok:
                    opened.append(comp)
                    self.out.verbose(
                        5, "opened component %s (priority %d)",
                        comp.NAME, comp.PRIORITY)
            opened.sort(key=lambda c: -c.PRIORITY)
            self._opened = opened
            return opened

    def select_one(self, **kwargs: Any) -> Component:
        """The single highest-priority usable component."""
        opened = self.open_components(**kwargs)
        if not opened:
            spec = cvar.get(self.name, "")
            output.show_help("no-component", self.name, spec or "(all)",
                             ",".join(self.names()), self.name.upper())
            raise RuntimeError(f"no usable {self.name} component")
        return opened[0]

    def close_components(self) -> None:
        with self._lock:
            if self._opened:
                for comp in self._opened:
                    try:
                        comp.close()
                    except Exception:  # noqa: BLE001 — close never raises
                        pass
            self._opened = None


_frameworks: Dict[str, Framework] = {}
_fw_lock = threading.Lock()


def framework(name: str) -> Framework:
    with _fw_lock:
        fw = _frameworks.get(name)
        if fw is None:
            fw = Framework(name)
            _frameworks[name] = fw
        return fw


def all_frameworks() -> Dict[str, Framework]:
    return dict(_frameworks)


def close_all() -> None:
    for fw in list(_frameworks.values()):
        fw.close_components()
