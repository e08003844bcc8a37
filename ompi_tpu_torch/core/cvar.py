"""Typed control-variable (cvar) system — the single config plane.

Reference: opal/mca/base/mca_base_var.c — every tunable registers a typed,
documented variable; sources layered defaults < param files < environment
(OMPI_MCA_*) < CLI. Ours uses the prefix ``OMPI_TPU_`` and param files
``./ompi_tpu-params.conf`` and ``~/.ompi_tpu/params.conf``.

The PyTorch port keeps its own copy of this module (it never imports the
JAX package), with the same prefix and files, so one environment
configures both packages alike.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

ENV_PREFIX = "OMPI_TPU_"
PARAM_FILES = (
    os.path.join(os.path.expanduser("~"), ".ompi_tpu", "params.conf"),
    "ompi_tpu-params.conf",
)

# Variable source precedence (reference: mca_base_var_source_t)
SOURCE_DEFAULT = 0
SOURCE_FILE = 1
SOURCE_ENV = 2
SOURCE_SET = 3  # programmatic / CLI override

_BOOL_TRUE = {"1", "true", "yes", "on", "enabled"}
_BOOL_FALSE = {"0", "false", "no", "off", "disabled"}


def _coerce(raw: Any, typ: type) -> Any:
    if typ is bool:
        if isinstance(raw, bool):
            return raw
        s = str(raw).strip().lower()
        if s in _BOOL_TRUE:
            return True
        if s in _BOOL_FALSE:
            return False
        raise ValueError(f"cannot parse bool from {raw!r}")
    if typ is int:
        return int(str(raw), 0)
    if typ is float:
        return float(raw)
    return str(raw)


@dataclass
class Var:
    """One registered control variable (reference: mca_base_var_t)."""

    name: str  # full dotted name, e.g. "btl_tcp_eager_limit"
    default: Any
    typ: type
    help: str = ""
    level: int = 9  # MPI_T-style verbosity level 1..9
    choices: Optional[List[Any]] = None
    _value: Any = None
    _source: int = SOURCE_DEFAULT

    def get(self) -> Any:
        return self._value

    def set(self, value: Any, source: int = SOURCE_SET) -> None:
        if source < self._source:
            return  # lower-precedence source never overrides
        value = _coerce(value, self.typ)
        if self.choices is not None and value not in self.choices:
            raise ValueError(
                f"cvar {self.name}: {value!r} not in {self.choices!r}")
        self._value = value
        self._source = source


class _Registry:
    def __init__(self) -> None:
        self._vars: Dict[str, Var] = {}
        self._lock = threading.Lock()
        self._file_params: Optional[Dict[str, str]] = None

    def _load_files(self) -> Dict[str, str]:
        if self._file_params is None:
            params: Dict[str, str] = {}
            for path in PARAM_FILES:
                try:
                    with open(path) as fh:
                        for line in fh:
                            line = line.strip()
                            if not line or line.startswith("#"):
                                continue
                            if "=" in line:
                                k, _, v = line.partition("=")
                                params[k.strip()] = v.strip()
                except OSError:
                    continue
            self._file_params = params
        return self._file_params

    def register(self, name: str, default: Any, typ: Optional[type] = None,
                 help: str = "", level: int = 9,
                 choices: Optional[List[Any]] = None) -> Var:
        """Register (or re-fetch) a cvar and resolve its layered value."""
        with self._lock:
            if name in self._vars:
                return self._vars[name]
            if typ is None:
                typ = type(default)
            var = Var(name=name, default=default, typ=typ, help=help,
                      level=level, choices=choices)
            var._value = default
            # layered resolution: file < env  (SET comes later, at runtime)
            fileval = self._load_files().get(name)
            if fileval is not None:
                var.set(fileval, SOURCE_FILE)
            envval = os.environ.get(ENV_PREFIX + name.upper())
            if envval is None:
                envval = os.environ.get(ENV_PREFIX + name)
            if envval is not None:
                var.set(envval, SOURCE_ENV)
            self._vars[name] = var
            return var

    def lookup(self, name: str) -> Optional[Var]:
        return self._vars.get(name)

    def get(self, name: str, default: Any = None) -> Any:
        var = self._vars.get(name)
        return var.get() if var is not None else default

    def set(self, name: str, value: Any) -> None:
        var = self._vars.get(name)
        if var is None:
            raise KeyError(f"unknown cvar {name}")
        var.set(value, SOURCE_SET)

    def all_vars(self) -> Dict[str, Var]:
        return dict(self._vars)


_registry = _Registry()

register = _registry.register
lookup = _registry.lookup
get = _registry.get
set = _registry.set
all_vars = _registry.all_vars
