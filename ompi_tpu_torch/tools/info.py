"""ompi_info equivalent — dump frameworks, components, cvars, pvars.

The port's copy of ``ompi_tpu/tools/info.py`` (reference:
opal/runtime/opal_info_support.c + ompi/tools/ompi_info) —
enumerates every framework's components and every registered MCA
variable with type/default/current/source, gated by verbosity level
(ompi_info -a / --level).

Usage:
    python -m ompi_tpu_torch.tools.info              # components + level<=3 vars
    python -m ompi_tpu_torch.tools.info -a           # everything incl. pvars
    python -m ompi_tpu_torch.tools.info --level 9
    python -m ompi_tpu_torch.tools.info --param coll # one framework's vars
    python -m ompi_tpu_torch.tools.info --json
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

from ompi_tpu_torch.core import cvar, pvar, registry

_SOURCES = {0: "default", 1: "file", 2: "env", 3: "set"}


#: modules never imported by the dump: heavy (the models), side-effectful
#: (launcher forks, __main__ runs CLIs, the examples run jobs), or
#: meaningless without a live job
_DISCOVERY_DENYLIST = (
    "ompi_tpu_torch.models", "ompi_tpu_torch.ops",
    "ompi_tpu_torch.parallel", "ompi_tpu_torch.examples",
    "ompi_tpu_torch.runtime.launcher", "ompi_tpu_torch.tools",
)


def _import_component_universe() -> None:
    """Import every ompi_tpu_torch module so each component/cvar
    registration runs and the dump is complete, without bringing up
    the runtime (no rte/store init — like ompi_info, which opens
    frameworks without calling MPI_Init). Auto-discovered via
    pkgutil.iter_modules with *manual* recursion: walk_packages would
    itself import every package — including denylisted ones — just to
    recurse into it; iter_modules only reads directory listings, so
    denylisted subtrees are pruned before any import runs. Per-module
    failures warn and continue."""
    import importlib
    import pkgutil

    import ompi_tpu_torch

    stack = [("ompi_tpu_torch.", list(ompi_tpu_torch.__path__))]
    while stack:
        prefix, paths = stack.pop()
        for info in pkgutil.iter_modules(paths, prefix):
            mod = info.name
            if mod.startswith(_DISCOVERY_DENYLIST) \
                    or mod.rsplit(".", 1)[-1] == "__main__":
                continue
            try:
                imported = importlib.import_module(mod)
            except Exception as exc:  # noqa: BLE001 — a broken module
                print(f"# warning: {mod} failed to import: {exc}",
                      file=sys.stderr)  # must not hide the whole dump
                continue
            if info.ispkg:
                stack.append((mod + ".", list(imported.__path__)))


def collect(level: int = 3,
            param: Optional[str] = None,
            include_pvars: bool = False) -> Dict:
    """Build the info tree (frameworks/components, cvars, pvars)."""
    _import_component_universe()
    out: Dict = {"frameworks": {}, "cvars": {}, "pvars": {}}
    for fw_name, fw in sorted(registry.all_frameworks().items()):
        out["frameworks"][fw_name] = fw.names()
    for name, var in sorted(cvar.all_vars().items()):
        if var.level > level:
            continue
        if param is not None and not name.startswith(param):
            continue
        out["cvars"][name] = {
            "value": var.get(),
            "default": var.default,
            "type": var.typ.__name__,
            "source": _SOURCES.get(var._source, "?"),
            "level": var.level,
            "help": var.help,
        }
        if var.choices is not None:
            out["cvars"][name]["choices"] = list(var.choices)
    if include_pvars:
        # seed with the well-known set so never-recorded counters
        # (e.g. the telemetry plane's, in a process that ran no job)
        # still list at 0 — ompi_info shows every pvar, not just the
        # ones that already ticked
        pvars = {k: 0 for k in pvar.WELL_KNOWN}
        pvars.update(pvar.snapshot())
        out["pvars"] = pvars
    from ompi_tpu_torch.core import events

    out["events"] = [events.get_info(i)
                     for i in range(events.get_num())]
    return out


def render(info: Dict, verbose_help: bool = False) -> List[str]:
    lines: List[str] = []
    lines.append("ompi_tpu_torch info")
    lines.append("=" * 60)
    lines.append("")
    lines.append("Frameworks and components:")
    for fw, comps in info["frameworks"].items():
        lines.append(f"  {fw:<14} {', '.join(comps) if comps else '(none)'}")
    lines.append("")
    lines.append(f"Control variables ({len(info['cvars'])}):")
    for name, v in info["cvars"].items():
        val = v["value"]
        mark = "" if v["source"] == "default" else f"  [{v['source']}]"
        lines.append(f"  {name:<34} {val!r:<14} "
                     f"(type {v['type']}, level {v['level']}){mark}")
        if verbose_help and v["help"]:
            lines.append(f"      {v['help']}")
    if info["pvars"]:
        lines.append("")
        lines.append(f"Performance variables ({len(info['pvars'])}):")
        for name, val in sorted(info["pvars"].items()):
            lines.append(f"  {name:<34} {val}")
    if info.get("events"):
        lines.append("")
        lines.append(f"Event types ({len(info['events'])}):")
        for ev in info["events"]:
            lines.append(f"  {ev['name']:<34} "
                         f"({', '.join(ev['fields'])})")
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ompi_tpu_torch.tools.info",
                                 description=__doc__)
    ap.add_argument("-a", "--all", action="store_true",
                    help="everything: level 9 + pvars + help text")
    ap.add_argument("--level", type=int, default=None,
                    help="max cvar verbosity level (1..9)")
    ap.add_argument("--param", default=None, metavar="PREFIX",
                    help="only cvars with this prefix (e.g. 'coll')")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ns = ap.parse_args(argv)
    level = ns.level if ns.level is not None else (9 if ns.all else 3)
    info = collect(level=level, param=ns.param, include_pvars=ns.all)
    if ns.as_json:
        print(json.dumps(info, indent=2, default=repr))
    else:
        print("\n".join(render(info, verbose_help=ns.all)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
