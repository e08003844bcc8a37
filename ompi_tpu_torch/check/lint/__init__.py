"""Static collective lint — the MUST-before-launch half of the
correctness plane, now a staged whole-program analysis engine.

The port's copy of ``ompi_tpu/check/lint``: the same passes, rules,
cache format and baselines, so one source gives the same findings
under either package (the rules read the port's own tables: its
``core/pvar.py`` and ``osc`` window producers).

Three passes over the linted tree:

1. **summarize** — parse every file, extract per-function effect
   summaries (:mod:`callgraph`): collective sequence, parameters
   consumed, returns-a-request. Cached per file by content hash.
2. **link** — fold the summaries into one :class:`callgraph.Project`
   (the interprocedural lookup surface, one level deep).
3. **check** — run the rule families (:mod:`rules`) per module over
   a :class:`~ompi_tpu_torch.check.lint.model.ModuleContext` carrying the
   AST, the parent map and the project; per-function CFGs
   (:mod:`cfg`) and the handle dataflow (:mod:`dataflow`) are built
   lazily underneath. Cached per file by (content hash, digest of
   the summaries of every callee the file references) — editing one
   module re-checks it and its name-dependents, nothing else.

A finding on a line whose *comment* (real comments only — tokenized,
so docstring mentions don't count) carries ``# check: disable=RULE``
(or ``disable=all``) is marked suppressed and does not fail the run;
a disable comment that suppresses nothing is itself a
``stale-suppression`` finding. ``parse-error`` findings are never
suppressible or baselineable — an unparseable file always fails the
gate. A findings **baseline** (:func:`load_baseline` /
:func:`write_baseline`) lets a new rule land strict: baselined
findings report but do not gate, and the baseline can only shrink.
"""

from __future__ import annotations

import ast
import hashlib
import io
import json
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ompi_tpu_torch.check.lint import callgraph
from ompi_tpu_torch.check.lint.model import Finding, ModuleContext, \
    build_parents
from ompi_tpu_torch.check.lint.rules import CATALOG, RULES

__all__ = ["CATALOG", "Finding", "lint_source", "lint_paths",
           "unsuppressed", "load_baseline", "write_baseline",
           "apply_baseline", "iter_py_files"]

#: engine version — part of every cache key, bump on rule changes
ENGINE_VERSION = "2"

_SUPPRESS_RE = re.compile(r"#\s*check:\s*disable=([A-Za-z0-9_,\- ]+)")


def _suppressions(comment: str) -> frozenset:
    m = _SUPPRESS_RE.search(comment)
    if not m:
        return frozenset()
    return frozenset(p.strip() for p in m.group(1).split(",") if p.strip())


def _comment_lines(src: str) -> Dict[int, str]:
    """line number -> comment text, from real COMMENT tokens only —
    a ``# check: disable`` inside a docstring is documentation, not a
    suppression."""
    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass    # unparseable file: parse-error carries the run
    return out


def _apply_suppressions(findings: List[Finding], src: str,
                        path: str) -> None:
    comments = _comment_lines(src)
    for f in findings:
        if f.rule == "parse-error":
            continue        # never suppressible
        dis = _suppressions(comments.get(f.line, ""))
        if f.rule in dis or "all" in dis:
            f.suppressed = True
    # stale-suppression: a disable comment that caught nothing
    for line, comment in sorted(comments.items()):
        dis = _suppressions(comment)
        if not dis:
            continue
        if any(f.suppressed and f.line == line for f in findings):
            continue
        stale = Finding(
            "stale-suppression", path, line,
            "# check: disable=" + ",".join(sorted(dis)) +
            " suppresses nothing on this line — remove it, or it "
            "will hide the rule when the code regresses")
        if "stale-suppression" in dis or "all" in dis:
            stale.suppressed = True
        findings.append(stale)


def _run_rules(tree: ast.AST, src: str, path: str,
               project) -> Tuple[List[Finding], Dict[str, int]]:
    parents = build_parents(tree)
    ctx = ModuleContext(tree, parents, path, project)
    findings: List[Finding] = []
    for rule in RULES:
        findings.extend(rule(ctx))
    _apply_suppressions(findings, src, path)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, ctx.stats


def lint_source(src: str, path: str = "<string>") -> List[Finding]:
    """Run every rule over one module's source; returns ALL findings
    with ``suppressed`` set where the flagged line disables the rule.
    The project is just this module, so same-module interprocedural
    effects still resolve."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as exc:
        return [Finding("parse-error", path, exc.lineno or 0,
                        f"syntax error: {exc.msg}")]
    project = callgraph.Project.from_summaries(
        callgraph.summarize_module(tree, path))
    findings, _ = _run_rules(tree, src, path, project)
    return findings


def iter_py_files(paths: Iterable[str],
                  exclude: Iterable[str] = ()) -> Iterable[str]:
    import fnmatch

    exclude = list(exclude)

    def excluded(p: str) -> bool:
        q = p.replace("\\", "/")
        return any(fnmatch.fnmatch(q, pat) or pat in q
                   for pat in exclude)

    for p in paths:
        if os.path.isfile(p):
            if not excluded(p):
                yield p
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__",))
                for fn in sorted(files):
                    full = os.path.join(root, fn)
                    if fn.endswith(".py") and not excluded(full):
                        yield full


# -- the incremental per-file cache --------------------------------------

def _sha(src: str) -> str:
    return hashlib.sha256(
        (ENGINE_VERSION + "\n" + src).encode()).hexdigest()


def _deps_digest(calls: List[str], project: callgraph.Project) -> str:
    """Digest of the summaries of every project function this file's
    calls can resolve to — the "did my callees change" key."""
    payload = []
    for name in calls:
        cands = project.by_name.get(name)
        if cands:
            payload.append((name, [c.to_dict() for c in cands]))
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()


def _load_cache(path: Optional[str]) -> Dict:
    if not path or not os.path.exists(path):
        return {"engine": ENGINE_VERSION, "files": {}}
    try:
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
        if data.get("engine") != ENGINE_VERSION:
            return {"engine": ENGINE_VERSION, "files": {}}
        return data
    except (OSError, ValueError):
        return {"engine": ENGINE_VERSION, "files": {}}


def _save_cache(path: Optional[str], cache: Dict) -> None:
    if not path:
        return
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(cache, fh)
    os.replace(tmp, path)


def lint_paths(paths: Iterable[str], cache: Optional[str] = None,
               stats: Optional[Dict[str, int]] = None,
               exclude: Iterable[str] = ()) -> List[Finding]:
    """Lint files/dirs with the staged engine. ``cache`` names a JSON
    cache file for incremental re-runs; ``stats`` (if given) is
    filled with files/cached/cfg_paths counters."""
    from ompi_tpu_torch.core import pvar

    st = stats if stats is not None else {}
    st.setdefault("files", 0)
    st.setdefault("cached", 0)
    st.setdefault("cfg_paths", 0)

    cache_data = _load_cache(cache)
    cached_files: Dict[str, Dict] = cache_data.get("files", {})
    new_files: Dict[str, Dict] = {}

    findings: List[Finding] = []
    sources: Dict[str, str] = {}
    trees: Dict[str, ast.AST] = {}
    summaries: List[callgraph.FuncSummary] = []
    per_file: List[Tuple[str, Optional[Dict]]] = []

    # pass 1: read + hash + (cached?) summarize
    for path in iter_py_files(paths, exclude):
        st["files"] += 1
        try:
            with open(path, encoding="utf-8") as fh:
                src = fh.read()
        except OSError as exc:
            findings.append(Finding("parse-error", path, 0,
                                    f"unreadable: {exc}"))
            per_file.append((path, None))
            continue
        sources[path] = src
        sha = _sha(src)
        entry = cached_files.get(path)
        if entry is not None and entry.get("sha") == sha:
            entry = dict(entry)
        else:
            try:
                tree = ast.parse(src, filename=path)
            except SyntaxError as exc:
                fnd = Finding("parse-error", path, exc.lineno or 0,
                              f"syntax error: {exc.msg}")
                entry = {"sha": sha, "summaries": [], "calls": [],
                         "findings": [fnd.to_dict()],
                         "deps": "parse-error"}
            else:
                trees[path] = tree
                entry = {
                    "sha": sha,
                    "summaries": [s.to_dict() for s in
                                  callgraph.summarize_module(tree,
                                                             path)],
                    "calls": callgraph.module_call_names(tree),
                    "findings": None,   # to be filled by pass 3
                    "deps": None,
                }
        new_files[path] = entry
        per_file.append((path, entry))
        summaries.extend(callgraph.FuncSummary.from_dict(d)
                         for d in entry["summaries"])

    # pass 2: link
    project = callgraph.Project.from_summaries(summaries)

    # pass 3: check (or reuse)
    for path, entry in per_file:
        if entry is None:
            continue
        if entry.get("deps") == "parse-error":
            findings.extend(Finding.from_dict(d)
                            for d in entry["findings"])
            continue
        deps = _deps_digest(entry["calls"], project)
        if entry.get("findings") is not None \
                and entry.get("deps") == deps:
            st["cached"] += 1
            findings.extend(Finding.from_dict(d)
                            for d in entry["findings"])
            continue
        tree = trees.get(path)
        if tree is None:
            src = sources.get(path)
            if src is None:
                continue
            try:
                tree = ast.parse(src, filename=path)
            except SyntaxError as exc:
                findings.append(
                    Finding("parse-error", path, exc.lineno or 0,
                            f"syntax error: {exc.msg}"))
                continue
        file_findings, fstats = _run_rules(
            tree, sources[path], path, project)
        st["cfg_paths"] += fstats.get("cfg_paths", 0)
        entry["findings"] = [f.to_dict() for f in file_findings]
        entry["deps"] = deps
        findings.extend(file_findings)

    cache_data["files"] = new_files
    _save_cache(cache, cache_data)

    pvar.record("check_lint_files", st["files"])
    pvar.record("check_lint_cached_files", st["cached"])
    pvar.record("check_lint_cfg_paths", st["cfg_paths"])
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


# -- baseline ------------------------------------------------------------

def _baseline_key(f: Finding) -> Tuple[str, str, str]:
    return (f.rule, f.path.replace("\\", "/"), f.message)


def load_baseline(path: str) -> Set[Tuple[str, str, str]]:
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    return {(d["rule"], d["path"], d["message"])
            for d in data.get("findings", ())}


def write_baseline(findings: Iterable[Finding], path: str) -> int:
    """Persist the current unsuppressed, non-parse-error findings as
    accepted debt; returns the count written."""
    keep = [f for f in findings
            if not f.suppressed and f.rule != "parse-error"]
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"engine": ENGINE_VERSION,
                   "findings": [{"rule": f.rule,
                                 "path": f.path.replace("\\", "/"),
                                 "line": f.line,
                                 "message": f.message}
                                for f in keep]},
                  fh, indent=1)
    return len(keep)


def apply_baseline(findings: Iterable[Finding],
                   keys: Set[Tuple[str, str, str]]) -> int:
    """Mark findings matching the baseline; parse-error never
    baselines. Returns how many matched."""
    n = 0
    for f in findings:
        if f.rule == "parse-error" or f.suppressed:
            continue
        if _baseline_key(f) in keys:
            f.baselined = True
            n += 1
    return n


def unsuppressed(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings
            if not f.suppressed and not f.baselined]
