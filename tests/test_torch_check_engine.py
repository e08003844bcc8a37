"""The port's staged lint engine (``check/lint``: the CFGs, the path-aware
dataflow, the call graph, the deadlock detector, the incremental cache,
baselines, SARIF and the CLI's exit codes) against the JAX package's: the
counterparts of ``tests/test_check_engine.py``'s 43 cases.

Every case runs in this process on both packages: the same sources and
fixture trees go through both engines, and their results must be equal
as documents — findings as (rule, path, line, message, suppressed), CFG
paths as their blocks and decisions, taint maps, call-graph summaries,
the cache file and the baseline file byte for byte after JSON parsing,
and the SARIF document but for the tool's name. The CLI cases call both
packages' ``main`` in this process, and the port's ``python -m`` entry
point once.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

from ompi_tpu.check import lint as R_lint
from ompi_tpu.check.__main__ import main as R_main
from ompi_tpu.check.lint import callgraph as R_cg, cfg as R_cfg
from ompi_tpu.check.lint import dataflow as R_df, sarif as R_sarif
from ompi_tpu_torch.check import lint as P_lint
from ompi_tpu_torch.check.__main__ import main as P_main
from ompi_tpu_torch.check.lint import callgraph as P_cg, cfg as P_cfg
from ompi_tpu_torch.check.lint import dataflow as P_df, sarif as P_sarif
from ompi_tpu_torch.check.lint.model import (FREE_NAMES,
                                             REQUEST_CONSUMERS, Finding)
from tests.test_torch_mpit import reference_state  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: side -> (lint, cfg, dataflow, callgraph, sarif, CLI main)
SIDES = {"ref": (R_lint, R_cfg, R_df, R_cg, R_sarif, R_main),
         "port": (P_lint, P_cfg, P_df, P_cg, P_sarif, P_main)}


def both(fn):
    """fn(side modules...) on each package; the port's answer, after
    asserting the reference's is the same."""
    got = {side: fn(*mods) for side, mods in SIDES.items()}
    assert got["port"] == got["ref"], got
    return got["port"]


def _func(src):
    tree = ast.parse(textwrap.dedent(src))
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef))


def _keys(findings):
    return [(f.rule, f.path, f.line, f.message, f.suppressed, f.baselined)
            for f in findings]


def _lint(src, path="prog.py", rule=None):
    """Both packages' findings on one source (equal); the port's."""
    def run(lint, *_):
        fs = lint.lint_source(textwrap.dedent(src), path)
        return _keys([f for f in fs if rule is None or f.rule == rule])
    return [Finding(*k) for k in both(run)]


def _paths_doc(src, limit=None):
    """Both packages' CFG paths of one function, as documents."""
    def run(_l, cfg, *_):
        g = cfg.build_cfg(_func(src))
        ps = cfg.paths(g) if limit is None else cfg.paths(g, limit=limit)
        return {"exit": g.exit, "truncated": g.truncated,
                "paths": [[list(p.blocks), [list(d) for d in p.decisions],
                           [type(s).__name__ + str(s.lineno)
                            for s in g.stmt_seq(p)]] for p in ps]}
    return both(run)


# -- CFG construction -----------------------------------------------------

def test_cfg_if_else_shape():
    doc = _paths_doc("""
        def f(x):
            a = 1
            if x:
                b = 2
            else:
                b = 3
            return b
    """)
    assert len(doc["paths"]) == 2
    assert sorted(p[1][0][1] for p in doc["paths"]) == ["false", "true"]
    assert all(p[0][-1] == doc["exit"] for p in doc["paths"])


def test_cfg_loop_zero_or_once():
    doc = _paths_doc("""
        def f(xs):
            total = 0
            for x in xs:
                total += x
            return total
    """)
    assert len(doc["paths"]) == 2
    decs = sorted(tuple(lab for _, lab in p[1]) for p in doc["paths"])
    assert ("exit",) in decs and any("loop" in d for d in decs)


def test_cfg_while_break_reaches_after():
    doc = _paths_doc("""
        def f(x):
            while x:
                if x > 2:
                    break
                x -= 1
            return x
    """)
    assert doc["paths"] and all(p[0][-1] == doc["exit"]
                                for p in doc["paths"])


def test_cfg_try_finally_runs_on_both_paths():
    src = """
        def f(x):
            try:
                a = risky(x)
            except ValueError:
                a = None
            finally:
                done = True
            return a
    """
    doc = _paths_doc(src)
    ps = doc["paths"]
    # the finally stmt (line 8 of the source) appears on every path
    assert len(ps) >= 2 and all("Assign8" in p[2] for p in ps)
    assert any(any(lab == "except" for _, lab in p[1]) for p in ps)


def test_cfg_with_is_linear():
    doc = _paths_doc("""
        def f(path):
            with open(path) as fh:
                data = fh.read()
            return data
    """)
    assert len(doc["paths"]) == 1 and doc["paths"][0][1] == []


def test_cfg_early_return_paths():
    doc = _paths_doc("""
        def f(x):
            if x is None:
                return 0
            return x + 1
    """)
    assert len(doc["paths"]) == 2
    assert sum(s.startswith("Return") for p in doc["paths"]
               for s in p[2]) == 2


def test_cfg_path_limit_truncates():
    body = "\n".join(f"    if x{i}:\n        y = {i}" for i in range(10))
    src = ("def f(" + ", ".join(f"x{i}" for i in range(10)) + "):\n"
           + body + "\n    return y\n")
    doc = _paths_doc(src, limit=16)
    assert len(doc["paths"]) == 16 and doc["truncated"]


# -- path-aware dataflow: upgraded rule pairs -----------------------------

def test_unwaited_request_one_branch_only_positive():
    fs = _lint("""
        def f(comm, buf, fast):
            r = comm.isend(buf, dest=1)
            if fast:
                r.wait()
    """, rule="unwaited-request")
    assert len(fs) == 1
    assert "only some paths" in fs[0].message and "false" in fs[0].message


def test_unwaited_request_both_branches_negative():
    assert _lint("""
        def f(comm, buf, fast):
            r = comm.isend(buf, dest=1)
            if fast:
                r.wait()
            else:
                r.free()
    """, rule="unwaited-request") == []


def test_unwaited_request_container_alias_negative():
    assert _lint("""
        def f(comm, bufs):
            reqs = []
            for b in bufs:
                reqs.append(comm.isend(b, dest=1))
            wait_all(reqs)
    """, rule="unwaited-request") == []


def test_unwaited_request_container_never_used_positive():
    fs = _lint("""
        def f(comm, bufs):
            reqs = []
            for b in bufs:
                r = comm.isend(b, dest=1)
                reqs.append(r)
    """, rule="unwaited-request")
    assert len(fs) == 1


def test_buffer_reuse_before_wait_positive_and_negative():
    fs = _lint("""
        def f(comm, buf):
            r = comm.isend(buf, dest=1)
            buf[0] = 99
            r.wait()
    """, rule="buffer-reuse-before-wait")
    assert len(fs) == 1 and "'buf'" in fs[0].message
    assert _lint("""
        def f(comm, buf):
            r = comm.isend(buf, dest=1)
            r.wait()
            buf[0] = 99
    """, rule="buffer-reuse-before-wait") == []


def test_buffer_reuse_only_on_unwaited_path():
    fs = _lint("""
        def f(comm, buf, flag):
            r = comm.isend(buf, dest=1)
            if flag:
                buf[0] = 1
            r.wait()
    """, rule="buffer-reuse-before-wait")
    assert len(fs) == 1


def test_handle_leak_branch_positive_none_check_negative():
    fs = _lint("""
        def f(comm, flag):
            sub = comm.split(0, key=1)
            if flag:
                sub.free()
    """, rule="handle-leak")
    assert len(fs) == 1 and "only some paths" in fs[0].message
    assert _lint("""
        def f(comm):
            sub = comm.split(0, key=1)
            if sub is None:
                return None
            return sub
    """, rule="handle-leak") == []


def test_handle_leak_passed_on_negative():
    assert _lint("""
        def f(comm):
            sub = comm.split(0, key=1)
            register(sub)
    """, rule="handle-leak") == []


def test_branch_test_use_consumes():
    assert _lint("""
        def f(comm, buf):
            r = comm.isend(buf, dest=1)
            if r.test():
                return True
            return False
    """, rule="unwaited-request") == []


def test_creation_last_in_try_body_not_leaked_via_except():
    assert _lint("""
        def f(comm):
            try:
                sub = comm.split(0, key=1)
            except OSError:
                return None
            sub.free()
    """, rule="handle-leak") == []


def test_handle_tracker_consumes_the_same_uses():
    """The dataflow piece the rules sit on, called directly: the one load
    of the request (its wait) consumes it, in both packages."""
    src = """
        def f(comm, buf, fast):
            r = comm.isend(buf, dest=1)
            if fast:
                r.wait()
    """

    def run(_l, cfg, df, *_):
        fn = _func(src)
        parents = {c: n for n in ast.walk(fn)
                   for c in ast.iter_child_nodes(n)}
        tr = df.HandleTracker(fn, "r", REQUEST_CONSUMERS | FREE_NAMES,
                              project=None, parents=parents)
        uses = [tr._use_consumes(n) for n in ast.walk(fn)
                if isinstance(n, ast.Name) and n.id == "r"
                and isinstance(n.ctx, ast.Load)]
        return uses
    assert both(run) == [True]


# -- rank taint -----------------------------------------------------------

def test_rank_taint_chains_and_before_line():
    src = """
        def f(comm):
            rank = comm.rank
            me = rank
            if me == 0:
                pass
            late = comm.rank
    """

    def run(_l, _c, df, *_):
        fn = _func(src)
        norm = lambda t: {k: sorted(v) for k, v in t.items()}  # noqa: E731
        return norm(df.rank_taint(fn)), norm(df.rank_taint(fn,
                                                           before_line=5))
    taint, early = both(run)
    assert "comm" in taint.get("me", []) and "comm" in taint.get("late", [])
    assert "late" not in early and "comm" in early.get("me", [])


def test_rank_sources_direct_reads():
    src = """
        def f(comm):
            if comm.Get_rank() == 0:
                pass
    """

    def run(_l, _c, df, *_):
        test = next(n for n in ast.walk(_func(src))
                    if isinstance(n, ast.If)).test
        return sorted(df.rank_sources(test, {}))
    assert both(run) == ["comm"]


# -- the deadlock detector ------------------------------------------------

def test_divergence_true_positive_names_both_paths():
    fs = _lint("""
        def f(comm, x):
            if comm.rank == 0:
                comm.bcast(x)
    """, rule="collective-order-divergence")
    assert len(fs) == 1
    m = fs[0].message
    assert "true" in m and "false" in m and "bcast" in m and "deadlock" in m


def test_divergence_true_negative_symmetric_sequence():
    assert _lint("""
        def f(comm, x):
            if comm.rank == 0:
                payload = pack(x)
                comm.bcast(payload)
            else:
                comm.bcast(None)
    """, rule="collective-order-divergence") == []


def test_divergence_via_tainted_local():
    assert len(_lint("""
        def f(comm, x):
            me = comm.rank
            if me == 0:
                comm.barrier()
    """, rule="collective-order-divergence")) == 1


def test_divergence_not_attributed_to_later_branch():
    assert _lint("""
        def f(comm, x, flag):
            if comm.rank == 0:
                x = 1
            else:
                x = 2
            if flag:
                comm.bcast(x)
    """, rule="collective-order-divergence") == []


def test_divergence_cache_fill_idiom_negative():
    assert _lint("""
        def f(comm):
            adj = getattr(comm, "_cache", None)
            if adj is None:
                adj = comm.allgather(comm.rank)
                comm._cache = adj
            return adj
    """, rule="collective-order-divergence") == []


def test_divergence_other_comm_untouched():
    assert _lint("""
        def f(comm, other, x):
            if other.rank == 0:
                comm.bcast(x)
    """, rule="collective-order-divergence") == []


# -- interprocedural (two files through the project) ----------------------

def _write(tmp_path, name, src):
    p = tmp_path / name
    p.write_text(textwrap.dedent(src))
    return str(p)


def _lint_tree(paths, rule=None, **kw):
    """Both packages' lint_paths (equal findings); the port's keys."""
    def run(lint, *_):
        return _keys([f for f in lint.lint_paths(paths, **kw)
                      if rule is None or f.rule == rule])
    return both(run)


def test_interprocedural_helper_waits_request(tmp_path):
    _write(tmp_path, "helpers.py", """
        def finish(req):
            req.wait()
    """)
    _write(tmp_path, "caller.py", """
        from helpers import finish

        def f(comm, buf):
            r = comm.isend(buf, dest=1)
            finish(r)
    """)
    assert _lint_tree([str(tmp_path)], "unwaited-request") == []


def test_interprocedural_helper_ignores_request(tmp_path):
    _write(tmp_path, "helpers.py", """
        def peek(req):
            return req is not None
    """)
    _write(tmp_path, "caller.py", """
        from helpers import peek

        def f(comm, buf):
            r = comm.isend(buf, dest=1)
            peek(r)
    """)
    bad = _lint_tree([str(tmp_path)], "unwaited-request")
    assert len(bad) == 1 and "caller.py" in bad[0][1]


def test_interprocedural_returns_request(tmp_path):
    _write(tmp_path, "helpers.py", """
        def start_send(comm, buf):
            return comm.isend(buf, dest=1)
    """)
    _write(tmp_path, "caller.py", """
        from helpers import start_send

        def f(comm, buf):
            start_send(comm, buf)
    """)
    bad = [k for k in _lint_tree([str(tmp_path)], "unwaited-request")
           if "caller.py" in k[1]]
    assert len(bad) == 1 and "start_send" in bad[0][3]


def test_interprocedural_collective_effect(tmp_path):
    _write(tmp_path, "helpers.py", """
        def sync(comm):
            comm.barrier()
    """)
    _write(tmp_path, "caller.py", """
        from helpers import sync

        def f(comm):
            if comm.rank == 0:
                sync(comm)
    """)
    bad = _lint_tree([str(tmp_path)], "collective-order-divergence")
    assert len(bad) == 1 and "barrier" in bad[0][3]
    assert "caller.py" in bad[0][1]


def test_summary_roundtrip():
    src = textwrap.dedent("""
        class C:
            def send(self, comm, buf):
                return comm.isend(buf, dest=1)
    """)

    def run(_l, _c, _d, cg, *_):
        (s,) = cg.summarize_module(ast.parse(src), "m.py")
        again = cg.FuncSummary.from_dict(s.to_dict())
        assert again.to_dict() == s.to_dict()
        return s.to_dict()
    d = both(run)
    assert d["qual"] == "C.send" and d["is_method"] and d["returns_request"]


# -- cache / baseline / SARIF / suppression / CLI -------------------------

def test_cache_cold_then_warm(tmp_path):
    f = _write(tmp_path, "mod.py", """
        def f(comm, buf):
            r = comm.isend(buf, dest=1)
            r.wait()
    """)

    def run(lint, *_):
        cache = str(tmp_path / f"cache_{lint.__name__}.json")
        s1, s2 = {}, {}
        lint.lint_paths([f], cache=cache, stats=s1)
        lint.lint_paths([f], cache=cache, stats=s2)
        return s1, s2, json.load(open(cache))
    s1, s2, doc = both(run)
    assert s1["cached"] == 0 and s2["cached"] == s2["files"] == 1
    assert doc["engine"] == "2" and list(doc["files"]) == [f]


def test_cache_invalidated_by_callee_change(tmp_path):
    docs = {}
    for side, (lint, *_r) in SIDES.items():
        d = tmp_path / side
        d.mkdir()
        _write(d, "helpers.py", """
            def finish(req):
                req.wait()
        """)
        _write(d, "caller.py", """
            def f(comm, buf):
                r = comm.isend(buf, dest=1)
                finish(r)
        """)
        cache = str(d / "cache.json")
        fs = lint.lint_paths([str(d)], cache=cache)
        assert [f for f in fs if f.rule == "unwaited-request"] == []
        _write(d, "helpers.py", """
            def finish(req):
                return req is not None
        """)
        st = {}
        fs = lint.lint_paths([str(d)], cache=cache, stats=st)
        assert st["cached"] < st["files"]
        docs[side] = ([(f.rule, os.path.basename(f.path), f.line, f.message)
                       for f in fs if f.rule == "unwaited-request"], st)
    assert docs["port"] == docs["ref"]
    assert len(docs["port"][0]) == 1


def test_cache_engine_version_mismatch_discards(tmp_path):
    f = _write(tmp_path, "mod.py", "x = 1\n")

    def run(lint, *_):
        cache = str(tmp_path / f"cache_{lint.__name__}.json")
        lint.lint_paths([f], cache=cache)
        data = json.load(open(cache))
        data["engine"] = "stale"
        json.dump(data, open(cache, "w"))
        st = {}
        lint.lint_paths([f], cache=cache, stats=st)
        return st
    assert both(run)["cached"] == 0


def test_baseline_roundtrip(tmp_path):
    f = _write(tmp_path, "mod.py", """
        def f(comm, x):
            if comm.rank == 0:
                comm.bcast(x)
    """)

    def run(lint, *_):
        bl = str(tmp_path / f"bl_{lint.__name__}.json")
        fs = lint.lint_paths([f])
        n = lint.write_baseline(fs, bl)
        fs = lint.lint_paths([f])
        m = lint.apply_baseline(fs, lint.load_baseline(bl))
        assert lint.unsuppressed(fs) == [] and all(f.baselined for f in fs)
        return n, m, json.load(open(bl))
    n, m, doc = both(run)
    assert n == m == 1 and len(doc["findings"]) == 1


def test_baseline_never_absorbs_parse_error(tmp_path):
    f = _write(tmp_path, "mod.py", "def f(:\n")

    def run(lint, *_):
        bl = str(tmp_path / f"bl_{lint.__name__}.json")
        fs = lint.lint_paths([f])
        n = lint.write_baseline(fs, bl)
        fs = lint.lint_paths([f])
        m = lint.apply_baseline(fs, lint.load_baseline(bl))
        return n, m, _keys(lint.unsuppressed(fs))
    n, m, bad = both(run)
    assert n == m == 0 and len(bad) == 1


def test_stale_suppression_flagged_and_docstring_exempt():
    fs = _lint("""
        def f(x):
            return x  # check: disable=handle-leak
    """, rule="stale-suppression")
    assert len(fs) == 1 and "suppresses nothing" in fs[0].message
    assert _lint('''
        def f(x):
            """Docs mention # check: disable=handle-leak here."""
            return x
    ''', rule="stale-suppression") == []


def test_live_suppression_not_stale():
    fs = _lint("""
        def f(comm, buf):
            comm.isend(buf, dest=1)  # check: disable=unwaited-request
    """)
    assert [f for f in fs if not f.suppressed] == []
    assert any(f.rule == "unwaited-request" and f.suppressed for f in fs)
    assert not any(f.rule == "stale-suppression" for f in fs)


def _sarif_docs(paths):
    """Both packages' SARIF documents of one lint: equal but for the
    tool's name (each package's own); returns the port's."""
    docs = {}
    for side, (lint, _c, _d, _g, sarif, _m) in SIDES.items():
        docs[side] = sarif.to_sarif(lint.lint_paths(paths))
    names = [d["runs"][0]["tool"]["driver"].pop("name")
             for d in (docs["ref"], docs["port"])]
    assert names == ["ompi_tpu-check-lint", "ompi_tpu_torch-check-lint"]
    assert docs["port"] == docs["ref"]
    docs["port"]["runs"][0]["tool"]["driver"]["name"] = names[1]
    return docs["port"]


def test_sarif_export_shape(tmp_path):
    f = _write(tmp_path, "mod.py", """
        def f(comm, x):
            if comm.rank == 0:
                comm.bcast(x)
    """)
    doc = _sarif_docs([f])
    assert doc["version"] == "2.1.0" \
        and "sarif-schema-2.1.0" in doc["$schema"]
    run = doc["runs"][0]
    ids = [r["id"] for r in run["tool"]["driver"]["rules"]]
    assert ids == sorted(ids) and "collective-order-divergence" in ids
    (res,) = run["results"]
    assert res["level"] == "error"
    assert res["ruleIndex"] == ids.index(res["ruleId"])
    assert res["locations"][0]["physicalLocation"]["region"][
        "startLine"] >= 1
    out = tmp_path / "out.sarif"
    P_sarif.write_sarif(P_lint.lint_paths([f]), str(out))
    assert json.load(open(out))["version"] == "2.1.0"


def test_sarif_validates_against_schema(tmp_path):
    jsonschema = pytest.importorskip("jsonschema")
    f = _write(tmp_path, "mod.py", """
        def f(comm, buf):
            r = comm.isend(buf, dest=1)
            comm.isend(buf, dest=2)  # check: disable=unwaited-request
    """)
    doc = _sarif_docs([f])
    jsonschema.validate(doc, _SARIF_SCHEMA)
    res = doc["runs"][0]["results"]
    assert [r.get("suppressions") for r in res] \
        == [None, [{"kind": "inSource"}]]


#: the load-bearing subset of OASIS sarif-schema-2.1.0 the reference's
#: case validates against (required properties and the shapes code
#: scanning rejects on)
_SARIF_SCHEMA = {
    "type": "object",
    "required": ["version", "runs"],
    "properties": {
        "version": {"enum": ["2.1.0"]},
        "runs": {"type": "array", "minItems": 1, "items": {
            "type": "object",
            "required": ["tool"],
            "properties": {
                "tool": {"type": "object", "required": ["driver"],
                         "properties": {"driver": {
                             "type": "object", "required": ["name"],
                             "properties": {"rules": {
                                 "type": "array", "items": {
                                     "type": "object",
                                     "required": ["id"]}}}}}},
                "results": {"type": "array", "items": {
                    "type": "object",
                    "required": ["message"],
                    "properties": {
                        "message": {"type": "object",
                                    "required": ["text"]},
                        "level": {"enum": ["none", "note", "warning",
                                           "error"]},
                        "locations": {"type": "array", "items": {
                            "type": "object",
                            "properties": {"physicalLocation": {
                                "type": "object",
                                "properties": {"region": {
                                    "type": "object",
                                    "properties": {"startLine": {
                                        "type": "integer",
                                        "minimum": 1}}}}}}}},
                        "suppressions": {"type": "array", "items": {
                            "type": "object", "required": ["kind"],
                            "properties": {"kind": {
                                "enum": ["inSource", "external"]}}}},
                    },
                }},
            },
        }},
    },
}


def test_sarif_suppressed_findings_carried(tmp_path):
    f = _write(tmp_path, "mod.py", """
        def f(comm, buf):
            comm.isend(buf, dest=1)  # check: disable=unwaited-request
    """)
    (res,) = _sarif_docs([f])["runs"][0]["results"]
    assert res["level"] == "warning"
    assert res["suppressions"] == [{"kind": "inSource"}]


def _cli(tmp_path, capsys, monkeypatch, *args):
    """Both packages' CLI on the same arguments from ``tmp_path``: equal
    (exit code, stdout, stderr); the port's."""
    monkeypatch.chdir(tmp_path)

    def run(*mods):
        rc = mods[-1](list(args))
        out = capsys.readouterr()
        return rc, out.out, out.err
    return both(run)


def test_cli_parse_error_distinct_exit(tmp_path, capsys, monkeypatch):
    _write(tmp_path, "broken.py", "def f(:\n")
    rc, _out, err = _cli(tmp_path, capsys, monkeypatch, "lint", "broken.py")
    assert rc == 1
    assert "failed to parse" in err and "cannot be suppressed" in err
    _write(tmp_path, "ok.py", "x = 1\n")
    rc, _out, _err = _cli(tmp_path, capsys, monkeypatch, "lint", ".",
                          "--exclude", "broken.py")
    assert rc == 0


def test_cli_baseline_gate(tmp_path, capsys, monkeypatch):
    _write(tmp_path, "mod.py", """
        def f(comm, x):
            if comm.rank == 0:
                comm.bcast(x)
    """)
    assert _cli(tmp_path, capsys, monkeypatch, "lint", "mod.py")[0] == 1
    # writing does not forgive
    assert _cli(tmp_path, capsys, monkeypatch, "lint", "mod.py",
                "--write-baseline", "bl.json")[0] == 1
    rc, _out, err = _cli(tmp_path, capsys, monkeypatch, "lint", "mod.py",
                         "--baseline", "bl.json")
    assert rc == 0 and "1 baselined" in err


def test_cli_rules_catalog_lists_new_rules():
    r = subprocess.run([sys.executable, "-m", "ompi_tpu_torch.check",
                        "rules"], cwd=ROOT, capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 0
    for rule in ("collective-order-divergence", "stale-suppression",
                 "unwaited-request"):
        assert rule in r.stdout
    assert not any(ln.startswith("rank-divergent-collective")
                   for ln in r.stdout.splitlines())
    assert P_lint.CATALOG == R_lint.CATALOG
