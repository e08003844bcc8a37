"""The port lints clean: ``scripts/torch_lint_gate.sh``'s contract, held
in this process through the port's own CLI (``python -m
ompi_tpu_torch.check lint``'s ``main``).

A cold lint of ``ompi_tpu_torch`` with a cache and a SARIF export into
the case's directory exits 0 with no unsuppressed finding; the SARIF
document is 2.1.0 with the rule catalog and no result left unsuppressed;
a warm run against the same cache serves every file from it. No wall
time is asserted (the script holds its budget). Every suppression in the
port names its reason after its rules (``# check: disable=RULE; why``).
"""

import contextlib
import io
import json
import os
import re
import tokenize

import pytest

from ompi_tpu_torch.check.__main__ import main
from tests.test_torch_mpit import reference_state  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "ompi_tpu_torch")


@pytest.fixture(scope="module")
def cold(tmp_path_factory):
    """The cold run's (exit code, stdout, stderr, out dir)."""
    out = tmp_path_factory.mktemp("torch_lint_gate")
    so, se = io.StringIO(), io.StringIO()
    cwd = os.getcwd()
    os.chdir(ROOT)  # the paths as the gate names them
    try:
        with contextlib.redirect_stdout(so), \
                contextlib.redirect_stderr(se):
            rc = main(["lint", "ompi_tpu_torch", "--cache",
                       str(out / "lint_cache.json"), "--sarif",
                       str(out / "lint.sarif")])
    finally:
        os.chdir(cwd)
    return rc, so.getvalue(), se.getvalue(), out


def test_cold_lint_is_clean(cold):
    rc, stdout, stderr, _out = cold
    assert rc == 0, stdout[-4000:]
    m = re.search(r"check lint: (\d+) finding\(s\), (\d+) suppressed, "
                  r"(\d+) baselined; 0/(\d+) file\(s\) from cache", stderr)
    assert m, stderr
    assert m.group(1) == "0" and m.group(3) == "0"
    assert int(m.group(4)) > 150  # the whole port, not a corner of it


def test_sarif_has_no_unsuppressed_result(cold):
    doc = json.loads((cold[3] / "lint.sarif").read_text())
    assert doc["version"] == "2.1.0"
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "ompi_tpu_torch-check-lint"
    assert run["tool"]["driver"]["rules"]
    assert [r for r in run["results"] if not r.get("suppressions")] == []
    assert all(r["suppressions"] == [{"kind": "inSource"}]
               for r in run["results"])


def test_warm_run_serves_every_file_from_the_cache(cold, capsys,
                                                  monkeypatch):
    out = cold[3]
    monkeypatch.chdir(ROOT)
    assert main(["lint", "ompi_tpu_torch", "--cache",
                 str(out / "lint_cache.json")]) == 0
    err = capsys.readouterr().err
    m = re.search(r"(\d+)/(\d+) file\(s\) from cache", err)
    assert m, err
    assert int(m.group(2)) > 0 and m.group(1) == m.group(2)


def _disable_comments():
    for dirpath, _, names in os.walk(PORT):
        for name in names:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path, encoding="utf-8") as f:
                src = f.read()
            for tok in tokenize.generate_tokens(io.StringIO(src).readline):
                if tok.type == tokenize.COMMENT \
                        and "check: disable=" in tok.string:
                    yield os.path.relpath(path, ROOT), tok.start[0], \
                        tok.string


def test_every_suppression_names_its_reason():
    found = list(_disable_comments())
    assert len(found) >= 45
    for path, line, text in found:
        m = re.search(r"check:\s*disable=[A-Za-z0-9_,\- ]+;\s*(\S.*)$",
                      text)
        assert m, (path, line, text)
