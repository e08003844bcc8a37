"""The port stands alone: no module of ``ompi_tpu_torch`` (nor
``chip_smoke.py``) imports jax or the JAX package ``ompi_tpu``, and
importing the port leaves jax out of ``sys.modules``."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "ompi_tpu_torch")):
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "ompi_tpu")


def test_port_has_modules():
    files = _port_files()
    assert len(files) > 15, files


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and _forbidden(str(node.args[0].value))):
            bad.append(node.args[0].value)
    assert not bad, f"{path} imports {bad}"


def _runtime_files():
    d = os.path.join(ROOT, "ompi_tpu_torch", "runtime")
    return sorted(os.path.join(d, n) for n in os.listdir(d)
                  if n.endswith(".py"))


@pytest.mark.parametrize("path", _runtime_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_runtime_never_imports_coll(path):
    """The runtime layer sits below the collectives: the arenas, hop
    counters and kernel library belong to coll/cuda, not to the device
    plane."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names
                    if a.name.startswith("ompi_tpu_torch.coll")]
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod.startswith("ompi_tpu_torch.coll") or (
                    mod == "ompi_tpu_torch"
                    and any(a.name == "coll" for a in node.names)):
                bad.append(mod)
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, ompi_tpu_torch, ompi_tpu_torch.mpi, "
            "ompi_tpu_torch.compat, ompi_tpu_torch.coll.cuda, "
            "ompi_tpu_torch.runtime.launcher, ompi_tpu_torch.zero, "
            "ompi_tpu_torch.coll.device, "
            "ompi_tpu_torch.examples.device_collectives, "
            "ompi_tpu_torch.examples.zero_training, ompi_tpu_torch.osc, "
            "ompi_tpu_torch.osc.cuda, ompi_tpu_torch.coll.basic, "
            "ompi_tpu_torch.examples.halo_exchange, "
            "ompi_tpu_torch.examples.embedding_table, "
            "ompi_tpu_torch.btl, ompi_tpu_torch.btl.sm, "
            "ompi_tpu_torch.btl.tcp, ompi_tpu_torch.pml.ob1, "
            "ompi_tpu_torch.pml.accel_p2p, "
            "ompi_tpu_torch.datatype, ompi_tpu_torch.smsc, "
            "ompi_tpu_torch.info, ompi_tpu_torch.attr, "
            "ompi_tpu_torch.util.net, ompi_tpu_torch.core.native, "
            "ompi_tpu_torch.examples.p2p_bandwidth; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ompi_tpu')]; "
            "assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_host_plane_modules_are_scanned():
    """The host plane's modules are in the scan above."""
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in ("btl/base.py", "btl/self_btl.py", "btl/sm.py", "btl/tcp.py",
                "pml/ob1.py", "pml/accel_p2p.py", "pml/request.py",
                "datatype/convertor.py", "smsc.py", "info.py", "attr.py",
                "util/net.py", "core/progress.py", "core/native.py"):
        assert os.path.join("ompi_tpu_torch", mod) in rel, mod


def test_sm_ring_code_is_the_ports_own():
    """btl/sm's C ring is built from the port's own source under
    ``btl/csrc/``, never from a path into the repo's root ``csrc/``."""
    from ompi_tpu_torch.core import native

    src = os.path.relpath(native.SRC, ROOT)
    assert src == os.path.join("ompi_tpu_torch", "btl", "csrc", "sm_ring.c")
    with open(native.SRC, encoding="utf-8") as f:
        code = f.read()
    for sym in ("otr_ring_push", "otr_ring_pop", "otr_ring_readable"):
        assert sym in code, sym
    for path in _port_files():
        with open(path, encoding="utf-8") as f:
            assert "ompitpu_core" not in f.read(), path
