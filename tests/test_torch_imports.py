"""The port stands alone: no module of ``ompi_tpu_torch`` (nor
``chip_smoke.py``) imports jax, ``ml_dtypes`` or the JAX package
``ompi_tpu``, and importing the port leaves jax out of ``sys.modules``."""

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
    # ml_dtypes: the chip machine has none; bf16 and fp8 go through torch
    return top in ("jax", "jaxlib", "ompi_tpu", "ml_dtypes")


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
            "ompi_tpu_torch.datatype, ompi_tpu_torch.datatype.device, "
            "ompi_tpu_torch.examples.datatype_exchange, ompi_tpu_torch.smsc, "
            "ompi_tpu_torch.info, ompi_tpu_torch.attr, "
            "ompi_tpu_torch.util.net, ompi_tpu_torch.core.native, "
            "ompi_tpu_torch.examples.p2p_bandwidth, ompi_tpu_torch.part, "
            "ompi_tpu_torch.pml.part, ompi_tpu_torch.zero.zero3, "
            "ompi_tpu_torch.examples.partitioned_gradients, "
            "ompi_tpu_torch.examples.zero3_params, "
            "ompi_tpu_torch.parallel.hierarchical, ompi_tpu_torch.coll.hier, "
            "ompi_tpu_torch.coll.han, ompi_tpu_torch.monitoring.algo, "
            "ompi_tpu_torch.examples.hier_collectives, "
            "ompi_tpu_torch.examples.hier_dcn_compress, "
            "ompi_tpu_torch.serve, ompi_tpu_torch.monitoring.merge, "
            "ompi_tpu_torch.monitoring.report, "
            "ompi_tpu_torch.monitoring.__main__, ompi_tpu_torch.topo, "
            "ompi_tpu_torch.pml.monitoring, "
            "ompi_tpu_torch.examples.moe_serving, ompi_tpu_torch.mpit, "
            "ompi_tpu_torch.core.events, ompi_tpu_torch.core.registry, "
            "ompi_tpu_torch.core.hook, ompi_tpu_torch.util.show_help, "
            "ompi_tpu_torch.pml.peruse, ompi_tpu_torch.pml.custommatch, "
            "ompi_tpu_torch.pml.vprotocol, ompi_tpu_torch.tune.observe, "
            "ompi_tpu_torch.osc.device_epoch, ompi_tpu_torch.accelerator.cuda, "
            "ompi_tpu_torch.examples.tools_plane, ompi_tpu_torch.ext, "
            "ompi_tpu_torch.core.memhooks, ompi_tpu_torch.runtime.state, "
            "ompi_tpu_torch.examples.sessions, ompi_tpu_torch.topo.reorder, "
            "ompi_tpu_torch.coll.device_neighbor, ompi_tpu_torch.coll.inter, "
            "ompi_tpu_torch.comm.intercomm, ompi_tpu_torch.dpm, "
            "ompi_tpu_torch.profile, ompi_tpu_torch.examples.neighbor_halo, "
            "ompi_tpu_torch.ft, ompi_tpu_torch.ft.detector, "
            "ompi_tpu_torch.elastic, ompi_tpu_torch.elastic.context, "
            "ompi_tpu_torch.elastic.reshard, ompi_tpu_torch.elastic.inject, "
            "ompi_tpu_torch.ingest, ompi_tpu_torch.ingest.engine, "
            "ompi_tpu_torch.ingest.plan, "
            "ompi_tpu_torch.examples.streaming_ingest, "
            "ompi_tpu_torch.examples.elastic_training, "
            "ompi_tpu_torch.trace, ompi_tpu_torch.trace.__main__, "
            "ompi_tpu_torch.telemetry, ompi_tpu_torch.telemetry.sampler, "
            "ompi_tpu_torch.telemetry.watchdog, "
            "ompi_tpu_torch.telemetry.openmetrics, ompi_tpu_torch.prof, "
            "ompi_tpu_torch.prof.__main__, ompi_tpu_torch.skew.record, "
            "ompi_tpu_torch.examples.fused_gradients, "
            "ompi_tpu_torch.examples.observability, "
            "ompi_tpu_torch.util.topology, ompi_tpu_torch.runtime.launcher, "
            "ompi_tpu_torch.tune, ompi_tpu_torch.tune.perfdb, "
            "ompi_tpu_torch.tune.report, ompi_tpu_torch.tune.__main__, "
            "ompi_tpu_torch.skew, ompi_tpu_torch.skew.decompose, "
            "ompi_tpu_torch.skew.merge, ompi_tpu_torch.skew.report, "
            "ompi_tpu_torch.skew.__main__, ompi_tpu_torch.tools, "
            "ompi_tpu_torch.tools.info, ompi_tpu_torch.tools.msgq, "
            "ompi_tpu_torch.examples.multihost, "
            "ompi_tpu_torch.examples.mpmd, "
            "ompi_tpu_torch.examples.tune_observe; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ompi_tpu', 'ml_dtypes')]; "
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


def test_hierarchy_modules_are_scanned():
    """The hierarchy layer's modules and its guards are in the scan."""
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in ("parallel/hierarchical.py", "coll/hier.py", "coll/han.py",
                "monitoring/algo.py", "monitoring/matrix.py",
                "telemetry/flight.py", "trace/recorder.py",
                "tune/observe.py", "examples/hier_collectives.py",
                "examples/hier_dcn_compress.py",
                "examples/kernel_counts.py"):
        assert os.path.join("ompi_tpu_torch", mod) in rel, mod


def test_serving_and_monitoring_modules_are_scanned():
    """The serving and monitoring planes' modules are in the scan."""
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in ("serve/__init__.py", "serve/traffic.py", "serve/dispatch.py",
                "serve/loop.py", "monitoring/__init__.py",
                "monitoring/__main__.py", "monitoring/links.py",
                "monitoring/merge.py", "monitoring/report.py",
                "pml/monitoring.py", "topo/__init__.py",
                "examples/moe_serving.py"):
        assert os.path.join("ompi_tpu_torch", mod) in rel, mod


def test_tools_plane_modules_are_scanned():
    """The tools plane's modules (events, MPI_T, registry, show_help,
    hooks, ob1's attachments) and its examples are in the scan."""
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in ("core/events.py", "mpit.py", "core/registry.py",
                "util/show_help.py", "core/hook.py", "pml/peruse.py",
                "pml/custommatch.py", "pml/vprotocol.py",
                "examples/connectivity.py", "examples/library_caching.py",
                "examples/tools_plane.py"):
        assert os.path.join("ompi_tpu_torch", mod) in rel, mod


def test_instance_plane_modules_are_scanned():
    """The error-handler, info and instance planes' modules (sessions,
    memhooks, the extensions) and the sessions example are in the scan."""
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in ("errors.py", "info.py", "runtime/state.py",
                "runtime/kvstore.py", "runtime/rte.py", "core/memhooks.py",
                "core/mpool.py", "ext/__init__.py", "examples/sessions.py"):
        assert os.path.join("ompi_tpu_torch", mod) in rel, mod


def test_topology_and_dynamic_process_modules_are_scanned():
    """The topology framework's, the intercommunicators', the dynamic
    processes' and the profiling interposer's modules, and the halo
    example, are in the scan."""
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in ("topo/__init__.py", "topo/reorder.py",
                "coll/device_neighbor.py", "coll/inter.py",
                "comm/intercomm.py", "dpm.py", "profile.py",
                "examples/neighbor_halo.py"):
        assert os.path.join("ompi_tpu_torch", mod) in rel, mod


def test_io_plane_modules_are_scanned():
    """The I/O plane's modules and its two examples are in the scan."""
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in ("io/__init__.py", "io/fileview.py", "io/fcoll.py",
                "io/manifest.py", "io/checkpoint.py", "io/async_ckpt.py",
                "examples/parallel_io.py", "examples/ckpt_training.py",
                "examples/ckpt_profile.py"):
        assert os.path.join("ompi_tpu_torch", mod) in rel, mod


def test_ft_elastic_ingest_modules_are_scanned():
    """The ULFM, elastic and ingest planes' modules and their two
    examples are in the scan."""
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in ("ft/__init__.py", "ft/detector.py", "elastic/__init__.py",
                "elastic/context.py", "elastic/reshard.py",
                "elastic/inject.py", "ingest/__init__.py",
                "ingest/engine.py", "ingest/plan.py",
                "examples/streaming_ingest.py",
                "examples/elastic_training.py"):
        assert os.path.join("ompi_tpu_torch", mod) in rel, mod


def test_observability_modules_are_scanned():
    """The trace, telemetry and prof planes' modules, the skew recorder
    and the two examples are in the scan; the skew module holds its guard
    and the recorder behind it."""
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in ("trace/__init__.py", "trace/recorder.py", "trace/export.py",
                "trace/merge.py", "trace/__main__.py",
                "telemetry/__init__.py", "telemetry/clock.py",
                "telemetry/flight.py", "telemetry/openmetrics.py",
                "telemetry/sampler.py", "telemetry/watchdog.py",
                "prof/__init__.py", "prof/ledger.py", "prof/__main__.py",
                "skew/__init__.py", "skew/record.py",
                "examples/fused_gradients.py", "examples/observability.py"):
        assert os.path.join("ompi_tpu_torch", mod) in rel, mod
    with open(os.path.join(ROOT, "ompi_tpu_torch", "skew", "record.py"),
              encoding="utf-8") as f:
        tree = ast.parse(f.read())
    guards = [n for n in tree.body if isinstance(n, ast.AnnAssign)
              and n.target.id == "SKEW"]
    assert len(guards) == 1 and guards[0].value.value is None
    assert {n.name for n in tree.body if isinstance(n, ast.ClassDef)} \
        == {"SkewRecorder"}


def test_launcher_tune_skew_tools_modules_are_scanned():
    """Item 4d's launcher forms and topology, and item 10b's tune, skew
    and tools planes with their four examples, are in the scan."""
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in ("util/topology.py", "runtime/launcher.py",
                "tune/__init__.py", "tune/observe.py", "tune/perfdb.py",
                "tune/report.py", "tune/__main__.py", "skew/__init__.py",
                "skew/record.py", "skew/decompose.py", "skew/merge.py",
                "skew/report.py", "skew/__main__.py", "tools/__init__.py",
                "tools/info.py", "tools/msgq.py", "examples/multihost.py",
                "examples/mpmd.py", "examples/tune_observe.py",
                "examples/skew_straggler.py"):
        assert os.path.join("ompi_tpu_torch", mod) in rel, mod


def test_check_plane_modules_are_scanned():
    """Item 10c's check plane (the sanitizer, the memchecker and its core
    re-export, the lint engine, its rules and CLI) and its example are in
    the scan."""
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in ("check/__init__.py", "check/__main__.py",
                "check/memchecker.py", "check/sanitizer.py",
                "core/memchecker.py", "check/lint/__init__.py",
                "check/lint/model.py", "check/lint/cfg.py",
                "check/lint/dataflow.py", "check/lint/callgraph.py",
                "check/lint/sarif.py", "check/lint/rules/__init__.py",
                "check/lint/rules/collective.py",
                "check/lint/rules/requests.py", "check/lint/rules/osc.py",
                "check/lint/rules/conventions.py",
                "examples/correctness.py"):
        assert os.path.join("ompi_tpu_torch", mod) in rel, mod


#: module aliases the port's emitters call ``emit`` / ``fire`` through
_EMITTERS = {"events": "emit", "mpit_events": "emit", "peruse": "fire"}


def _guarded_sites(path):
    """(call, guard) for every ``<events>.emit(...)`` and
    ``peruse.fire(...)`` in a file: ``guard`` is the test of the nearest
    enclosing ``if``, or None."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    parents = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and _EMITTERS.get(node.func.value.id) == node.func.attr):
            continue
        up = parents.get(node)
        while up is not None and not isinstance(up, ast.If):
            up = parents.get(up)
        yield node, (up.test if up is not None else None)


def _guards(test, alias):
    """The event names (or True for ``peruse.active``) ``test`` checks
    through ``alias``."""
    out = set()
    for n in ast.walk(test):
        if isinstance(n, ast.Attribute) and n.attr == "active" \
                and isinstance(n.value, ast.Name) and n.value.id == alias:
            out.add(True)
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr == "active" \
                and isinstance(n.func.value, ast.Name) \
                and n.func.value.id == alias and n.args \
                and isinstance(n.args[0], ast.Constant):
            out.add(n.args[0].value)
    return out


def test_every_emitter_sits_under_its_guard():
    """Every MPI_T ``emit`` and PERUSE ``fire`` of the port sits under one
    ``if`` that tests the same event's ``active(name)`` (or
    ``peruse.active``): a site with no listener costs one load and one
    branch, and builds no payload."""
    sites = {}
    for path in _port_files():
        if os.path.basename(path) in ("events.py", "peruse.py"):
            continue  # the planes themselves define emit / fire
        for call, test in _guarded_sites(path):
            alias = call.func.value.id
            where = (os.path.relpath(path, ROOT), call.lineno)
            assert test is not None, where
            guards = _guards(test, alias)
            if alias == "peruse":
                assert True in guards, where
            else:
                name = call.args[0].value
                assert name in guards, (where, name, guards)
            key = os.path.relpath(path, os.path.join(ROOT, "ompi_tpu_torch"))
            sites[key] = sites.get(key, 0) + 1
    assert sites == {"pml/ob1.py": 9, "btl/sm.py": 1, "btl/tcp.py": 1,
                     "coll/libnbc.py": 1, "osc/__init__.py": 1,
                     "osc/cuda.py": 1, "osc/device_epoch.py": 1,
                     "tune/observe.py": 1, "io/fcoll.py": 1,
                     "ft/detector.py": 1, "trace/recorder.py": 1,
                     "telemetry/watchdog.py": 1}, sites


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
