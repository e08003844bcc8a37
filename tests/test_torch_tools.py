"""The port's tools plane (``tools/info.py``, the ompi_info equivalent;
``tools/msgq.py``, the MPIR message-queue dump) and its util layer
against the JAX package's: the counterparts of ``tests/test_tools.py``'s
4 cases, ``tests/test_msgq.py``'s 2, ``tests/test_type_introspect.py``'s
``test_msgq_decodes_type_tree`` and the ``tools/info`` half of
``tests/test_mpit.py::test_event_coll_and_info_dump``.

In this process: the info tree of both packages (their frameworks equal
once the reference's component names are mapped to the port's: ``xla``
-> ``device``, ``pallas`` -> ``cuda``, ``tpu`` -> ``cuda``), the CLI's
JSON, the event types it lists, ``show_help``'s once-per-process dedup,
the address scoring, an empty queue snapshot before Init and the decoded
constructor tree of the same nested datatype (equal documents and lines).
One 2-rank port job under ``mpir_dump_on_signal on``: a posted receive
and an unexpected message show in the snapshot and its rendering, the
SIGUSR1 handler installed at Init dumps without killing the rank, and
the point-to-point queues drain.
"""

import json
import os
import subprocess
import sys
import textwrap

from ompi_tpu_torch.runtime import launcher as P_launcher
from tests.test_torch_mpit import reference_state  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the reference's component names as the port's
COMPONENTS = {"xla": "device", "pallas": "cuda", "tpu": "cuda"}


def test_info_dumps_components_and_cvars():
    from ompi_tpu.tools import info as R_info
    from ompi_tpu_torch.tools import info as P_info

    data = P_info.collect(level=9, include_pvars=True)
    fw = data["frameworks"]
    assert set(fw["btl"]) == {"self", "sm", "tcp"}
    assert {"basic", "tuned", "libnbc", "accelerator", "device", "cuda",
            "inter"} <= set(fw["coll"])
    assert {"null", "cuda"} <= set(fw["accelerator"])
    # the real frameworks (a registry case elsewhere may have added a
    # test framework to either process-wide registry)
    ref = {k: v for k, v in R_info.collect(level=9)["frameworks"].items()
           if k in ("accelerator", "btl", "coll")}
    assert {k: sorted(COMPONENTS.get(c, c) for c in v)
            for k, v in ref.items()} == {k: fw[k] for k in ref}
    v = data["cvars"]["progress_spin_count"]
    assert v["type"] == "int" and v["help"]
    assert "osc_cuda" in data["cvars"] and "tune_observe" in data["cvars"]
    assert "tune_samples" in data["pvars"]  # listed before it ticks


def test_info_cli_json():
    out = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.info", "--json",
         "--level", "9"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    data = json.loads(out.stdout)
    assert {"frameworks", "cvars", "events"} <= set(data)
    assert {"cuda", "device"} <= set(data["frameworks"]["coll"])
    assert "osc_cuda" in data["cvars"]


def test_info_lists_event_types():
    """The tools/info half of test_event_coll_and_info_dump: the tree
    lists libnbc's completion event and the rendering has its section,
    as the reference's does."""
    from ompi_tpu.tools import info as R_info
    from ompi_tpu_torch.tools import info as P_info

    for info in (P_info, R_info):
        tree = info.collect()
        names = [e["name"] for e in tree["events"]]
        assert "coll_schedule_complete" in names
        assert "Event types" in "\n".join(info.render(tree))
    p = {e["name"]: e["fields"] for e in P_info.collect()["events"]}
    r = {e["name"]: e["fields"] for e in R_info.collect()["events"]}
    assert p["coll_schedule_complete"] == r["coll_schedule_complete"]


def test_show_help_dedup(capsys):
    from ompi_tpu.util import show_help as R_sh
    from ompi_tpu_torch.util import show_help as P_sh

    errs = []
    for sh in (R_sh, P_sh):
        sh.reset_for_testing()
        sh.show("launcher", "rank-died", rank=3, cause="signal 9")
        sh.show("launcher", "rank-died", rank=3, cause="signal 9")
        errs.append(capsys.readouterr().err)
    for err in errs:
        assert err.count("terminating the whole job") == 1
        assert "rank:   3" in err


def test_net_address_scoring():
    from ompi_tpu.util import net as R_net
    from ompi_tpu_torch.util import net as P_net

    for a, b in (("127.0.0.1", "127.0.0.1"), ("127.0.0.1", "10.0.0.2"),
                 ("10.0.0.1", "10.0.0.2"), ("8.8.4.4", None),
                 ("192.168.1.5", None)):
        assert P_net.score(a, b) == R_net.score(a, b), (a, b)
    assert P_net.pick_peer_address(["127.0.0.1", "10.0.0.5"],
                                   ["10.0.0.1"]) == "10.0.0.5"
    assert P_net.best_address()
    assert P_net.best_address("127.0.0.1") == "127.0.0.1"


def test_snapshot_empty_before_init():
    from ompi_tpu.tools import msgq as R_msgq
    from ompi_tpu_torch.tools import msgq as P_msgq

    for msgq in (P_msgq, R_msgq):
        snap = msgq.snapshot()
        assert snap["posted"] == [] and snap["unexpected"] == []
        assert snap["pending_sends"] == []
        assert isinstance(msgq.render(snap), list)


def test_msgq_decodes_type_tree():
    """A nested constructor tree walked through envelope / contents: the
    same document and lines from both packages."""
    from ompi_tpu.datatype import datatype as RD
    from ompi_tpu.tools import msgq as R_msgq
    from ompi_tpu_torch.datatype import datatype as PD
    from ompi_tpu_torch.tools import msgq as P_msgq

    got = {}
    for side, D, msgq in (("ref", RD, R_msgq), ("port", PD, P_msgq)):
        inner = D.create_struct([1, 1], [0, 8], [D.DOUBLE, D.INT32])
        outer = D.vector(2, 1, 2, inner)
        got[side] = (msgq.decode_type(outer), msgq.render_type(outer))
    assert got["port"] == got["ref"]
    tree, lines = got["port"]
    assert tree["combiner"] == "vector" and tree["integers"] == [2, 1, 2]
    assert tree["types"][0]["combiner"] == "struct"
    assert [t["name"] for t in tree["types"][0]["types"]] == \
        ["MPI_DOUBLE", "MPI_INT32_T"]
    assert lines[0].startswith("vector") and "struct" in lines[1]


_QUEUES = textwrap.dedent('''
    import os, signal
    import numpy as np
    from ompi_tpu_torch import mpi
    from ompi_tpu_torch.core import progress
    from ompi_tpu_torch.tools import msgq
    comm = mpi.Init()
    rank, size = comm.rank, comm.size
    if rank == 0:
        # a receive that cannot match yet: the posted queue
        pending = comm.Irecv(np.zeros(4, np.float32), 1, tag=99)
        comm.Barrier()
        # rank 1 sent tag 7 with no receive posted: the unexpected queue
        progress.wait_until(
            lambda: any(u["tag"] == 7 for u in
                        msgq.snapshot()["unexpected"]), timeout=30)
        snap = msgq.snapshot()
        assert any(p["tag"] == 99 for p in snap["posted"]), snap
        assert any(u["tag"] == 7 for u in snap["unexpected"]), snap
        world = [c for c in snap["communicators"] if c["size"] == size]
        assert world and world[0]["rank"] == 0, snap
        text = "\\n".join(msgq.render(snap))
        assert "tag 7" in text and "tag 99" in text, text
        # the SIGUSR1 handler installed at Init must not kill the rank
        os.kill(os.getpid(), signal.SIGUSR1)
        got = np.zeros(4, np.float32)
        comm.Recv(got, 1, tag=7)
        comm.Send(np.ones(4, np.float32), 1, tag=98)
        pending.wait()
        snap = msgq.snapshot()
        assert not [p for p in snap["posted"] if not p["collective"]], snap
        assert not [u for u in snap["unexpected"]
                    if not u["collective"]], snap
    else:
        comm.Send(np.full(4, 2.0, np.float32), 0, tag=7)
        comm.Barrier()
        got = np.zeros(4, np.float32)
        comm.Recv(got, 0, tag=98)
        comm.Send(np.full(4, 3.0, np.float32), 0, tag=99)
    mpi.Finalize()
''')


def test_queues_visible_and_drain(tmp_path, capfd):
    path = tmp_path / "queues.py"
    path.write_text(_QUEUES)
    rc = P_launcher.launch([sys.executable, str(path)], 2,
                           mca={"mpir_dump_on_signal": "on",
                                "device_plane_platform": "cpu"},
                           timeout=120)
    err = capfd.readouterr().err
    assert rc == 0, err[-3000:]
    # rank 0's handler dumped its queues to stderr
    assert "MPI message queues:" in err and "tag 99" in err, err[-3000:]
