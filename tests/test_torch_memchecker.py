"""The port's memchecker (``check/memchecker``, re-exported by
``core/memchecker``) against the JAX package's: the counterparts of
``tests/test_memchecker.py``'s 8 cases, plus the port's tensor rule.

The shadow-map cases run in this process on both packages, on the same
numpy buffers: the same calls must raise the same ``MemcheckError`` text
(the byte intervals are the buffers' own addresses) or pass in both. A
tensor, on the CPU here as on the card, has no shadow: it is neither
flagged nor shadows a later send, as a jax array in the reference.

One port launcher job on 2 ranks under ``--mca memchecker on`` runs the
reference's two rank programs: ob1's send entry flags a send from a
buffer with a receive pending into it, the same buffer sends cleanly once
the receive completes, and a clean Allreduce is not flagged.
"""

import json
import textwrap

import numpy as np
import pytest
import torch

from ompi_tpu.check import memchecker as R_mc
from ompi_tpu.core import cvar as R_cvar
from ompi_tpu.core import pvar as R_pvar
from ompi_tpu_torch.check import memchecker as P_mc
from ompi_tpu_torch.core import cvar as P_cvar
from ompi_tpu_torch.core import memchecker as P_core_mc
from ompi_tpu_torch.core import pvar as P_pvar
from tests.test_torch_mpit import reference_state  # noqa: F401 — autouse
from tests.test_torch_trace import port_job

#: side -> (memchecker, cvar, pvar)
SIDES = {"ref": (R_mc, R_cvar, R_pvar), "port": (P_mc, P_cvar, P_pvar)}


@pytest.fixture(autouse=True)
def _on():
    old = {side: cvar.get("memchecker") for side, (_, cvar, _p)
           in SIDES.items()}
    for mc, cvar, _p in SIDES.values():
        cvar.set("memchecker", "on")
        mc.reset_for_testing()
    yield
    for side, (mc, cvar, _p) in SIDES.items():
        cvar.set("memchecker", old[side])
        mc.reset_for_testing()


def both(fn):
    """fn(memchecker, cvar, pvar) on each package with the same buffers;
    what each raised (or None) must be the same."""
    got = {}
    for side, mods in SIDES.items():
        try:
            fn(*mods)
            got[side] = None
        except mods[0].MemcheckError as exc:
            got[side] = str(exc)
    assert got["port"] == got["ref"], got
    return got["port"]


def test_send_from_pending_recv_buffer_flagged():
    buf = np.zeros(16, np.float32)

    def run(mc, *_):
        mc.mark_undefined(1, buf)
        mc.check_defined(buf, "send")
    msg = both(run)
    assert msg is not None and "pending" in msg


def test_defined_after_completion():
    buf = np.zeros(16, np.float32)

    def run(mc, *_):
        mc.mark_undefined(1, buf)
        mc.mark_defined(1)
        mc.check_defined(buf, "send")
    assert both(run) is None


def test_overlapping_receives_flagged():
    buf = np.zeros(32, np.float32)

    def run(mc, *_):
        mc.mark_undefined(1, buf[:20])
        mc.mark_undefined(2, buf[8:])
    msg = both(run)
    assert msg is not None and "overlap" in msg


def test_disjoint_buffers_ok():
    buf = np.zeros(32, np.float32)
    other = np.zeros(4)

    def run(mc, *_):
        mc.mark_undefined(1, buf[:16])
        mc.mark_undefined(2, buf[16:])
        mc.check_defined(other, "send")
    assert both(run) is None


def test_warn_mode_does_not_raise():
    buf = np.zeros(8, np.float32)

    def run(mc, cvar, pvar):
        cvar.set("memchecker", "warn")
        before = pvar.read("memchecker_violations")
        mc.mark_undefined(1, buf)
        mc.check_defined(buf, "send")
        assert pvar.read("memchecker_violations") == before + 1
    assert both(run) is None


def test_off_mode_is_noop():
    buf = np.zeros(8, np.float32)

    def run(mc, cvar, _p):
        cvar.set("memchecker", "off")
        mc.mark_undefined(1, buf)
        mc.check_defined(buf, "send")
        assert not mc._undefined
    assert both(run) is None


def test_tensor_buffers_have_no_shadow():
    """A tensor maps to the empty interval, on the CPU as on the card: a
    pending receive into one shadows nothing, and a send from one is
    never flagged, even over a shadowed host buffer's storage. The core
    module re-exports the check plane's (one shadow map)."""
    t = torch.zeros(16)
    assert P_mc._interval(t) == (0, 0) == P_mc._interval(t, 64)
    P_mc.mark_undefined(1, t)
    P_mc.check_defined(t, "send")
    P_mc.check_defined(torch.zeros(4), "send")
    host = t.numpy()  # the same bytes, as an array: this one is shadowed
    P_mc.mark_undefined(2, host)
    P_mc.check_defined(t, "send")
    with pytest.raises(P_core_mc.MemcheckError, match="pending"):
        P_core_mc.check_defined(host, "send")
    assert P_core_mc.mark_undefined is P_mc.mark_undefined


# -- end to end: ob1's sites ----------------------------------------------

_PROG = '''
import json, os
import numpy as np
import torch
from ompi_tpu_torch import mpi
from ompi_tpu_torch.check import memchecker
comm = mpi.Init()
rank, size = comm.rank, comm.size
out_dir = {out!r}
doc = {{}}
buf = np.zeros(64, np.float32)
if rank == 0:
    req = comm.Irecv(buf, source=1, tag=7)
    try:
        comm.Send(buf, 1, tag=9)
        doc["flagged"] = False
    except memchecker.MemcheckError as exc:
        doc["flagged"] = "pending" in str(exc)
    comm.Send(np.ones(64, np.float32), 1, tag=9)
    req.wait()
    doc["received"] = float(buf[0])
    comm.Send(buf, 1, tag=11)  # defined again: sends cleanly
else:
    got = np.zeros(64, np.float32)
    comm.Recv(got, 0, tag=9)
    comm.Send(np.full(64, 5.0, np.float32), 0, tag=7)
    comm.Recv(got, 0, tag=11)
    doc["received"] = float(got[0])
a = np.full(32, float(rank), np.float32)
b = np.zeros(32, np.float32)
comm.Allreduce(a, b)
doc["allreduce"] = float(b[0])
doc["undefined_left"] = len(memchecker._undefined)
mpi.Finalize()
with open(os.path.join(out_dir, f"doc_r{{rank}}.json"), "w") as fh:
    json.dump(doc, fh)
'''


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = tmp_path_factory.mktemp("memcheck_port")
    port_job(textwrap.dedent(_PROG.format(out=str(out))), 2,
             {"memchecker": "on", "device_plane_platform": "cpu"},
             timeout=120)
    return [json.loads((out / f"doc_r{r}.json").read_text())
            for r in range(2)]


def test_pml_flags_send_from_inflight_recv_buffer(job):
    """Rank 0 posts an Irecv into buf, then Sends from the same buf: ob1's
    send entry flags it; after completion the same buffer sends
    cleanly."""
    assert job[0]["flagged"] is True
    assert job[0]["received"] == 5.0 and job[1]["received"] == 5.0


def test_pml_clean_run_unflagged(job):
    for d in job:
        assert d["allreduce"] == 1.0 and d["undefined_left"] == 0
