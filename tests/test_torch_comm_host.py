"""Groups, communicator construction, attributes and Info of the port
against the JAX package's.

One 4-rank body runs in both packages (the reference through
``tests.harness.run_ranks``, the port through its launcher with
``--mca device_plane_platform cpu``) and records what each rank sees:
the Group algebra (incl / excl / range_incl / union / intersection /
difference / translate / compare), ``split`` (with a key that reverses
the order, and UNDEFINED), ``split_type("shared")``, ``create``,
``create_group`` (called by the members only), ``dup`` with attributes
(a copying keyval, a NULL_COPY keyval, delete callbacks at overwrite,
Delete_attr and free, the predefined attributes), names, ``Set_info`` /
``Get_info``, and point-to-point and object traffic on the new
communicators. The records must be equal rank by rank.
"""

import json
import os
import sys
import tempfile
import textwrap

from ompi_tpu_torch import compat
from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks

N = 4

_BODY = """
import json
from {pkg}.comm import Group, UNDEFINED
rec = {{}}
g = comm.Get_group()
sub = g.incl([3, 1])
rec["incl"] = list(sub.ranks)
rec["excl"] = list(g.excl([0, 2]).ranks)
rec["range_incl"] = list(g.range_incl([(0, 3, 2)]).ranks)
rec["union"] = list(sub.union(g.incl([0, 1])).ranks)
rec["intersection"] = list(g.intersection(sub).ranks)
rec["difference"] = list(g.difference(sub).ranks)
rec["translate"] = [g.translate(r, sub) for r in range(size)]
rec["compare"] = [g.compare(g), g.compare(g.incl([3, 2, 1, 0])),
                  g.compare(sub)]
rec["group_rank"] = [sub.rank, g.rank, g.size]
# split: two colours, the key reverses the order
s = comm.split(rank % 2, key=-rank)
rec["split"] = [s.rank, s.size, list(s.group.ranks),
                [s.world_rank(r) for r in range(s.size)]]
rec["split_allgather"] = s.allgather(rank * 10)
peer_out, peer_in = (s.rank + 1) % s.size, (s.rank - 1) % s.size
buf = np.zeros(3, np.int32)
st = s.Sendrecv(np.full(3, rank, np.int32), peer_out, buf, source=peer_in)
rec["split_sendrecv"] = [buf.tolist(), st.source]
u = comm.split(UNDEFINED if rank == 3 else 0)
rec["split_undefined"] = None if u is None else [u.rank, u.size]
sh = comm.split_type("shared")
rec["split_type"] = [sh.rank, sh.size]
c = comm.create(g.incl([2, 1]))
rec["create"] = None if c is None else [c.rank, c.size, list(c.group.ranks),
                                        c.allgather(rank)]
if rank in (0, 2):
    cg = comm.create_group(g.incl([2, 0]), tag=5)
    rec["create_group"] = [cg.rank, cg.size, cg.bcast(rank * 7, root=1)]
# attributes: copied or not by dup, delete callbacks
log = []
kv_copy = mpi.Comm_create_keyval(
    copy_fn=mpi.dup_fn,
    delete_fn=lambda o, k, v, e: log.append(["del", v, e]),
    extra_state="x")
kv_null = mpi.Comm_create_keyval()
d = comm.dup()
d.Set_attr(kv_copy, "first")
d.Set_attr(kv_copy, "second")  # overwrite fires delete on "first"
d.Set_attr(kv_null, 42)
dd = d.dup()
rec["attrs"] = [d.Get_attr(kv_copy), d.Get_attr(kv_null),
                dd.Get_attr(kv_copy), dd.Get_attr(kv_null),
                d.Get_attr(mpi.TAG_UB), d.Get_attr(mpi.WTIME_IS_GLOBAL),
                d.Get_attr(mpi.UNIVERSE_SIZE)]
d.Delete_attr(kv_null)
rec["after_delete"] = d.Get_attr(kv_null)
mpi.Comm_free_keyval(kv_copy)
dd.free()
d.free()
rec["delete_log"] = log
rec["dup_allgather"] = dd.size
# names and info
d2 = comm.dup()
rec["name"] = [comm.get_name(), d2.get_name() != comm.get_name()]
d2.set_name("mine")
info = {{"a": "1", "b": "two"}}
d2.Set_info(info)
info["c"] = "3"  # captured at Set_info: does not leak in
got = d2.Get_info()
rec["info"] = [d2.get_name(), sorted(got.items()), got.get_nkeys()]
d3 = d2.dup()
rec["info_dup"] = sorted(d3.Get_info().items())
with open(f"{out}/{who}_r{{rank}}.json", "w") as fh:
    json.dump(rec, fh, sort_keys=True)
"""

_PORT_PRELUDE = """
import numpy as np
from ompi_tpu_torch import mpi
comm = mpi.Init()
rank, size = comm.rank, comm.size
"""


def test_groups_comms_attrs_info_match_reference(tmp_path):
    run_ranks(_BODY.format(pkg="ompi_tpu", out=str(tmp_path), who="ref"), N,
              timeout=240, isolate=True)
    src = _PORT_PRELUDE + _BODY.format(pkg="ompi_tpu_torch",
                                       out=str(tmp_path), who="port") \
        + "\nmpi.Finalize()\n"
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as fh:
        fh.write(textwrap.dedent(src))
        path = fh.name
    try:
        rc = port_launcher.launch(
            [sys.executable, path], N, timeout=240,
            mca=dict(compat.mca_from_reference({}),
                     device_plane_platform="cpu"))
    finally:
        os.unlink(path)
    assert rc == 0, f"port job exited {rc}"
    for r in range(N):
        ref = json.loads((tmp_path / f"ref_r{r}.json").read_text())
        got = json.loads((tmp_path / f"port_r{r}.json").read_text())
        assert ref == got, (r, ref, got)
    r0 = json.loads((tmp_path / "port_r0.json").read_text())
    assert r0["split"][2] == [2, 0] and r0["split_undefined"] == [0, 3]
    assert r0["attrs"][:4] == ["second", 42, "second", None]
    assert r0["delete_log"] == [["del", "first", "x"], ["del", "second", "x"],
                                ["del", "second", "x"]]
