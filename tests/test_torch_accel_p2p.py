"""Device-tensor point-to-point (``pml/accel_p2p``) against the JAX
package's device p2p.

Each case of ``tests/test_accel_coll.py``'s device p2p
(``test_device_p2p_*``) runs in one 2-rank body that both packages
execute: the reference with jax arrays on the CPU through
``tests.harness.run_ranks``, the port with CPU tensors as device buffers
(``--mca device_plane_platform cpu``) through its launcher, on the same
seeded numpy inputs. The chunk size is set per case on both sides, small
enough that a message has many chunks (more than the staging ring's
depth). Received payloads are compared bitwise through a uint8 view
(bfloat16 through its uint16 bits) and statuses exactly: the pipelined
staging, status and empty messages, the short message's zero tail,
truncation (blocking, and nonblocking that drains and leaves the channel
clean), nonblocking sends, two Isends on one (dest, tag), a wildcard
receive and bfloat16 / int32 payloads. The port's refusal of a tensor
off the rank's device is checked in its job.
"""

import json
import os
import sys
import tempfile
import textwrap

import numpy as np

from ompi_tpu_torch import compat
from ompi_tpu_torch.runtime import launcher as port_launcher
from tests.harness import run_ranks

_BODY = """
import json
from {pkg} import errors
from {pkg}.core import cvar, pvar
from {pkg}.pml import accel_p2p  # registers pml_accel_chunk_bytes
OUT, WHO = {out!r}, {who!r}
res = {{}}

def save(name, t):
    np.save(f"{{OUT}}/{{WHO}}_{{name}}_r{{rank}}.npy", host(t))

def stat(name, st):
    res[name] = [st.source, st.tag, st.count, st.error]

def inputs(n, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    return (rng.standard_normal(n) * 100).astype(np.float32)

def chunk(nbytes):
    cvar.set("pml_accel_chunk_bytes", nbytes)

s0 = pvar.read("accel_p2p_send")
r0 = pvar.read("accel_p2p_recv")
# pipelined staging: 5 and 49 chunks
chunk(4096)
for name, n in (("pipe5", 5000), ("pipe49", 50000)):
    if rank == 0:
        comm.Send(dev(inputs(n, n)), dest=1, tag=3)
    else:
        st = mpi.Status()
        out = comm.Recv(zeros((n,), "float32"), source=0, tag=3, status=st)
        stat(name, st)
        save(name, out)
res["counted"] = [pvar.read("accel_p2p_send") - s0,
                  pvar.read("accel_p2p_recv") - r0]
# status and empty messages, a 2-D template
chunk(4 << 20)
if rank == 0:
    comm.Send(dev(np.zeros((0,), np.int32)), dest=1, tag=9)
    comm.Send(dev(np.full((7, 3), 5, np.int32)), dest=1, tag=9)
else:
    st = mpi.Status()
    e = comm.Recv(zeros((0,), "int32"), source=0, tag=9, status=st)
    stat("empty", st)
    save("empty", e)
    st = mpi.Status()
    save("shaped", comm.Recv(zeros((7, 3), "int32"), source=0, tag=9,
                             status=st))
    stat("shaped", st)
# a longer template gets a zero tail and the sender's count
chunk(256)
if rank == 0:
    comm.Send(dev(inputs(100, 1)), dest=1, tag=4)
else:
    st = mpi.Status()
    save("short", comm.Recv(dev(np.full(150, 7.0, np.float32)), source=0,
                            tag=4, status=st))
    stat("short", st)
# nonblocking, beside a blocking send on another tag
chunk(4096)
n = 3000
if rank == 0:
    sreqs = [comm.Isend(dev(inputs(n, 10 + i)), dest=1, tag=20 + i)
             for i in range(3)]
    comm.Send(dev(np.full(500, 7.0, np.float32)), dest=1, tag=30)
    mpi.wait_all(sreqs)
else:
    rreqs = [comm.Irecv(zeros((n,), "float32"), source=0, tag=20 + i)
             for i in range(3)]
    rblk = comm.Irecv(zeros((500,), "float32"), source=0, tag=30)
    mpi.wait_all(rreqs + [rblk])
    for i, r in enumerate(rreqs + [rblk]):
        save(f"nb{{i}}", r.array)
        stat(f"nb{{i}}", r.status)
# two Isends on one (dest, tag) stay in order
chunk(1024)
n = 2000
if rank == 0:
    a = comm.Isend(dev(np.full(n, 1.0, np.float32)), dest=1, tag=5)
    b = comm.Isend(dev(np.full(n, 2.0, np.float32)), dest=1, tag=5)
    mpi.wait_all([a, b])
else:
    ra = comm.Irecv(zeros((n,), "float32"), source=0, tag=5)
    rb = comm.Irecv(zeros((n,), "float32"), source=0, tag=5)
    mpi.wait_all([ra, rb])
    save("same_tag_a", ra.array)
    save("same_tag_b", rb.array)
# truncation drains; the next transfer on the channel matches cleanly
chunk(512)
if rank == 0:
    comm.Send(dev(inputs(500, 3)), dest=1, tag=6)
    comm.Send(dev(np.full(100, 9.0, np.float32)), dest=1, tag=6)
else:
    r = comm.Irecv(zeros((100,), "float32"), source=0, tag=6)
    try:
        r.wait(timeout=60)
        res["drained"] = None
    except errors.MPIError as e:
        res["drained"] = e.error_class
    save("after_trunc", comm.Recv(zeros((100,), "float32"), source=0,
                                  tag=6))
# bfloat16 (its bits) and int32, a wildcard receive
chunk(2048)
if rank == 0:
    comm.Send(dev(inputs(3001, 4)).astype("bfloat16") if WHO == "ref"
              else dev(inputs(3001, 4)).to(torch.bfloat16), dest=1, tag=7)
    comm.Send(dev(inputs(2222, 5, "int32")), dest=1, tag=8)
else:
    st = mpi.Status()
    save("bf16", comm.Recv(zeros((3001,), "bfloat16"), source=0, tag=7,
                           status=st))
    stat("bf16", st)
    st = mpi.Status()
    save("i32_any", comm.Recv(zeros((2222,), "int32"),
                              source=mpi.ANY_SOURCE, tag=mpi.ANY_TAG,
                              status=st))
    stat("i32_any", st)
# a shorter template raises ERR_TRUNCATE (last: the reference's blocking
# receive raises at the header and leaves the chunks in the channel)
chunk(256)
if rank == 0:
    comm.Send(dev(inputs(100, 2)), dest=1, tag=55)
else:
    try:
        comm.Recv(zeros((10,), "float32"), source=0, tag=55)
        res["undersized"] = None
    except errors.MPIError as e:
        res["undersized"] = e.error_class
with open(f"{{OUT}}/{{WHO}}_res_r{{rank}}.json", "w") as fh:
    json.dump(res, fh, sort_keys=True)
"""

_REF_ADAPT = """
import jax.numpy as jnp

def dev(a):
    return jnp.asarray(a)

def zeros(shape, dtype):
    return jnp.zeros(shape, dtype)

def host(t):
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a
"""

_PORT_PROG = """
import numpy as np
import torch
from ompi_tpu_torch import compat, mpi
comm = mpi.Init()
rank, size = comm.rank, comm.size

def dev(a):
    return compat.tensor_from_numpy(a)

def zeros(shape, dtype):
    return torch.zeros(shape, dtype=getattr(torch, dtype))

def host(t):
    return compat.tensor_to_numpy(t)
{body}
# a tensor off the rank's device is refused, never staged
def error_class(fn):
    try:
        fn()
    except errors.MPIError as e:
        return e.error_class
    raise AssertionError("no MPIError raised")
assert error_class(lambda: comm.Send(torch.empty(4, device="meta"),
                                     dest=1 - rank)) == errors.ERR_ARG
assert error_class(lambda: comm.Irecv(torch.empty(4, device="meta"),
                                      source=1 - rank)) == errors.ERR_ARG
# the port's blocking receive drains a truncated message too: the next
# one on the channel matches cleanly
if rank == 0:
    comm.Send(torch.arange(500.0), dest=1, tag=56)
    comm.Send(torch.full((100,), 9.0), dest=1, tag=56)
else:
    assert error_class(lambda: comm.Recv(torch.zeros(10), source=0,
                                         tag=56)) == errors.ERR_TRUNCATE
    assert (comm.Recv(torch.zeros(100), source=0, tag=56) == 9.0).all()
# Recv fills the template in place and returns it
t = torch.zeros(6)
if rank == 0:
    comm.Send(torch.arange(6.0), dest=1, tag=99)
else:
    assert comm.Recv(t, source=0, tag=99) is t
    assert torch.equal(t, torch.arange(6.0))
mpi.Finalize()
"""


def test_device_p2p_matches_reference(tmp_path):
    run_ranks(_REF_ADAPT + _BODY.format(pkg="ompi_tpu", out=str(tmp_path),
                                        who="ref"),
              2, timeout=240, isolate=True)
    body = _BODY.format(pkg="ompi_tpu_torch", out=str(tmp_path), who="port")
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as fh:
        fh.write(textwrap.dedent(_PORT_PROG.replace("{body}", body)))
        path = fh.name
    try:
        rc = port_launcher.launch(
            [sys.executable, path], 2, timeout=240,
            mca=dict(compat.mca_from_reference({}),
                     device_plane_platform="cpu"))
    finally:
        os.unlink(path)
    assert rc == 0, f"port job exited {rc}"
    names = sorted(f for f in os.listdir(tmp_path) if f.startswith("ref_"))
    assert len(names) > 15, names
    for f in names:
        got = tmp_path / ("port_" + f[4:])
        if f.endswith(".npy"):
            ref, port = np.load(tmp_path / f), np.load(got)
            assert ref.dtype == port.dtype and ref.shape == port.shape, f
            np.testing.assert_array_equal(ref.reshape(-1).view(np.uint8),
                                          port.reshape(-1).view(np.uint8),
                                          err_msg=f)
        else:
            assert json.loads((tmp_path / f).read_text()) \
                == json.loads(got.read_text()), f
    r1 = json.loads((tmp_path / "port_res_r1.json").read_text())
    r0 = json.loads((tmp_path / "port_res_r0.json").read_text())
    assert r0["counted"] == [2, 0] and r1["counted"] == [0, 2]
    assert r1["short"][2] == 400 and r1["undersized"] == 15
    assert r1["drained"] == 15
    short = np.load(tmp_path / "port_short_r1.npy")
    assert (short[100:] == 0).all()
