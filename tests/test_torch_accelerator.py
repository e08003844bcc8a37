"""The port's accelerator IPC surface (``ompi_tpu_torch.accelerator.ipc``,
``Accelerator.ipc_export`` / ``ipc_import``) against the JAX package's.

The counterpart of ``tests/test_accelerator.py``'s
``test_ipc_export_import`` on the null component: the same seeded numpy
data (and here CPU tensors, the device buffers of the port's null
component) exported, the handle pickled, imported, and compared bitwise
with what the reference's null component imports; ``release`` unlinks
the file. Then the import modes (a read-only or a write-through numpy
view, a private tensor mapping), the cuda component's import onto the
card (``gpu``), and the launcher's sweep of the shm files a crashed rank
leaves behind (a shmem heap and an IPC file under the port's prefix).
"""

import json
import os
import pickle
import sys
import tempfile
import textwrap

import ml_dtypes
import numpy as np
import pytest
import torch

from ompi_tpu.accelerator import ipc as ref_ipc
from ompi_tpu.accelerator.null import NullAccelerator
from ompi_tpu_torch import accelerator, compat
from ompi_tpu_torch.accelerator import ipc
from ompi_tpu_torch.runtime import launcher

#: (kind, numpy dtype, shape): numpy arrays and CPU tensors
BUFFERS = [("numpy", "int64", (10, 10)), ("numpy", "float32", (3, 5, 7)),
           ("tensor", "float32", (64,)), ("tensor", "bfloat16", (6, 9)),
           ("tensor", "int32", (4, 4)), ("tensor", "float32", (0,))]


def _data(dtype, shape):
    rng = np.random.default_rng(11)
    if dtype in ("int64", "int32"):
        return rng.integers(-1000, 1000, shape).astype(dtype)
    a = rng.standard_normal(shape).astype(np.float32)
    return a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("kind,dtype,shape", BUFFERS,
                         ids=[f"{k}-{d}-{'x'.join(map(str, s))}"
                              for k, d, s in BUFFERS])
def test_ipc_export_import_null(kind, dtype, shape):
    """Export, a pickled handle, import: bitwise equal to the source and
    to the reference null component's import of the same data; the file
    lies under the port's prefix and ``release`` unlinks it."""
    src = _data(dtype, shape)
    acc = accelerator.current()
    assert acc.NAME == "null"
    buf = compat.tensor_from_numpy(src) if kind == "tensor" else src
    handle = acc.ipc_export(buf)
    try:
        assert os.path.basename(handle.path).startswith(
            launcher.SHM_PREFIX), handle.path
        back = acc.ipc_import(pickle.loads(pickle.dumps(handle)))
        if kind == "tensor":
            assert isinstance(back, torch.Tensor)
            assert back.dtype == buf.dtype and back.device.type == "cpu"
            got = compat.tensor_to_numpy(back)
        else:
            assert isinstance(back, np.ndarray) and back.dtype == src.dtype
            got = back
        assert got.shape == src.shape
        assert got.tobytes() == _bits(src).tobytes()
        if not src.size:
            return  # the reference maps nothing for an empty array
        # the reference's null component on the same data (numpy: its
        # device buffers; bfloat16 as the bits it can hold)
        ref = NullAccelerator()
        rh = ref.ipc_export(ref.to_device(_bits(src)))
        try:
            rback = ref.ipc_import(pickle.loads(pickle.dumps(rh)))
            assert np.asarray(rback).tobytes() == got.tobytes()
        finally:
            ref_ipc.release(rh)
    finally:
        ipc.release(handle)
    assert not os.path.exists(handle.path)
    ipc.release(handle)  # a second release is harmless


def test_ipc_import_modes():
    """An array imports as a read-only view, or writable through to the
    file; a tensor imports over a private mapping (its writes stay in the
    importer)."""
    src = np.arange(12, dtype=np.float32)
    h = ipc.export_array(src)
    try:
        ro = ipc.import_array(h)
        assert not ro.flags.writeable
        rw = ipc.import_array(h, writable=True)
        rw[0] = 99.0
        assert ipc.import_array(h)[0] == 99.0
    finally:
        ipc.release(h)
    t = torch.arange(6, dtype=torch.int32)
    h = ipc.export_tensor(t)
    try:
        a = ipc.import_tensor(h)
        a[0] = 7
        assert ipc.import_tensor(h)[0] == 0 and torch.equal(
            ipc.import_tensor(h), t)
    finally:
        ipc.release(h)


@pytest.mark.gpu
def test_ipc_cuda_import_onto_card():
    """The cuda component: a CUDA tensor exported with one device-to-host
    copy, imported onto the card with one host-to-device copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    acc = accelerator.current()
    t = torch.randn(1 << 16, device="cuda")
    h = acc.ipc_export(t)
    try:
        back = acc.ipc_import(h)
        assert back.is_cuda and torch.equal(back, t)
    finally:
        ipc.release(h)


_CRASH = """
import json, os, sys
import numpy as np
from ompi_tpu_torch import accelerator, mpi, shmem
from ompi_tpu_torch.runtime import rte
comm = mpi.Init()
shmem.init(1 << 16)
h = accelerator.current().ipc_export(np.arange(8))
with open(os.path.join({out!r}, f"r{{comm.rank}}.json"), "w") as f:
    json.dump({{"heap": shmem._state._shm_path, "ipc": h.path,
               "jobid": rte.jobid}}, f)
comm.Barrier()
os._exit(3)  # crash: nothing is freed, released or unlinked
"""


def test_launcher_sweeps_leaked_heap_and_ipc(tmp_path):
    """A rank that dies holding a shmem heap and an exported IPC file:
    both lie under the port's prefix and the job id, and the launcher's
    sweep removes them when the job ends."""
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as fh:
        fh.write(textwrap.dedent(_CRASH.format(out=str(tmp_path))))
        path = fh.name
    try:
        rc = launcher.launch([sys.executable, path], 2,
                             mca={"device_plane_platform": "cpu"},
                             timeout=120)
    finally:
        os.unlink(path)
    assert rc == 3
    for r in range(2):
        with open(tmp_path / f"r{r}.json") as f:
            doc = json.load(f)
        for key in ("heap", "ipc"):
            name = os.path.basename(doc[key])
            assert name.startswith(f"{launcher.SHM_PREFIX}{doc['jobid']}_"), \
                name
            assert not os.path.exists(doc[key]), doc[key]
