"""coll/cuda's decision layer and the port's configuration plumbing,
against the JAX package's coll/pallas where both answer the same
question (single process, no ranks)."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ompi_tpu.coll import pallas as ref_pallas
from ompi_tpu.core import cvar as ref_cvar
from ompi_tpu_torch import compat, errors
from ompi_tpu_torch.coll import cuda as cc
from ompi_tpu_torch.core import cvar
from tests.test_torch_mpit import reference_only_state  # noqa: F401

#: the reference's cvars these cases set go back as they were found
pytestmark = pytest.mark.usefixtures("reference_only_state")

COMM = SimpleNamespace(size=4)


def _t(nbytes, dtype=torch.float32):
    return torch.zeros(nbytes // torch.empty(0, dtype=dtype).element_size(),
                       dtype=dtype)


@pytest.mark.parametrize("kind,nbytes,det,rows,want", [
    ("allreduce", 4096, "linear", 256, "linear"),
    ("allgather", 4096, "linear", 1024, "ring"),
    ("allreduce", 4096, "ring", 256, "ring"),
    ("allreduce", 4096, None, 256, "ring"),
    ("allreduce", 2 << 20, None, 1 << 17, "bidir"),
    ("reduce_scatter_block", 2 << 20, None, 1, "ring"),
])
def test_select_builtin_order(kind, nbytes, det, rows, want):
    """Deterministic modes pin the kernel; otherwise the bidirectional
    ring at/above coll_cuda_bidir_min_bytes (needs >= 2 rows/chunk)."""
    assert cc._select(kind, COMM, _t(nbytes), det, rows) == want


def test_forced_algorithm_cvar():
    try:
        cvar.set("coll_cuda_allreduce_algorithm", "linear")
        assert cc._select("allreduce", COMM, _t(4096), None, 256) == \
            "linear"
        assert cc._select("allreduce", COMM, _t(4096), "ring", 256) == \
            "ring"  # deterministic modes ignore a forced ring/bidir/linear
        cvar.set("coll_cuda_allreduce_algorithm", "bidir")
        assert cc._select("allreduce", COMM, _t(4096), None, 1) == "ring"
        # 'xla' falls through to coll/device, deterministic modes included
        # (coll/pallas.py:220-221), for every kind
        for kind in ("allreduce", "reduce_scatter_block", "allgather"):
            cvar.set(f"coll_cuda_{kind.split('_block')[0]}_algorithm",
                     "xla")
            for det in (None, "ring", "linear"):
                assert cc._select(kind, COMM, _t(4096), det, 256) is None
        with pytest.raises(ValueError):
            cvar.set("coll_cuda_allreduce_algorithm", "nccl")
    finally:
        for kind in ("allreduce", "reduce_scatter", "allgather"):
            cvar.set(f"coll_cuda_{kind}_algorithm", "")


def test_switchpoint_table_loads_the_reference_format(tmp_path):
    """A table written for coll/pallas loads unchanged and picks the
    same algorithm in both packages."""
    path = tmp_path / "sw.json"
    path.write_text(json.dumps([
        {"op": "allreduce", "dtype": "float32", "mesh": [4], "log2": 0,
         "algorithm": "linear"},
        {"op": "allreduce", "dtype": "float32", "mesh": [4], "log2": 16,
         "algorithm": "ring"},
        {"op": "allreduce", "dtype": "float32", "mesh": [4], "log2": 20,
         "algorithm": "xla"},
    ]))
    try:
        cvar.set("coll_cuda_switchpoints", str(path))
        ref_cvar.set("coll_pallas_switchpoints", str(path))
        cc._sw_cache.clear()
        ref_pallas._sw_cache.clear()
        for nbytes in (1024, 1 << 16, (1 << 17) + 12, 1 << 20, 3 << 20):
            got = cc._switchpoint("allreduce", nbytes, "float32", (4,))
            ref = ref_pallas._switchpoint("allreduce", nbytes, "float32",
                                          (4,))
            assert got == ref, nbytes
        assert cc._select("allreduce", COMM, _t(1024), None, 64) == "linear"
        assert cc._select("allreduce", COMM, _t(1 << 20), None, 1) is None
    finally:
        cvar.set("coll_cuda_switchpoints", "")
        ref_cvar.set("coll_pallas_switchpoints", "")
        cc._sw_cache.clear()
        ref_pallas._sw_cache.clear()


def test_unknown_deterministic_mode_rejected():
    with pytest.raises(errors.MPIError) as ei:
        cc._det_ok("tree")
    assert ei.value.error_class == errors.ERR_ARG


def test_mca_from_reference():
    got = compat.mca_from_reference({
        "device_plane": "on", "coll_pallas": "on",
        "coll_pallas_bidir_min_bytes": "4096",
        "coll_pallas_interpret": "on",
        "coll_xla_deterministic": "linear",
        "device_plane_platform": "tpu", "btl": "self,sm"})
    assert got == {"device_plane": "on", "coll_cuda": "on",
                   "coll_cuda_bidir_min_bytes": "4096",
                   "coll_device_deterministic": "linear",
                   "device_plane_platform": "cuda", "btl": "self,sm"}


@pytest.mark.parametrize("mode", ["", "ring", "linear"])
def test_mca_maps_xla_deterministic_to_device(mode):
    """coll_xla_deterministic sets coll/xla's default, which coll/pallas
    reads too: it maps to coll_device_deterministic alone, and both of
    the port's components resolve that one mode."""
    from ompi_tpu_torch.coll import device

    got = compat.mca_from_reference({"coll_xla_deterministic": mode})
    assert got == {"coll_device_deterministic": mode}
    assert cvar.get("coll_cuda_deterministic") is None  # no second cvar
    try:
        cvar.set("coll_device_deterministic", mode)
        assert device._det_ok(None) == cc._det_ok(None) == (mode or None)
    finally:
        cvar.set("coll_device_deterministic", "")


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_tensor_numpy_round_trip(dtype):
    import jax.numpy as jnp

    h = np.random.default_rng(0).standard_normal(33).astype(np.float32)
    a = np.asarray(jnp.asarray(h).astype(dtype))
    t = compat.tensor_from_numpy(a)
    assert t.dtype == getattr(torch, dtype)
    back = compat.tensor_to_numpy(t)
    want = a.view(np.uint16) if dtype == "bfloat16" else a
    np.testing.assert_array_equal(back, want)


def test_launcher_env_contract():
    from ompi_tpu_torch.runtime import launcher

    env = launcher.build_env(2, 4, ("127.0.0.1", 5), "job", {"coll_cuda":
                                                            "on"}, {})
    assert env["OMPI_TPU_RANK"] == "2" and env["OMPI_TPU_SIZE"] == "4"
    assert env["OMPI_TPU_LOCAL_RANK"] == "2"
    assert env["OMPI_TPU_COLL_CUDA"] == "on"
    assert "JAX_PLATFORMS" not in env
    import os

    import ompi_tpu_torch

    root = os.path.dirname(os.path.dirname(ompi_tpu_torch.__file__))
    assert env["PYTHONPATH"].split(os.pathsep)[0] == root
