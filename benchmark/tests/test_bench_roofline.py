"""The byte counts of ``benchmark/roofline`` against counts by hand."""

import json
import os

from benchmark.lib import model
from benchmark.roofline import peaks, zero_step

from benchmark.tests.helpers import BENCH


def _cfg(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def _plan(name, item=4):
    cfg = _cfg(name)
    elems = [model.numel(s) for _, s in model.leaves(cfg)]
    return cfg, zero_step.plan(elems, 4, cfg["deployment"]["bucket_bytes"],
                               item)


def test_gpt2_small_is_one_bucket_of_every_parameter():
    cfg, buckets = _plan("gpt2-small")
    # wte 50257 x 768, wpe 1024 x 768, 12 blocks of 7,087,872, ln_f 1536
    by_hand = 50257 * 768 + 1024 * 768 + 12 * (
        2 * 768 * 2 + 768 * 2304 + 2304 + 768 * 768 + 768
        + 768 * 3072 + 3072 + 3072 * 768 + 768) + 2 * 768
    assert by_hand == 124_439_808 == cfg["parameters"]
    assert buckets == [{"elems": by_hand, "padded": by_hand,
                        "shard": by_hand // 4}]


def test_gpt2_xl_buckets_close_at_two_gigabytes():
    cfg, buckets = _plan("gpt2-xl")
    assert sum(b["elems"] for b in buckets) == 1_557_611_200 \
        == cfg["parameters"]
    # a bucket closes at the leaf that takes it to 5e8 elements or more
    assert all(b["elems"] >= 500_000_000 for b in buckets[:-1])
    assert len(buckets) == 3
    assert all(b["padded"] % 4 == 0 and b["shard"] * 4 == b["padded"]
               for b in buckets)


def test_ring_kernel_bytes_by_hand():
    _, buckets = _plan("gpt2-small")
    k = 124_439_808 // 4 * 4  # a shard's bytes
    got = zero_step.kernel_bytes(buckets, 4, "ring", 4)
    assert got == {
        # two K1 hops: carry in (a peer's), own chunk in, carry out
        "K1": {"launches": 2, "bytes": 2 * 3 * k, "peer": 2 * k},
        # K5: carry, chunk, shard, momentum in; shard, momentum out
        "K5": {"launches": 1, "bytes": 6 * k, "peer": k},
        # four K2 copies, three from peers
        "K2": {"launches": 4, "bytes": 4 * 2 * k, "peer": 3 * k}}


def test_linear_kernel_bytes_by_hand():
    _, buckets = _plan("gpt2-small")
    k = 124_439_808 // 4 * 4
    got = zero_step.kernel_bytes(buckets, 4, "linear", 4)
    assert got == {"K3": {"launches": 1, "bytes": 5 * k, "peer": 3 * k},
                   "K2": {"launches": 4, "bytes": 8 * k, "peer": 3 * k}}


def test_step_bytes_and_bound_by_hand():
    p = 1_557_611_200 * 4
    need = zero_step.step_bytes(1_557_611_200, 4, 4)
    assert need == {"bytes": p + p + p, "peer": 1.5 * p}
    # one rank per card: NVLink bounds (9.35 GB at 450 GB/s)
    assert abs(peaks.bound_s(need["bytes"], need["peer"])
               - 1.5 * p / 450e9) < 1e-12
    # four ranks on one card: every byte is HBM's
    assert abs(peaks.bound_s(4 * 3 * 124_439_808 * 4, 0)
               - 48 * 124_439_808 / 3.35e12) < 1e-12


def test_families_by_kernel_name():
    assert zero_step.family("void stream_kernel<float, 0>(StreamSpan, int)") \
        == "K1"
    assert zero_step.family("ag_hop_kernel(unsigned char const*)") == "K2"
    assert zero_step.family("void fold_kernel<float, 0>(Srcs)") == "K3"
    assert zero_step.family("void rs_update_kernel<float, 0>(float*)") \
        == "K5"
    assert zero_step.family("void fold_update_kernel<float, 0>()") is None
    assert zero_step.family("Memcpy DtoD (Device -> Device)") is None
