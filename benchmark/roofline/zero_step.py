"""Bytes of the ZeRO stage-2 step: its bucket plan, each kernel family's
launches and bytes, and the least bytes the whole step must move.

The benchmark's own statement of the arithmetic behind the kernel
bounds of the port's chip smoke test, rewritten from the shapes alone:

- The plan: the leaves, in flatten order, fill a bucket until its bytes
  reach ``bucket_bytes`` (the leaf that reaches it closes the bucket);
  each bucket's element count is padded up to a multiple of the rank
  count n, and each rank owns one shard of k = padded / n elements.
- Each input byte is counted read once and each output byte written
  once, per launch. A byte that a kernel reads from another rank's
  memory is a peer byte: over NVLink when the ranks sit on different
  cards, an HBM byte of the same card otherwise. By the symmetry of the
  ring every card serves as many bytes to its peers as it reads from
  them, so a card's HBM moves every byte its own kernels count.

Per bucket, rank and step (itemsize b):

- ``ring`` (the fused default): n - 2 K1 hops (``stream_kernel``:
  carry from the previous rank, own chunk, new carry: 3 k b, k b of it
  from a peer), one K5 (``rs_update_kernel``: carry, own chunk, shard,
  momentum in, shard and momentum out: 6 k b, k b from a peer);
- ``linear``: one K3 (``fold_kernel``: n chunks in, n - 1 of them from
  peers, one out: (n + 1) k b) and the eager update (torch's own
  elementwise kernels, not counted here);
- both: the parameter allgather, n K2 copies (``ag_hop_kernel``: k b in,
  k b out; n - 1 of them read a peer's shard).

The whole step's required bytes per rank: the gradients read once (P b,
P the parameter count), the shard and its momentum read and written
once (4 P b / n), the gathered parameters written once (P b); with one
rank per card, (n - 1) / n of the gradients and of the parameters cross
NVLink into each card.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

#: device kernel name -> the port's kernel it belongs to
FAMILIES = {"stream_kernel": "K1", "rs_update_kernel": "K5",
            "fold_kernel": "K3", "ag_hop_kernel": "K2"}


def family(kernel_name: str):
    """The family of a device kernel's name, or None."""
    for key, fam in FAMILIES.items():
        if key in kernel_name and "fold_update_kernel" not in kernel_name:
            return fam
    return None


def plan(elems: Sequence[int], n: int, bucket_bytes: int,
         itemsize: int) -> List[Dict[str, int]]:
    """Buckets of one dtype: per bucket its element count, padded count
    and shard length."""
    out, cur, cur_bytes = [], 0, 0
    for e in elems:
        cur += int(e)
        cur_bytes += int(e) * itemsize
        if bucket_bytes > 0 and cur_bytes >= bucket_bytes:
            out.append(cur)
            cur, cur_bytes = 0, 0
    if cur:
        out.append(cur)
    res = []
    for e in out:
        padded = -(-e // n) * n
        res.append({"elems": e, "padded": padded, "shard": padded // n})
    return res


def kernel_bytes(buckets, n: int, mode: str, itemsize: int,
                 momentum: bool = True) -> Dict[str, Dict[str, int]]:
    """Per rank and step: each family's launches, bytes and peer
    bytes."""
    out = {f: {"launches": 0, "bytes": 0, "peer": 0}
           for f in ("K1", "K2", "K3", "K5")}

    def add(fam, launches, nbytes, peer):
        out[fam]["launches"] += launches
        out[fam]["bytes"] += nbytes
        out[fam]["peer"] += peer

    for b in buckets:
        kb = b["shard"] * itemsize
        if mode == "ring":
            add("K1", n - 2, (n - 2) * 3 * kb, (n - 2) * kb)
            add("K5", 1, (6 if momentum else 4) * kb, kb)
        elif mode == "linear":
            add("K3", 1, (n + 1) * kb, (n - 1) * kb)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        add("K2", n, n * 2 * kb, (n - 1) * kb)
    return {f: v for f, v in out.items() if v["launches"]}


def step_bytes(params: int, n: int, itemsize: int) -> Dict[str, float]:
    """Per rank and step: the bytes the step must move, and the part that
    comes from other ranks."""
    pb = params * itemsize
    return {"bytes": pb + 4 * pb / n + pb,
            "peer": 2 * pb * (n - 1) / n}
