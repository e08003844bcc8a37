"""kernel_roofline: the bytes that the port's collective kernels (K1
``stream_kernel``, K2 ``ag_hop_kernel``, K3 ``fold_kernel``, K5
``rs_update_kernel``) of all ranks on a card must move in the profiled
steps, as ``benchmark/roofline/zero_step.py`` counts them from the
bucket plan, over what the card could move in the union of the time
those kernels occupy it (HBM at 3.35 TB/s; bytes read from another card
over NVLink at 450 GB/s; the larger bound applies); the mean over
cards. Nothing where the trace's launches of a family differ from the
plan's count."""

from benchmark.lib import stats
from benchmark.roofline import peaks, zero_step


def read(run):
    n_prof = run.prof_steps()
    if not n_prof:
        return None
    per_rank = zero_step_bytes(run)
    shares = []
    for recs in run.cards().values():
        w = run.card_window(recs)
        if w is None:
            return None
        ops = [o for o in run.card_ops(recs)
               if zero_step.family(o[0]) is not None]
        got = {}
        for o in ops:
            f = zero_step.family(o[0])
            got[f] = got.get(f, 0) + 1
        want = {f: v["launches"] * n_prof * len(recs)
                for f, v in per_rank.items()}
        if got != want:
            return None
        busy_s = stats.covered(((o[1], o[2]) for o in ops), *w) / 1e9
        nbytes = sum(v["bytes"] for v in per_rank.values()) * n_prof \
            * len(recs)
        link = sum(v["peer"] for v in per_rank.values()) * n_prof \
            * len(recs) if len(recs) == 1 and run.chips > 1 else 0
        shares.append(peaks.bound_s(nbytes, link) / busy_s * 100.0)
    return sum(shares) / len(shares)


def zero_step_bytes(run):
    import torch

    from benchmark.lib import model

    cfg, tr = run.config, run.traffic
    item = getattr(torch, run.lead["dtype"]).itemsize
    elems = [model.numel(s) for _, s in model.leaves(cfg)]
    n = int(cfg["deployment"]["ranks"])
    buckets = zero_step.plan(elems, n, int(cfg["deployment"]["bucket_bytes"]),
                             item)
    mode = "linear" if tr["deterministic"] == "linear" else "ring"
    return zero_step.kernel_bytes(buckets, n, mode, item,
                                  momentum=bool(cfg["optimizer"]["momentum"]))
