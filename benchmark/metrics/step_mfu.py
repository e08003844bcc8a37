"""step_mfu: the whole step's share of the card's peak, the least time
the step's required bytes could take on a card (the gradients read
once, the shard and its momentum read and written once, the gathered
parameters written once, for every rank on the card; with one rank per
card, (n - 1) / n of the gradients and of the parameters in over
NVLink), over the time a step took in the traced run's first fifth,
which runs with no instrument on (rank 0's clock: the window's start to
the end of the last such step, over their count). Bytes, not
operations: a ZeRO step is bandwidth work. Nothing without a card."""

from benchmark.lib import model
from benchmark.roofline import peaks, zero_step


def read(run):
    import torch

    lead, k = run.lead, run.lead.get("plain_steps")
    if not k or not lead["device"].startswith("cuda"):
        return None
    per_step = sum(lead["step_s"][:k]) / k
    cfg = run.config
    item = getattr(torch, lead["dtype"]).itemsize
    n = int(cfg["deployment"]["ranks"])
    need = zero_step.step_bytes(model.param_count(cfg), n, item)
    shares = []
    for recs in run.cards().values():
        k_card = len(recs)
        link = need["peer"] * k_card if k_card == 1 and run.chips > 1 else 0
        shares.append(peaks.bound_s(need["bytes"] * k_card, link) / per_step
                      * 100.0)
    return sum(shares) / len(shares)
