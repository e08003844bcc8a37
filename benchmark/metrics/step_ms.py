"""step_ms: the window's wall time over the whole steps it completed, on
rank 0's clock (each step ends in ``torch.cuda.synchronize()``)."""


def read(run):
    lead = run.lead
    if not lead["steps"]:
        return None
    return lead["window_s"] / lead["steps"] * 1e3
