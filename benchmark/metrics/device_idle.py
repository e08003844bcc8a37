"""device_idle: the share of the profiled window in which no device
operation of any rank runs on the card (the union over the card's
ranks, from ``torch.profiler``'s trace); in a cell of several cards the
mean over cards."""


def read(run):
    b = run.busy()
    if b is None or b[1] <= 0:
        return None
    return (1.0 - b[0] / b[1]) * 100.0
