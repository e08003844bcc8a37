"""device_mem_GiB: the most device memory in use on any card during the
window, card-wide (``torch.cuda.mem_get_info`` after every step, read by
the lowest rank on each card): the port's arenas are allocated outside
torch's allocator, and every rank of a card counts."""


def read(run):
    mem = [r["mem_used_bytes"] for r in run.ranks if r["mem_used_bytes"]]
    return max(mem) / float(1 << 30) if mem else None
