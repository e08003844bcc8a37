"""kernel_launches_per_step: launches of the port's K1, K2, K3, K5 and
K5b wrappers (each wrapper counts its own) per step, summed over ranks;
over a traced run's last phase (``Run.counted``). A count; nothing where
no kernel ran (the CPU platform runs their plain versions)."""


def read(run):
    total = sum(c["launches"] / c["steps"] for c in map(run.counted,
                                                        run.ranks)
                if c["steps"])
    return total or None
