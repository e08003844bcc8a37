"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
full 700 W power limit): HBM3 at 3.35 TB/s, and fourth-generation
NVLink at 900 GB/s a card in both directions together, 450 GB/s in
each. A card set below 700 W reaches less; the harness prints the
card's power limit beside every run."""

HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 450e9


def bound_s(hbm_bytes: float, link_bytes: float) -> float:
    """The least time in which a card moves ``hbm_bytes`` through its
    HBM and ``link_bytes`` in over NVLink: the larger of the two."""
    return max(hbm_bytes / HBM_BYTES_PER_S, link_bytes / NVLINK_BYTES_PER_S)
