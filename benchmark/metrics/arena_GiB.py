"""arena_GiB: the port's high watermark ``device_plane_arena_bytes``
(the bytes of a rank's mapped arenas), summed over the ranks of a card;
the largest card."""


def read(run):
    per_card = [sum(r["arena_bytes"] for r in recs)
                for recs in run.cards().values()]
    top = max(per_card)
    return top / float(1 << 30) if top else None
