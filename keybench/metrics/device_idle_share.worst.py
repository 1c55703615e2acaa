"""Device idle share of the idlest card: 1 - its union of device ops'
intervals / the profiled windows' wall (the interval their busy time is
measured over), the largest over the cards of the run."""


def read(rec):
    wall = sum(s["wall_s"] for s in rec["samples"])
    if not wall:
        return None
    busy = [sum(card) for card in
            zip(*(s["busy_by_device"] for s in rec["samples"]))]
    return 100.0 * (1.0 - min(busy) / wall)
