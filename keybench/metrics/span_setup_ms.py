"""Host ms per sub-range in search.add.center_points (the M group
centers of a span, on the host)."""


def read(rec):
    s = rec["spans"].get("center_points")
    if not s or not s["n"]:
        return None
    return 1e3 * s["s"] / s["n"]
