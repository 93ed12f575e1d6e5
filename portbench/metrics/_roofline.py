"""Shared arithmetic of the roofline readers: the least time the traced
operations need (the compressed field and the float32 field, each moved
once, at the card's HBM peak) over the device's busy time."""


def share(m, op):
    t = m["trace"]
    if m["op"] != op or t is None or not m["ops"] or m["peaks"] is None \
            or t["busy_s"] <= 0:
        return None
    least_s = m["ops"] * m["least_bytes_per_op"] / m["peaks"]["hbm_bytes_per_s"]
    return 100.0 * least_s / t["busy_s"]
