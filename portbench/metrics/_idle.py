"""Shared arithmetic of the idle readers: the share of the traced window
in which no operation ran on the device."""


def idle(m, op):
    t = m["trace"]
    if m["op"] != op or t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
