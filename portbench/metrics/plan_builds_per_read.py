"""``Codec.stats["plan_builds"]`` over the traced window's reads."""


def read(m):
    if m["op"] != "read" or m["trace"] is None or not m["ops"]:
        return None
    return m["plan_builds"] / m["ops"]
