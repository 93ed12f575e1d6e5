"""Mean of the benchmark's span around ``Codec.plan_for`` (phases 1-3,
ended by a synchronise) over the traced reads, where the span built a
plan; nothing where every plan came from the cache."""


def read(m):
    spans = m["spans"]["plan"]
    if m["op"] != "read" or not spans or m["plan_builds"] == 0:
        return None
    return sum(spans) / len(spans) * 1e3
