"""Shared arithmetic of the span readers: the program's spans in the traced
window (``spans.reduce``, carried as ``m["trace"]["spans"]``), per read.

A trace without the program's spans (a program that opens none, or a
trace summary that does not carry them) gives nothing to read."""


def spans(m):
    t = m["trace"]
    if m["op"] != "read" or t is None or not m["ops"] or not t.get("spans"):
        return None
    return t["spans"]


def per_read(m, field, suffixes):
    """``field`` summed over the spans whose names end with one of
    ``suffixes``, over the traced reads."""
    s = spans(m)
    if s is None:
        return None
    return sum(v[field] for name, v in s.items()
               if name.endswith(suffixes)) / m["ops"]
