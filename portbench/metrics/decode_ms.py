"""Mean of the benchmark's span around ``Codec.decompress(c, plan=plan)``
(phase 4 and dequantize, ended by a synchronise) over the traced reads."""


def read(m):
    spans = m["spans"]["decode"]
    if m["op"] != "read" or not spans:
        return None
    return sum(spans) / len(spans) * 1e3
