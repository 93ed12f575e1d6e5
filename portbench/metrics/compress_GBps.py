"""Float32 bytes compressed in the window over the window's time."""


def read(m):
    if m["op"] != "write":
        return None
    return m["ops"] * m["bytes_per_op"] / m["elapsed_s"] / 1e9
