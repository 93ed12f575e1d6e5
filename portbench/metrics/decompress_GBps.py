"""Float32 bytes reconstructed in the window over the window's time."""


def read(m):
    if m["op"] != "read":
        return None
    return m["ops"] * m["bytes_per_op"] / m["elapsed_s"] / 1e9
