"""Device time a traced read spends in the dequantize: the busy time of the
kernels and copies launched inside ``repro_torch.dequantize``."""

from portbench.metrics._spans import spans


def read(m):
    s = spans(m)
    if s is None or "repro_torch.dequantize" not in s:
        return None
    return s["repro_torch.dequantize"]["device_s"] / m["ops"] * 1e3
