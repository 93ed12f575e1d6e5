"""The paper's decoder rate: the uint16 quantization codes a traced read
decodes (half the float32 field's bytes) over the device time of the Huffman
decode, the kernels and copies launched inside ``repro_torch.plan``
(phases 1-3, where a plan is built) and ``repro_torch.decode.phase4``."""

from portbench.metrics._spans import spans

PHASES = ("repro_torch.plan", "repro_torch.decode.phase4")


def read(m):
    s = spans(m)
    if s is None or PHASES[1] not in s:
        return None
    device_s = sum(s[name]["device_s"] for name in PHASES if name in s)
    if device_s <= 0:
        return None
    return m["ops"] * m["bytes_per_op"] / 2 / device_s / 1e9
