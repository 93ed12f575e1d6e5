"""Host time a traced read spends in the spans of its device-to-host reads
and host-to-device uploads (``repro_torch.*.sync``, ``repro_torch.*.h2d``)."""

from portbench.metrics._spans import per_read


def read(m):
    s = per_read(m, "host_s", (".sync", ".h2d"))
    return None if s is None else s * 1e3
