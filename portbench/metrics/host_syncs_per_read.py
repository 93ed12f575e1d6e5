"""Host waits on the device a traced read: the spans ``repro_torch.*.sync``
around every device-to-host read of the read path."""

from portbench.metrics._spans import per_read


def read(m):
    return per_read(m, "n", (".sync",))
