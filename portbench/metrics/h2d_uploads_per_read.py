"""Host-to-device uploads a traced read: the spans ``repro_torch.*.h2d``
(one a ``_as_luts`` call, which uploads both of its tables)."""

from portbench.metrics._spans import per_read


def read(m):
    return per_read(m, "n", (".h2d",))
