"""Share of the HBM bound in the device time of the traced compressions."""

from portbench.metrics._roofline import share


def read(m):
    return share(m, "write")
