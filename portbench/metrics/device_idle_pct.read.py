"""Idle share of the device in a traced read window."""

from portbench.metrics._idle import idle


def read(m):
    return idle(m, "read")
