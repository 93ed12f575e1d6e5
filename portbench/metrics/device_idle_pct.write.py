"""Idle share of the device in a traced write window."""

from portbench.metrics._idle import idle


def read(m):
    return idle(m, "write")
