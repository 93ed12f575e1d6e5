"""Launch counters of every CUDA kernel wrapper, in one place.

Each wrapper is registered with :func:`counted` where it is defined and
adds one to its ``launches`` attribute (through :func:`launched`) where it
launches its kernel, and nowhere else.  A run can zero every count with
:func:`reset`, drive a path, and read :func:`counts` to see which kernels
that path went through.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
#: Every registered kernel wrapper by name, in registration order.
KERNELS: dict = {}


def counted(wrapper):
    """Register ``wrapper`` (a decorator): ``wrapper.launches`` starts at 0."""
    wrapper.launches = 0
    KERNELS[wrapper.__name__] = wrapper
    return wrapper


def launched(wrapper):
    with _lock:
        wrapper.launches += 1


def reset():
    """Zero the launch counters of every registered kernel wrapper."""
    with _lock:
        for wrapper in KERNELS.values():
            wrapper.launches = 0


def counts() -> dict:
    """``{name: launches}`` of every registered kernel wrapper."""
    with _lock:
        return {name: w.launches for name, w in KERNELS.items()}
