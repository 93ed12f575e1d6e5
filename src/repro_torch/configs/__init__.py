"""Architecture registry: ``--arch <id>`` resolves here.

Port of ``src/repro/configs/__init__.py``: the ten configs and the shape
cells (``shapes.py``, ``cells``), copied as they are.
"""

from __future__ import annotations

from repro_torch.configs import shapes  # noqa: F401
from repro_torch.configs.shapes import SHAPES, ShapeCell  # noqa: F401

from repro_torch.configs.qwen3_0_6b import CONFIG as _qwen3
from repro_torch.configs.starcoder2_15b import CONFIG as _sc2
from repro_torch.configs.h2o_danube_1_8b import CONFIG as _danube
from repro_torch.configs.qwen2_5_3b import CONFIG as _qwen25
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen2moe
from repro_torch.configs.deepseek_v3_671b import CONFIG as _dsv3
from repro_torch.configs.rwkv6_3b import CONFIG as _rwkv6
from repro_torch.configs.qwen2_vl_72b import CONFIG as _qwen2vl
from repro_torch.configs.whisper_base import CONFIG as _whisper

REGISTRY = {
    c.name: c
    for c in [_qwen3, _sc2, _danube, _qwen25, _zamba2, _qwen2moe, _dsv3,
              _rwkv6, _qwen2vl, _whisper]
}

ARCH_IDS = list(REGISTRY)


def get_config(arch: str):
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return REGISTRY[arch]


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells, honoring the long_500k skip rule."""
    out = []
    for name, cfg in REGISTRY.items():
        for sname, cell in SHAPES.items():
            skip = sname == "long_500k" and not cfg.is_subquadratic
            if skip and not include_skipped:
                continue
            out.append((name, sname, skip))
    return out
