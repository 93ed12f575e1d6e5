"""Random-input cases of the model kernels, shared by the card tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py``.

Each case is small and ragged on purpose: GQA groups 1, 2 and 8, ``Dv !=
D``, ``Sq != Skv``, lengths that are no multiple of a tile; for the
recurrence S of 1, 77 and 1000, a hard forget (``w = 1e-6``), ``u != 0``
and a non-zero initial state.  The edges of the kernels' tiles: for flash,
``D`` and ``Dv`` that are no multiple of 16 (zero-padded in shared memory)
or of 8 (staged by plain loads, not 16-byte copies), ``Skv`` shorter than
one 64-row kv tile, ``Sq`` and ``Skv`` one off a multiple of 64, and a
scale other than the default; the sliding window at 1, 16 (inside one
tile), 63, 64 and 65 (one off the tile), at least ``Skv`` (no window),
without the causal mask, with ``q_offset`` and with GQA 8; qwen2-moe's
layer shape (GQA 1, D 128, causal, no window); multi-head latent
attention's (GQA 1, D 192 over Dv 128, and D 160 padded to the 192
template, and D 192 over Dv 64), causal and not; for the recurrence, ``dv``
that is no
multiple of the 16 columns a block owns, ``dk`` 8 and widths that are no
multiple of 4 floats.  Inputs are made with numpy from a seed, then
moved to the device asked for.
"""

from __future__ import annotations

import numpy as np
import torch

#: (name, BH, Sq, Skv, D, Dv, groups, causal, scale, window, q_offset);
#: scale None is the default ``D ** -0.5``, window None no window.
FLASH_CASES = [
    ("square", 2, 128, 128, 32, 32, 1, True, None, None, 0),
    ("full", 2, 128, 128, 32, 32, 1, False, None, None, 0),
    ("rect_sq_gt_skv", 1, 256, 128, 64, 64, 1, True, None, None, 0),
    ("rect_sq_lt_skv", 2, 70, 200, 64, 64, 1, False, None, None, 0),
    ("dv_ne_d", 3, 128, 128, 16, 32, 1, True, None, None, 0),
    ("gqa2_ragged", 8, 77, 77, 128, 128, 2, True, None, None, 0),
    ("gqa8_ragged", 16, 1000, 1000, 128, 128, 8, True, None, None, 0),
    ("one_query", 4, 1, 33, 128, 128, 2, False, None, None, 0),
    ("d40_dv72", 2, 100, 100, 40, 72, 1, True, None, None, 0),
    ("d33_dv20_plain_loads", 3, 65, 70, 33, 20, 1, True, None, None, 0),
    ("skv_shorter_than_tile", 2, 96, 20, 64, 64, 1, False, None, None, 0),
    ("off_by_one_gqa2", 4, 127, 129, 128, 128, 2, True, None, None, 0),
    ("scale_2", 2, 130, 130, 64, 64, 2, True, 2.0, None, 0),
    ("window_1", 2, 130, 130, 64, 64, 1, True, None, 1, 0),
    ("window_16_gqa2", 4, 200, 200, 64, 64, 2, True, None, 16, 0),
    ("window_63", 2, 257, 257, 128, 128, 1, True, None, 63, 0),
    ("window_64", 2, 257, 257, 64, 64, 1, True, None, 64, 0),
    ("window_65_d80", 4, 300, 300, 80, 80, 2, True, None, 65, 0),
    ("window_ge_skv", 2, 130, 130, 32, 32, 1, True, None, 130, 0),
    ("window_not_causal", 2, 150, 150, 64, 64, 1, False, None, 40, 0),
    ("q_offset", 2, 70, 200, 64, 64, 1, True, None, None, 130),
    ("q_offset_window_gqa2", 4, 70, 200, 64, 64, 2, True, None, 48, 130),
    ("window_gqa8", 16, 300, 300, 128, 128, 8, True, None, 100, 0),
    # qwen2-moe-a2.7b's layer: 16 heads over 16 KV heads of 128, causal
    ("moe_layer_gqa1_d128", 4, 256, 256, 128, 128, 1, True, None, None, 0),
    # deepseek-v3's MLA: a 192-wide query/key head over a 128-wide value
    ("mla_d192_dv128", 4, 200, 200, 192, 128, 1, True, None, None, 0),
    ("mla_d192_dv128_full", 2, 130, 77, 192, 128, 1, False, None, None, 0),
    ("mla_d160_dv128_padded", 3, 129, 129, 160, 128, 1, True, None, None,
     0),
    ("mla_d160_dv128_full", 2, 65, 150, 160, 128, 1, False, None, None, 0),
    ("mla_d192_dv64", 3, 150, 150, 192, 64, 1, True, None, None, 0),
    ("mla_d192_dv64_full", 2, 100, 63, 192, 64, 1, False, None, None, 0),
    # zamba2-7b's shared block: heads of 112 (padded to the 128-wide
    # template), GQA 1, a sliding window
    ("hybrid_d112_window_65", 4, 300, 300, 112, 112, 1, True, None, 65, 0),
]

#: (name, BH, S, dk, dv, H, w_low, w_high, with_u, with_state)
GLA_CASES = [
    ("small", 2, 64, 8, 8, 2, 0.1, 0.999, True, False),
    ("dk_ne_dv", 1, 96, 32, 16, 1, 0.1, 0.999, True, True),
    ("decode_step", 160, 1, 64, 64, 40, 0.1, 0.999, True, True),
    ("ragged_77", 6, 77, 64, 64, 3, 0.5, 0.999, True, True),
    ("long_1000", 4, 1000, 64, 64, 2, 0.9, 0.9999, True, True),
    ("hard_forget", 2, 64, 16, 16, 2, 1e-6, 1e-6, False, False),
    ("dv_24", 3, 50, 64, 24, 3, 0.1, 0.999, True, True),
    ("dv_200", 2, 40, 64, 200, 1, 0.1, 0.999, True, True),
    ("dk_8", 4, 70, 8, 64, 2, 0.1, 0.999, True, True),
    ("widths_10_18_plain_loads", 2, 33, 10, 18, 2, 0.1, 0.999, True, True),
]


def flash_kwargs(case) -> dict:
    """The masking and scale keywords of a ``FLASH_CASES`` entry."""
    return dict(zip(("causal", "scale", "window", "q_offset"), case[7:]))


def flash_inputs(case, dtype, device, seed: int = 0):
    """(q, k, v) of a ``FLASH_CASES`` entry, standard normal, in ``dtype``."""
    _, bh, sq, skv, d, dv, groups = case[:7]
    rng = np.random.default_rng(seed + bh * sq + skv + d)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=device, dtype=dtype)

    return t((bh, sq, d)), t((bh // groups, skv, d)), t((bh // groups, skv,
                                                         dv))


def gla_inputs(case, device, seed: int = 0):
    """(r, k, v, w, u, state) of a ``GLA_CASES`` entry, float32."""
    _, bh, s, dk, dv, h, w_lo, w_hi, with_u, with_state = case
    rng = np.random.default_rng(seed + bh * s + dk)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    r = t(rng.standard_normal((bh, s, dk)))
    k = t(rng.standard_normal((bh, s, dk)))
    v = t(rng.standard_normal((bh, s, dv)))
    w = t(rng.uniform(w_lo, w_hi, (bh, s, dk)) if w_hi > w_lo
          else np.full((bh, s, dk), w_lo))
    u = t(rng.standard_normal((h, dk)) if with_u else np.zeros((h, dk)))
    state = t(rng.standard_normal((bh, dk, dv))) if with_state else None
    return r, k, v, w, u, state


def bf16_ulp(scale: float) -> float:
    """One bfloat16 ulp at magnitude ``scale`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(scale, 2.0 ** -126))) - 7)
