"""Parameters and decode caches across from the JAX package's layout.

The reference's parameter tree (``src/repro/models/transformer.py``
``init_model``) stacks each per-layer leaf on axis 0; the port keeps a list
of per-layer dicts.  So a tree crosses by a rename and an unstack:
``params["layers"]["attn"]["wq"][i]`` there is ``params["layers"][i]["attn"]
["wq"]`` here.  The trees come and go as numpy arrays (``jax.tree.map(
np.asarray, ...)`` on the other side); bfloat16 arrays (``ml_dtypes``) cross
through their 16-bit patterns.  Decode caches keep the same keys and
stacked layouts on both sides.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


def to_torch(a, device="cuda"):
    """A copy of numpy array ``a`` (bfloat16 included) as a torch tensor on
    ``device``.  Always a copy: ``np.asarray`` of a JAX array may share its
    buffer, which the port's in-place cache updates must not write."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def to_numpy(t):
    """A torch tensor as a numpy array; bfloat16 becomes float32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(tree, i):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_jax(np_tree, cfg: ModelConfig, device="cuda"):
    """The port's parameters from the reference's tree of numpy arrays."""
    out = {}
    for key, sub in np_tree.items():
        if key == "layers":
            out[key] = [_map(_unstack(sub, i),
                             lambda a: to_torch(a, device))
                        for i in range(cfg.n_layers)]
        elif key in ("embed", "unembed", "final_norm"):
            out[key] = to_torch(sub, device)
        else:
            raise NotImplementedError(
                f"parameter group {key!r} belongs to a family not ported "
                f"yet (ROADMAP A10)")
    return out


def cache_from_jax(np_cache, device="cuda"):
    """A decode cache (same keys and layouts) from numpy arrays."""
    return {k: to_torch(v, device) for k, v in np_cache.items()}


def cache_to_numpy(cache):
    """A decode cache as numpy arrays (bfloat16 as float32)."""
    return {k: to_numpy(v) for k, v in cache.items()}
