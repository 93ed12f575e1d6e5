"""Parameters and decode caches across from the JAX package's layout.

The reference's parameter tree (``src/repro/models/transformer.py``
``init_model``) stacks each per-layer leaf on axis 0; the port keeps a list
of per-layer dicts.  So a tree crosses by a rename and an unstack:
``params["layers"]["attn"]["wq"][i]`` there is ``params["layers"][i]["attn"]
["wq"]`` here (the encdec family's ``params["encoder"]`` and the moe
family's ``params["dense_layers"]`` likewise), and ``stack_layers`` goes
back.  The trees come and go as numpy arrays
(``jax.tree.map(np.asarray, ...)`` on the other side);
bfloat16 arrays (``ml_dtypes``) cross through their 16-bit patterns.
Decode caches keep the same keys and stacked layouts on both sides.
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


def _first(tree):
    """The first leaf of a tree of dicts."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _unstack(tree, i):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


#: The parameter groups whose leaves stack a layer on axis 0 in the
#: reference's tree (a list of per-layer dicts here): the layers, the
#: encdec family's encoder and the moe family's dense prefix
#: (``first_k_dense``).  A group's layer count is its arrays' leading
#: dimension.
STACKED = ("layers", "encoder", "dense_layers")
#: The groups that cross as they are.
PLAIN = ("embed", "unembed", "final_norm", "enc_norm")


def params_from_jax(np_tree, cfg: ModelConfig, device="cuda"):
    """The port's parameters from the reference's tree of numpy arrays,
    made for ``cfg``; each stacked group crosses as many layers as its
    arrays' leading dimension holds.  A leaf may be a dict of arrays (an
    int8 optimizer-state leaf, ``{"q", "scale"}`` or ``{"f"}``): each of
    its arrays crosses the same way."""
    out = {}
    for key, sub in np_tree.items():
        if key in STACKED:
            out[key] = [_map(_unstack(sub, i),
                             lambda a: to_torch(a, device))
                        for i in range(np.shape(_first(sub))[0])]
        elif key in PLAIN:
            out[key] = _map(sub, lambda a: to_torch(a, device))
        else:
            raise NotImplementedError(
                f"parameter group {key!r} belongs to a family not ported "
                f"yet (ROADMAP A10)")
    return out


def stack_layers(params):
    """The port's parameters in the reference's layout: each list of
    per-layer dicts (``layers``, ``encoder`` for encdec, ``dense_layers``
    for a moe model with a dense prefix) stacked into
    one dict whose leaves carry the layer on axis 0 (``torch.stack``, on
    the leaves' device); the other groups unchanged.  The inverse of
    ``params_from_jax``'s unstack: a checkpoint of it has the reference's
    entry names (``params.layers.attn.wq``, shape ``[n_layers, ...]``)."""
    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        return torch.stack(items)

    return {key: stack(sub) if key in STACKED else sub
            for key, sub in params.items()}


def unstack_layers(tree):
    """The inverse of ``stack_layers``: each stacked group's leaves (dicts
    of them included) split along axis 0 into the port's list of per-layer
    dicts; the other groups unchanged.  A tree restored from a
    checkpoint crosses back this way."""
    def pick(t, i):
        if isinstance(t, dict):
            return {k: pick(v, i) for k, v in t.items()}
        return t[i]

    out = dict(tree)
    for key in STACKED:
        if key in tree:
            n = _first(tree[key]).shape[0]
            out[key] = [pick(tree[key], i) for i in range(n)]
    return out


def tree_to_numpy(tree):
    """A tree of torch tensors (dicts) as numpy arrays (``to_numpy``)."""
    return _map(tree, to_numpy)


def params_to_numpy(params):
    """The port's parameters as the reference's tree of numpy arrays: the
    layers stacked (``stack_layers``), bfloat16 as float32."""
    return tree_to_numpy(stack_layers(params))


def opt_state_from_jax(np_state, cfg: ModelConfig, device="cuda"):
    """The port's AdamW state (``optim/adamw.py``) from the reference's
    ``{"m", "v", "step"}`` as numpy arrays: ``m`` and ``v`` as
    ``params_from_jax`` moves a parameter tree (float32 leaves, or int8
    ``{"q", "scale"}`` / ``{"f"}`` dicts), ``step`` a 0-dim int32 tensor."""
    return {"m": params_from_jax(np_state["m"], cfg, device),
            "v": params_from_jax(np_state["v"], cfg, device),
            "step": to_torch(np.asarray(np_state["step"], np.int32),
                             device)}


def sorted_tree(tree):
    """``tree`` with every dict's keys in sorted order: the order of the
    trees a jitted reference step returns, and so of its checkpoints'
    manifests."""
    if isinstance(tree, dict):
        return {k: sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def opt_state_stacked(state):
    """The port's AdamW state with ``m`` and ``v`` in the reference's layout
    (``stack_layers``), keys sorted: what a checkpoint stores under
    ``opt``."""
    return sorted_tree({"m": stack_layers(state["m"]),
                        "v": stack_layers(state["v"]),
                        "step": state["step"]})


def opt_state_to_numpy(state):
    """The port's AdamW state as the reference's ``{"m", "v", "step"}`` of
    numpy arrays: the inverse of ``opt_state_from_jax``."""
    return tree_to_numpy(opt_state_stacked(state))


def cache_from_jax(np_cache, device="cuda"):
    """A decode cache (same keys and layouts) from numpy arrays: int8 codes
    and float32 scales (``kv_quant``) as they are, bfloat16 through its
    bits."""
    return {k: to_torch(v, device) for k, v in np_cache.items()}


def cache_to_numpy(cache):
    """A decode cache as numpy arrays (bfloat16 as float32; int8 codes and
    float32 scales as they are)."""
    return {k: to_numpy(v) for k, v in cache.items()}
