"""Parameter / activation sharding rules (ZeRO-3 + TP + EP) over
``DeviceMesh`` and DTensor placements.

Port of ``src/repro/runtime/sharding.py``.  JAX's ``PartitionSpec`` and
``NamedSharding`` become this module's own small types: ``P`` is a tuple
of mesh-axis entries per tensor dimension (``None``, an axis name or a
tuple of names), and ``NamedSharding(mesh, spec)`` keeps the mesh -- a
torch ``DeviceMesh``, or a layout object (``{axis: size}`` mapping, or a
``shape`` mapping beside ``axis_names``) for the rules alone -- and turns
the spec into DTensor ``Shard`` / ``Replicate`` placements and the index
of each mesh coordinate.

Rules are keyed on (path substring, trailing-ndim) of each parameter leaf;
stacked-layer leading dims are never sharded.  Every axis assignment is
divisibility-checked against the mesh: a dim too small for its axis falls
back to replication (e.g. kv_heads=2 on a 16-way model axis).

Scheme:
  * "model": heads / d_ff / experts / vocab  (TP + EP + vocab-parallel)
  * ("pod","data"): the other large dim of every matrix  (ZeRO-3 / FSDP)
  * activations: batch on ("pod","data")
"""

from __future__ import annotations

import itertools
import os

import torch
import torch.utils._pytree as pytree
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed import partition as pt
from repro_torch.launch.mesh import axis_names_of, batch_axes, model_axis


class PartitionSpec(tuple):
    """Mesh axes per tensor dimension: ``None`` (replicated), an axis name,
    or a tuple of names (the dimension split over their product, the first
    name major).  A one-name tuple is stored as the name, as JAX's
    ``PartitionSpec`` normalizes it."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            p[0] if isinstance(p, tuple) and len(p) == 1
            else tuple(p) if isinstance(p, (tuple, list)) else p
            for p in parts))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """A ``PartitionSpec`` over a mesh: the port's twin of
    ``jax.sharding.NamedSharding``.

    A tensor dimension whose size does not divide over its axes stays
    whole, as ``partition.spec_parts`` (and the sharded layout) has it,
    where DTensor's ``Shard`` would split it unevenly.  A dimension split
    over several axes maps to one ``Shard(d)`` a mesh dimension, which is
    JAX's row-major block order only when the axes are in mesh order; a
    spec with them out of order raises ``ValueError``.
    """

    def __init__(self, mesh, spec=None):
        self.mesh = mesh
        self.spec = P(*spec) if spec is not None else P()

    def __repr__(self):
        return f"NamedSharding(mesh={self.mesh!r}, spec={self.spec!r})"

    def _grid(self, shape) -> tuple:
        """``(axis names, axis sizes, parts per dim, axes per split dim)``
        of ``shape`` under this sharding."""
        names = axis_names_of(self.mesh)
        sizes = pt.axis_sizes_of(self.mesh)
        shape = tuple(int(s) for s in shape)
        parts = pt.spec_parts(self.spec, shape, sizes)
        split = {}
        for d, n in enumerate(parts):
            if n > 1:
                axes = _axes(self.spec[d])
                order = [names.index(a) for a in axes]
                if order != sorted(order):
                    raise ValueError(
                        f"spec {self.spec} splits dim {d} over {axes}, out "
                        f"of the mesh's axis order {names}: a DTensor "
                        f"splits a dim over mesh dims in mesh order only")
                split[d] = axes
        return names, sizes, parts, split

    def placements(self, shape) -> tuple:
        """DTensor placements of a tensor of ``shape``: one a mesh dim,
        ``Shard(d)`` where the mesh dim splits tensor dim ``d``."""
        names, _, _, split = self._grid(shape)
        out = [Replicate()] * len(names)
        for d, axes in split.items():
            for a in axes:
                i = names.index(a)
                if out[i] != Replicate():
                    raise ValueError(f"spec {self.spec} uses mesh axis "
                                     f"{a!r} twice")
                out[i] = Shard(d)
        return tuple(out)

    def index(self, shape, coordinate=None) -> tuple:
        """The slices of a tensor of ``shape`` that the mesh coordinate
        ``coordinate`` (default: this rank's) holds."""
        if coordinate is None:
            coordinate = self.mesh.get_coordinate()
            if coordinate is None:
                raise ValueError("this rank is not in the sharding's mesh")
        names, sizes, parts, split = self._grid(shape)
        out = []
        for d, dim in enumerate(shape):
            step = int(dim) // parts[d]
            block = 0
            for a in split.get(d, ()):
                block = block * sizes[a] + int(coordinate[names.index(a)])
            out.append(slice(block * step, (block + 1) * step))
        return tuple(out)

    def devices_indices_map(self, shape) -> dict:
        """``{mesh coordinate: index}`` over every coordinate of the mesh,
        the counterpart of JAX's ``devices_indices_map`` keyed by where a
        device sits in the mesh."""
        sizes = pt.axis_sizes_of(self.mesh)
        grid = [range(sizes[a]) for a in axis_names_of(self.mesh)]
        return {c: self.index(shape, c) for c in itertools.product(*grid)}

    def wrap(self, local: torch.Tensor, shape) -> DTensor:
        """This rank's piece ``local`` of a global tensor of ``shape`` as a
        ``DTensor`` on the mesh, in this sharding's placements (checked:
        the counterpart of the reference's ``is_equivalent_to`` assert)."""
        if not isinstance(self.mesh, DeviceMesh):
            raise TypeError(f"a DTensor needs a DeviceMesh, not "
                            f"{type(self.mesh).__name__}")
        shape = torch.Size(int(s) for s in shape)
        placements = self.placements(shape)
        if local.device.type != self.mesh.device_type:
            local = local.to(self.mesh.device_type)
        stride = torch.empty(shape, device="meta").stride()
        out = DTensor.from_local(local, self.mesh, placements, shape=shape,
                                 stride=stride, run_check=False)
        if tuple(out.placements) != placements:
            raise RuntimeError(f"a tensor of shape {tuple(shape)} did not "
                               f"land in its target placements "
                               f"{placements}: {out.placements}")
        return out

    def distribute(self, full: torch.Tensor) -> DTensor:
        """``full`` (the global tensor, on every rank) cut to this rank's
        piece and wrapped: no collective runs."""
        return self.wrap(full[self.index(full.shape)].contiguous(),
                         full.shape)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = pt.axis_sizes_of(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _fit(mesh, dim_size: int, axes):
    """Return ``axes`` if the dim divides evenly over them, else None
    (replication: the rule set must route the sharding to a dim that
    divides, e.g. expert-TP instead of EP for 60 experts)."""
    n = _axis_size(mesh, axes)
    if n <= 1:
        return None
    if dim_size % n == 0:
        return axes
    return None


def param_spec(path: str, shape: tuple, mesh) -> P:
    """PartitionSpec for one parameter leaf."""
    fsdp = batch_axes(mesh)
    tp = model_axis(mesh)
    nd = len(shape)

    def spec(*trailing):
        """Pad with None for stacked leading dims, divisibility-check."""
        lead = nd - len(trailing)
        checked = tuple(_fit(mesh, shape[lead + i], ax)
                        for i, ax in enumerate(trailing))
        return P(*((None,) * lead + checked))

    # --- order matters: more specific substrings first ---
    if "moe/router" in path or path.endswith("router"):
        return spec(fsdp, None)                       # (d, E)
    if "moe/shared" in path:
        if path.endswith("wd"):
            return spec(tp, fsdp)                     # (ds, d)
        return spec(fsdp, tp)                         # (d, ds)
    if "moe/" in path:
        # Expert-TP (default): every expert's FFN is sharded over "model"
        # (d_expert) and "data" (d_model).  REPRO_MOE_SHARDING=ep switches
        # to expert-parallel (E on "model", d_model on fsdp).
        if os.environ.get("REPRO_MOE_SHARDING", "tp") == "ep":
            if path.endswith("wd"):
                return spec(tp, None, fsdp)           # (E, de, d)
            return spec(tp, fsdp, None)               # (E, d, de)
        if path.endswith("wd"):
            return spec(None, tp, fsdp)               # (E, de, d)
        return spec(None, fsdp, tp)                   # (E, d, de)

    # --- MLA ---
    if path.endswith(("wdq", "wdkv")):
        return spec(fsdp, None)                       # (d, r)
    if path.endswith(("wuq", "wuk", "wuv")):
        return spec(None, tp, None)                   # (r, h, e)

    # --- attention ---
    if path.endswith(("attn/wq", "attn/wk", "attn/wv", "xattn/wq",
                      "xattn/wk", "xattn/wv")):
        return spec(fsdp, tp, None)                   # (d, h, dh)
    if path.endswith(("attn/wo", "xattn/wo")):
        return spec(tp, None, fsdp)                   # (h, dh, d)
    if path.endswith(("bq", "bk", "bv")):
        return spec(tp, None)                         # (h, dh)

    # --- MLP ---
    if path.endswith(("mlp/wg", "mlp/wu", "mlp/wi", "cmix/wk")):
        return spec(fsdp, tp)                         # (d, ff)
    if path.endswith(("mlp/wd", "mlp/wo", "cmix/wv")):
        return spec(tp, fsdp)                         # (ff, d)

    # --- SSM / RWKV ---
    if path.endswith("ssm/win"):
        return spec(fsdp, tp)
    if path.endswith("ssm/wout"):
        return spec(tp, fsdp)
    if path.endswith(("tmix/wr", "tmix/wk", "tmix/wv", "tmix/wg", "cmix/wr")):
        return spec(fsdp, tp)                         # (d, d)
    if path.endswith("tmix/wo"):
        return spec(tp, fsdp)
    if path.endswith("w_lora_a"):
        return spec(fsdp, None)
    if path.endswith("w_lora_b"):
        return spec(None, fsdp)

    # --- embeddings / heads ---
    if path.endswith(("embed", "unembed")):
        # vocab-parallel only: FSDP on d would put the "data" axis on the
        # contraction dim of the CE dots whose batch dim is also "data".
        return spec(tp, None)                         # (V, d)
    if path.endswith("mtp/fuse"):
        return spec(fsdp, None)

    # --- everything else (norms, biases, scalars): replicate ---
    return P()


def _path_str(key_path) -> str:
    parts = []
    for k in key_path:
        if hasattr(k, "key"):
            parts.append(str(k.key))
        elif hasattr(k, "idx"):
            parts.append(str(k.idx))
        else:
            parts.append(str(k))
    return "/".join(parts)


def param_shardings(params_shape, mesh):
    """NamedSharding tree matching a params (shape-)tree: a
    ``torch.utils._pytree`` tree whose leaves have a ``shape``."""

    def leaf(kp, x):
        return NamedSharding(mesh, param_spec(_path_str(kp), x.shape, mesh))

    return pytree.tree_map_with_path(leaf, params_shape)


def opt_state_shardings(opt_shape, mesh, params_shape=None):
    """Optimizer-state sharding.

    fp32 m/v mirror the param spec.  int8 block-quantized leaves ("q",
    "scale") keep the param shape, so the same spec applies (re-checked for
    divisibility by ``param_spec`` itself).
    """

    def leaf(kp, x):
        path = _path_str(kp)
        if path.endswith("step"):
            return NamedSharding(mesh, P())
        # strip the leading "m/"/"v/" and any quantized-leaf suffix so the
        # state leaf reuses its param's rules.
        sub = path.split("/", 1)[1] if "/" in path else path
        for suffix in ("/q", "/scale", "/f"):
            if sub.endswith(suffix):
                sub = sub[: -len(suffix)]
                break
        return NamedSharding(mesh, param_spec(sub, x.shape, mesh))

    return pytree.tree_map_with_path(leaf, opt_shape)


def batch_shardings(batch_shape, mesh):
    """Input batch: shard the leading (batch) dim over ("pod","data")."""
    fsdp = batch_axes(mesh)

    def leaf(x):
        if x.ndim == 0:
            return NamedSharding(mesh, P())
        ax = _fit(mesh, x.shape[0], fsdp)
        return NamedSharding(mesh, P(*((ax,) + (None,) * (x.ndim - 1))))

    return pytree.tree_map(leaf, batch_shape)


def cache_shardings(cache_shape, mesh, cfg=None):
    """Decode caches: (L, B, S, H, Dh) -- batch on fsdp, heads on model.

    For batch=1 the batch axis falls back to replication via the
    divisibility check; heads still shard on "model".
    """
    fsdp = batch_axes(mesh)
    tp = model_axis(mesh)

    def leaf(kp, x):
        name = _path_str(kp).rsplit("/", 1)[-1]
        b_ax = _fit(mesh, x.shape[1], fsdp) if x.ndim >= 2 else None
        if name in ("k_scale", "v_scale"):      # (L, B, S, Hkv)
            h_ax = _fit(mesh, x.shape[3], tp)
            return NamedSharding(mesh, P(None, b_ax, None, h_ax))
        if name in ("k", "v", "xk", "xv"):      # (L, B, S, Hkv, D)
            h_ax = _fit(mesh, x.shape[3], tp)
            if h_ax is not None:
                return NamedSharding(mesh, P(None, b_ax, None, h_ax, None))
            # kv heads too few for the model axis: sequence-shard the cache
            s_ax = _fit(mesh, x.shape[2], tp)
            return NamedSharding(mesh, P(None, b_ax, s_ax, None, None))
        if name in ("ssm", "state"):            # (L, B, H, N/dk, P/dv)
            h_ax = _fit(mesh, x.shape[2], tp)
            return NamedSharding(mesh, P(None, b_ax, h_ax, None, None))
        if name == "latent":                    # (L, B, S, kvr+dr)
            w_ax = _fit(mesh, x.shape[3], tp)
            return NamedSharding(mesh, P(None, b_ax, None, w_ax))
        if x.ndim == 3:                         # (L, B, d) shift carries
            return NamedSharding(mesh, P(None, b_ax, None))
        return NamedSharding(mesh, P())

    return pytree.tree_map_with_path(leaf, cache_shape)
