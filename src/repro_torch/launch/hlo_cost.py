"""Cost of one step of the port, counted over its eager op trace.

Port of ``src/repro/launch/hlo_cost.py``, under the same name so the two
trees pair up.  It reads no HLO: the reference walks the partitioned HLO
text of a compiled program, and the port has no compiler that makes one.
What the port runs is an eager op trace, so that is what it counts: the
step function runs once on ``meta`` tensors (shapes and dtypes, no data,
nothing launched) under :class:`StepCost`, a ``TorchDispatchMode`` that
sees every ATen op.

Costs counted (the reference's conventions where they carry over):

  * FLOPs: the matrix products only, through ``torch.utils.flop_counter``'s
    public formulas (``flop_registry``), as ``FlopCounterMode`` counts them
    (an op without a formula is offered its decomposition first);
  * bytes: operand plus result bytes of every op that is not a view, a
    ``detach`` or an allocation.  That is the reference's "fusion
    boundary" rule applied to an eager program, where every op is its own
    kernel and every intermediate goes through device memory: the figure
    is the port's own HBM traffic, not the reference's count over XLA's
    fusions;
  * the hand-written kernels, which the mode cannot see into: each wrapper
    given ``meta`` tensors notes its launch's FLOPs and bytes
    (``kernels/cost.py``), kept as a row a kernel (launches, FLOPs,
    bytes) and added to the totals;
  * the live-memory peak: the bytes of live storages, added when an op
    makes a storage and taken off when it is freed, each weighted by a
    device's share of it (:class:`StepCost`: a leaf's share by identity,
    an activation rule elsewhere).  The step's inputs are not counted, nor
    is any view of them or write into them: their storages are held
    before the step runs.

Python loops run eagerly, so every iteration of the layer loop, the
micro-batch loop and the chunk loops is seen: the trip-count correction
the reference needs for ``while`` bodies (which XLA's cost analysis counts
once) is built in.  This is a cost *model* of the step as written, not a
measurement.
"""

from __future__ import annotations

import weakref

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost

aten = torch.ops.aten

#: Ops that only allocate: no bytes move.
_ALLOCATIONS = {aten.empty, aten.empty_like, aten.empty_strided,
                aten.new_empty, aten.new_empty_strided}
#: Ops found to have no decomposition (``OpOverload.decompose`` returns
#: NotImplemented for an op without a CompositeImplicitAutograd kernel,
#: whatever its arguments): not offered it again.
_NO_DECOMPOSITION: set = set()
#: Metadata queries that a dispatch mode hands back (as ``FlopCounterMode``
#: does).
_QUERIES = {aten.sym_is_contiguous.default, aten.is_contiguous.default,
            aten.is_contiguous.memory_format,
            aten.is_strides_like_format.default,
            aten.is_non_overlapping_and_dense.default, aten.size.default,
            aten.sym_size.default, aten.stride.default,
            aten.sym_stride.default, aten.storage_offset.default,
            aten.sym_storage_offset.default, aten.numel.default,
            aten.sym_numel.default, aten.dim.default,
            torch.ops.prim.layout.default}


def _tensors(tree):
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _op_tensors(*parts):
    """The tensors among an op's arguments or results: each part a tensor,
    a tuple or list (of tensors and others, one level deep, as ATen
    schemas nest them), a dict of those, or anything else (skipped)."""
    out = []
    for part in parts:
        for a in (part.values() if isinstance(part, dict) else
                  part if isinstance(part, (tuple, list)) else (part,)):
            if isinstance(a, torch.Tensor):
                out.append(a)
            elif isinstance(a, (tuple, list)):
                out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class StepCost(TorchDispatchMode):
    """Counts FLOPs, bytes, kernel launches and the live-memory peak of
    the ops run inside it (see the module docstring).

    A device's share of a storage is decided by identity where a leaf owns
    the storage, and by ``activation(t)`` elsewhere (1 if not given):

      * :meth:`hold` the step's inputs first: their storages are never
        counted (views of them and writes into them included), and those
        a leaf owns carry its share;
      * a storage an op makes takes the share of an operand of its shape
        that a leaf owns (casts, copies, elementwise updates), unless the
        op is a matrix product;
      * :meth:`own`, and ``kernels.cost.derived`` (which reaches this
        recorder inside ``kernels.cost.recording(counter)``), give a
        storage made in the step a leaf's share later on: gradients,
        accumulators, the step's outputs;
      * any other storage takes ``activation(t)``, ``t`` the tensor it
        was made for.

    The peak is replayed from the order of makes and frees at the end, so
    a share given late counts from the storage's start.  After the block:
    ``flops``, ``bytes``, ``kernels`` (``{name: {"launches", "flops",
    "bytes"}}``) and :meth:`peak_bytes`.
    """

    def __init__(self, activation=None):
        super().__init__()
        self.activation = activation
        self.flops = 0
        self.bytes = 0
        self.kernels: dict = {}
        #: id(storage) -> its index in ``_sizes``, or None for an input's
        self._held: dict = {}
        #: id(storage) -> a device's share of an input storage a leaf owns
        self._input_share: dict = {}
        self._sizes: list = []       # bytes of each storage made, in order
        self._shares: list = []      # a device's share of each
        self._owned: set = set()     # indices of those a leaf owns
        self._events: list = []      # i: storage i made; ~i: freed
        self._finalizers: list = []

    # -- kernels --------------------------------------------------------------

    def note_kernel(self, name: str, flops: float, nbytes: float) -> None:
        row = self.kernels.setdefault(
            name, {"launches": 0, "flops": 0, "bytes": 0})
        row["launches"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    # -- shares ---------------------------------------------------------------

    def hold(self, tree, owned=()) -> None:
        """Mark the storages of ``tree``'s tensors as inputs (never
        counted), and give those of ``owned``'s ``(tensor, share)`` pairs
        a leaf's share."""
        for t in _tensors(tree):
            self._held[id(t.untyped_storage())] = None
        self.own(owned)

    def own(self, pairs) -> None:
        """Give the storage of each ``(tensor, share)`` pair that share,
        from its start if the step made it."""
        for t, share in pairs:
            key = id(t.untyped_storage())
            i = self._held.setdefault(key, None)
            if i is None:
                self._input_share[key] = share
            else:
                self._shares[i] = share
                self._owned.add(i)

    def share_of(self, t):
        """A device's share of ``t``'s storage if a leaf owns it, else
        None."""
        key = id(t.untyped_storage())
        i = self._held.get(key)
        if i is None:
            return self._input_share.get(key)
        return self._shares[i] if i in self._owned else None

    def note_derived(self, tree, like) -> None:
        """Each tensor of ``tree`` takes the share of the tensor in its
        place in ``like`` (``kernels.cost.derived``)."""
        pairs = [(t, self.share_of(p))
                 for t, p in zip(_tensors(tree), _tensors(like))]
        self.own([(t, s) for t, s in pairs if s is not None])

    # -- live memory ----------------------------------------------------------

    def _freed(self, key: int, i: int) -> None:
        self._held.pop(key, None)
        self._events.append(~i)

    def _track(self, results, operands, product: bool) -> None:
        for t in results:
            st = t.untyped_storage()
            key = id(st)
            if key in self._held:
                continue
            share = None
            if not product:
                share = next((s for s in (self.share_of(a) for a in operands
                                          if a.shape == t.shape)
                              if s is not None), None)
            i = len(self._sizes)
            if share is not None:
                self._owned.add(i)
            elif self.activation is not None:
                share = self.activation(t)
            self._sizes.append(st.nbytes())
            self._shares.append(1.0 if share is None else share)
            self._held[key] = i
            self._events.append(i)
            self._finalizers.append(
                weakref.finalize(st, self._freed, key, i))

    def peak_bytes(self) -> float:
        """The largest sum of the live storages' shares over the step."""
        live = peak = 0.0
        for e in self._events:
            if e >= 0:
                live += self._sizes[e] * self._shares[e]
                peak = max(peak, live)
            else:
                live -= self._sizes[~e] * self._shares[~e]
        return peak

    # -- ops ------------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return NotImplemented
        packet = func._overloadpacket
        product = packet in flop_registry
        if not product and func not in _NO_DECOMPOSITION:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
            _NO_DECOMPOSITION.add(func)
        out = func(*args, **kwargs)
        if product:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        operands = _op_tensors(args, kwargs)
        results = _op_tensors(out)
        if not (func.is_view or packet is aten.detach
                or packet in _ALLOCATIONS):
            self.bytes += _nbytes(operands) + _nbytes(results)
        self._track(results, operands, product)
        return out

    def release(self) -> None:
        """Stop following the storages still live (the step's outputs)."""
        for fin in self._finalizers:
            fin.detach()
        self._finalizers.clear()
        self._held.clear()

    def result(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "peak_bytes": self.peak_bytes()}


def step_costs(fn, *args, owned=(), activation=None, outputs=None,
               **kw) -> dict:
    """Run ``fn(*args, **kw)`` under a :class:`StepCost` and return
    ``{"flops", "bytes", "kernels", "peak_bytes"}``: the totals (the
    kernels' noted FLOPs and bytes included), a row a hand-written kernel,
    and the live-memory peak of the storages the step made (its inputs
    left out).  Meant for ``meta`` inputs.  A device's shares, as
    :class:`StepCost` takes them: ``owned``, ``(input tensor, share)``
    pairs of the leaves a device holds a share of; ``activation(t)``, the
    share of a storage no leaf owns; ``outputs(out)``, ``(tensor, share)``
    pairs of the step's result ``out``."""
    counter = StepCost(activation)
    counter.hold((args, kw), owned)
    try:
        with cost.recording(counter), counter:
            out = fn(*args, **kw)
        if outputs is not None:
            counter.own(outputs(out))
        return counter.result()
    finally:
        counter.release()
