"""Codec sessions: one configured object for compress / decompress.

Port of ``src/repro/core/codec.py``.  ``CodecConfig`` freezes the
compression and decode policy into one hashable, validated value, and
``Codec`` binds it to the backend handle (with its dispatch and plan-build
counters), a digest-keyed ``PlanCache`` and a device.

The card is the default: ``CodecConfig()`` decodes on ``backend="cuda"``
on device ``"cuda"``, and a ``Codec`` built on it raises ``RuntimeError``
when PyTorch sees no CUDA device.  The CPU is used only when asked for:
``backend="ref"`` (whose device defaults to ``"cpu"``) or ``device="cpu"``.

    codec = Codec(CodecConfig(eb=1e-3))
    c = codec.compress(x)                       # on the card
    xhat = codec.decompress(c)                  # plan cached by digest
    xs = codec.decompress_batch([c, c2, c3])    # one dispatch per CR class
    shards = codec.compress_tree({"w": w, "b": b})
    restored = codec.decompress_tree(shards)    # one decompress_batch call

The module-level ``compress`` / ``decompress`` / ``decompress_batch``
functions are thin shims over a default Codec (``default_codec``, which
shares ``DEFAULT_PLAN_CACHE``); the removed ``use_tiles`` / ``use_kernels``
/ ``tuned`` flags raise ``TypeError`` pointing at ``CodecConfig``, as in
the reference.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.cache import (DEFAULT_PLAN_CACHE, PlanCache,
                                    compressed_digest)
from repro_torch.core.huffman import codebook as cb
from repro_torch.core.huffman import encode as he
from repro_torch.core.huffman import pipeline as hp
from repro_torch.core.sz import compressor, lorenzo
from repro_torch.core.sz.compressor import Compressed
from repro_torch.kernels import huffman_decode as K
from repro_torch.kernels.huffman_selfsync import selfsync_smem
from repro_torch.runtime import fault_tolerance as ft

VALID_MODES = ("rel", "abs")
#: The reference's methods less its host oracle "naive_ref", which is no
#: decode path of the port.
VALID_METHODS = hp.VALID_PLAN_METHODS
VALID_STRATEGIES = hp.VALID_STRATEGIES

DEFAULT_EB = compressor.DEFAULT_EB


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Frozen compression + decode policy; hashable, validates on build.

    Quantizer / encoder side:
      eb               error bound (relative to the value range for
                       ``mode="rel"``, absolute for ``mode="abs"``)
      mode             "rel" | "abs"
      radius           Lorenzo quantization radius (2*radius bins)
      max_len          codeword length cap (decode-LUT size is 2**max_len)
      subseqs_per_seq  encoder framing (128-bit subsequences per sequence)
      encode_backend   "ref": float64 prequantization, exact histogram and
                       the bit-pack as torch ops on the codec's device (the
                       default, as in the reference); "cuda": the device
                       write path, float32 quantize, histogram and bit-pack
                       as CUDA kernels (their plain versions on the CPU),
                       only the histogram crossing to the host; a
                       non-float32 tensor is compressed by "ref" and counts
                       ``stats["encode_fallbacks"]``

    Decoder side:
      method           "gap" (sync points from the stored gap array) |
                       "selfsync" (found by self-synchronization: on
                       "cuda" the ``selfsync_intra`` kernel and the
                       chaining of sequence heads)
      backend          "cuda" (the CUDA kernels) | "ref" (plain torch)
      strategy         "tile" (fixed tiles, paper Alg. 1) | "tuned"
                       (per-CR-class tiles, paper Alg. 2) | "padded" (the
                       original decoders' baseline layout)
      t_high           highest non-overflow CR class of the tuner (read by
                       "tuned" and by ``decompress_batch``)
      tile_syms        tile size of the "tile" strategy; on "cuda", one
                       block's staging tile plus its 2**max_len-entry LUT
                       must fit Hopper's 227 KB of shared memory, for this
                       tile and for the largest class tile of ``t_high``
                       (8,192 codes at t_high 8), which bounds max_len at
                       16 at the defaults
      fused            decode, dequantize and reconstruct without a
                       two-pass dequantize (on "cuda": one CUDA kernel per
                       tensor for "tile", the padded decode plus one
                       epilogue kernel for "padded"); a tensor the fused
                       path cannot serve (every "tuned" decode included,
                       ``compressor.fused_unsupported_reason``) decodes
                       two-pass and counts ``stats["fused_fallbacks"]``

    Session side:
      plan_cache_size  LRU bound of the codec's digest-keyed plan cache
      recovery         "raise" (default) | "skip" | "zero_fill": what
                       ``Archive.iter_decode`` and ``KVPager.page_in`` do
                       on persistent corruption; per-call ``policy=``
                       overrides win (``runtime/fault_tolerance.py:
                       RecoveryPolicy``)
      io_retries       transient-IO retry count for store reads (``OSError``
                       only; corruption is never retried)
      io_backoff       initial backoff seconds between retries (doubles)
      device           where compress and decompress run; ``None`` means
                       "cuda" for the "cuda" backend and "cpu" for "ref"

    The reference's encode backends "jnp", "pallas" and "pallas-compiled"
    are no names of the port: "cuda" stands for them.
    The reference's sequential oracle ``method="naive_ref"`` is no decode
    path of the port.
    """

    eb: float = DEFAULT_EB
    mode: str = "rel"
    radius: int = lorenzo.DEFAULT_RADIUS
    max_len: int = cb.DEFAULT_MAX_LEN
    subseqs_per_seq: int = he.DEFAULT_SUBSEQS_PER_SEQ
    encode_backend: str = "ref"
    method: str = "gap"
    backend: str = "cuda"
    strategy: str = "tile"
    t_high: int = hp.T_HIGH_DEFAULT
    tile_syms: int = hp.DEFAULT_TILE_SYMS
    fused: bool = False
    plan_cache_size: int = 4096
    recovery: str = "raise"
    io_retries: int = 2
    io_backoff: float = 0.05
    device: "str | None" = None

    def __post_init__(self):
        if not (self.eb > 0):
            raise ValueError(f"eb must be positive, got {self.eb!r}")
        if self.mode not in VALID_MODES:
            raise ValueError(
                f"unknown mode {self.mode!r}; valid modes: {VALID_MODES}")
        hp.check_method(self.method)
        if self.strategy not in VALID_STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; valid "
                             f"strategies: {VALID_STRATEGIES}")
        if self.backend not in hp.available_backends():
            raise ValueError(f"unknown backend {self.backend!r}; available: "
                             f"{hp.available_backends()}")
        if self.encode_backend not in hp.available_encode_backends():
            raise ValueError(
                f"unknown encode_backend {self.encode_backend!r}; "
                f"available: {hp.available_encode_backends()}")
        if self.t_high < 1:
            raise ValueError(f"t_high must be >= 1, got {self.t_high}")
        if self.radius < 2:
            raise ValueError(f"radius must be >= 2, got {self.radius}")
        if not (1 <= self.max_len <= 24):
            raise ValueError(f"max_len must be in [1, 24], got {self.max_len}")
        if self.tile_syms < 1:
            raise ValueError(f"tile_syms must be >= 1, got {self.tile_syms}")
        # The largest tile this codec's decodes stage: tile_syms, and the
        # largest class tile of the tuned dispatch, which decompress_batch
        # runs whatever the strategy.  A LUT that does not fit beside it is
        # read from device memory, so only the staging tile itself bounds
        # the config.
        tile = max(self.tile_syms, hp.max_class_tile(self.t_high))
        smem = K.decode_tiles_smem(tile, 0)
        if self.backend == "cuda" and smem > K.SMEM_LIMIT:
            raise ValueError(
                f"backend 'cuda' cannot decode tile_syms={self.tile_syms} "
                f"with t_high={self.t_high}: a decode_tiles block of {tile} "
                f"codes needs {smem} B of shared memory for its staging "
                f"tile, Hopper allows {K.SMEM_LIMIT}")
        if self.subseqs_per_seq < 1:
            raise ValueError("subseqs_per_seq must be >= 1, got "
                             f"{self.subseqs_per_seq}")
        smem = selfsync_smem(self.subseqs_per_seq, 1 << self.max_len)
        if (self.backend == "cuda" and self.method == "selfsync"
                and smem > K.SMEM_LIMIT):
            raise ValueError(
                f"backend 'cuda' cannot self-sync subseqs_per_seq="
                f"{self.subseqs_per_seq}: a selfsync_intra block needs "
                f"{smem} B of shared memory for its lanes' starts, landings "
                f"and counts, Hopper allows {K.SMEM_LIMIT}")
        if not isinstance(self.fused, bool):
            raise ValueError(f"fused must be a bool, got {self.fused!r}")
        if self.plan_cache_size < 0:
            raise ValueError("plan_cache_size must be >= 0, got "
                             f"{self.plan_cache_size}")
        if self.recovery not in ft.VALID_RECOVERY:
            raise ValueError(f"unknown recovery {self.recovery!r}; valid "
                             f"policies: {ft.VALID_RECOVERY}")
        if self.io_retries < 0:
            raise ValueError(f"io_retries must be >= 0, got "
                             f"{self.io_retries}")
        if self.io_backoff < 0:
            raise ValueError(f"io_backoff must be >= 0, got "
                             f"{self.io_backoff}")
        if self.device is not None:
            torch.device(self.device)   # raises on a malformed device

    def replace(self, **changes) -> "CodecConfig":
        return dataclasses.replace(self, **changes)

    def resolved_device(self) -> torch.device:
        if self.device is not None:
            return torch.device(self.device)
        return torch.device("cuda" if self.backend == "cuda" else "cpu")


class Codec:
    """A configured compression/decompression session.

    Holds a ``CodecConfig``, its device, the resolved backend handle (whose
    ``stats`` count decode-write dispatches and plan builds) and a
    digest-keyed ``PlanCache``.
    """

    def __init__(self, config: "CodecConfig | None" = None, *,
                 plan_cache: "PlanCache | None" = None):
        self.config = config if config is not None else CodecConfig()
        device = self.config.resolved_device()
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"Codec(backend={self.config.backend!r}) runs on device "
                    f"{device}, but torch.cuda.is_available() is False: no "
                    f"CUDA device is visible to PyTorch.  Pass device='cpu' "
                    f"or backend='ref' to run on the CPU.")
            if device.index is None:  # tensors report their card's index
                device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.backend = hp.get_backend(self.config.backend)
        self.encode_backend = hp.get_encode_backend(
            self.config.encode_backend)
        self.plan_cache = (plan_cache if plan_cache is not None
                           else PlanCache(self.config.plan_cache_size))

    def __repr__(self):
        c = self.config
        return (f"Codec(eb={c.eb:g}, mode={c.mode!r}, method={c.method!r}, "
                f"backend={c.backend!r}, strategy={c.strategy!r}, "
                f"device={str(self.device)!r})")

    @property
    def stats(self) -> dict:
        """Merged decode and encode backend counters (dispatches, plan
        builds, fused and encode fallbacks) + plan-cache hit counters.

        Backend handles are process-wide singletons per name, so their
        counters are shared by every codec on the same backend.
        """
        return {**self.backend.stats, **self.encode_backend.stats,
                **self.plan_cache.stats}

    def reset_stats(self):
        self.backend.reset_stats()
        self.encode_backend.reset_stats()
        self.plan_cache.reset_stats()

    def recovery_policy(self, policy=None) -> ft.RecoveryPolicy:
        """This codec's ``RecoveryPolicy``; ``policy`` (a string or a
        ``RecoveryPolicy``) overrides the config's ``recovery`` default."""
        return ft.RecoveryPolicy.resolve(policy, self.config)

    def _local(self, compressed: Compressed) -> Compressed:
        if compressed.device == self.device:
            return compressed
        return compressed.to(self.device)

    def compress(self, x) -> Compressed:
        c = self.config
        return compressor.compress(x, eb=c.eb, mode=c.mode, radius=c.radius,
                                   max_len=c.max_len,
                                   subseqs_per_seq=c.subseqs_per_seq,
                                   encode_backend=self.encode_backend,
                                   device=self.device)

    def build_plan(self, stream, codebook) -> hp.DecoderPlan:
        """Phase 1-3 plan under this codec's (method, backend, t_high)."""
        c = self.config
        return hp.build_plan(stream, codebook, method=c.method,
                             backend=self.backend, t_high=c.t_high)

    def plan_for(self, compressed: Compressed) -> hp.DecoderPlan:
        """Cached ``DecoderPlan`` for one tensor, keyed by content digest,
        method and ``t_high`` (so a cached plan's CR classes are always
        those of this codec's ``t_high``); single-flight: concurrent misses
        on one payload build it once."""
        compressed = self._local(compressed)
        c = self.config
        key = (compressed_digest(compressed), c.method, c.t_high)
        return self.plan_cache.get_or_build_plan(
            key, lambda: self.build_plan(compressed.stream,
                                         compressed.codebook))

    def decompress(self, compressed: Compressed, *, plan=None):
        """Decompress one tensor under the codec's policy, on its device.

        The phase 1-3 plan comes from / goes into the plan cache by content
        digest; ``config.fused`` runs the fused decode (``fused_dispatches``)
        or, for a tensor it cannot serve, decodes two-pass and counts
        ``stats["fused_fallbacks"]``.
        """
        c = self.config
        compressed = self._local(compressed)
        if plan is None:
            plan = self.plan_for(compressed)
        return compressor.decompress(compressed, method=c.method,
                                     tile_syms=c.tile_syms,
                                     backend=self.backend,
                                     strategy=c.strategy, t_high=c.t_high,
                                     plan=plan, fused=c.fused)

    def decompress_batch(self, cs, *, plans=None) -> list:
        """Decompress many tensors: one decode-write dispatch per CR class
        across ALL of them, phase 1-3 plans served from the cache.  With
        ``config.fused``, eligible tensors instead decode through the fused
        per-tensor path (see ``compressor.decompress_batch``)."""
        cs = [self._local(x) for x in cs]
        if not cs:
            return []
        c = self.config
        if plans is None:
            plans = [self.plan_for(x) for x in cs]
        return compressor.decompress_batch(cs, method=c.method,
                                           tile_syms=c.tile_syms,
                                           backend=self.backend,
                                           strategy=c.strategy,
                                           t_high=c.t_high, plans=plans,
                                           fused=c.fused)

    def decode(self, stream, codebook, n_out: int, *, plan=None,
               early_exit: bool = True):
        """Decode a raw encoded stream to uint16 quant codes (no
        dequantization), on the stream's device.  ``early_exit`` is the
        self-sync ``__all_sync`` round exit of a plan built here."""
        c = self.config
        return hp.decode(stream, codebook, n_out, plan=plan, method=c.method,
                         backend=self.backend, strategy=c.strategy,
                         tile_syms=c.tile_syms, t_high=c.t_high,
                         early_exit=early_exit)

    # -- pytrees -------------------------------------------------------------

    def compress_tree(self, tree, *, min_size: int = 1, predicate=None):
        """Compress every compressible leaf of a pytree, in place of it.

        A leaf is compressed when ``predicate(leaf)`` is true (default:
        a tensor or array of float32 / bfloat16 / float16 --
        ``compressor.FUSED_DTYPES`` -- with at least ``min_size``
        elements); everything else passes through untouched.  Trees are
        ``torch.utils._pytree`` trees, whose ``None`` is a leaf where JAX's
        is an empty node: a ``None`` passes through without reaching
        ``predicate``, as in the reference.
        """
        if predicate is None:
            def predicate(leaf):
                return (_leaf_dtype_name(leaf) in compressor.FUSED_DTYPES
                        and _leaf_size(leaf) >= min_size)

        def one(leaf):
            if leaf is not None and predicate(leaf):
                return self.compress(leaf)
            return leaf

        return pytree.tree_map(one, tree)

    def decompress_tree(self, tree, *, shardings=None):
        """Inverse of ``compress_tree``: every ``Compressed`` leaf decodes
        through ONE class-batched ``decompress_batch`` call; other leaves
        (``None`` included) pass through untouched.

        ``shardings`` (optional) is a pytree matching ``tree`` whose leaves
        are ``torch.device`` or ``None``: a leaf paired with a device is
        moved there (a non-tensor leaf becomes a tensor on it).  It must
        have one leaf for each leaf of ``tree`` other than ``None`` (the
        leaves JAX counts), or ``ValueError`` is raised, as in the
        reference.  Any other placement (a mesh, a ``DTensor`` layout)
        raises ``NotImplementedError``: sharded restore is ROADMAP A9.
        """
        leaves, treedef = pytree.tree_flatten(
            tree, is_leaf=lambda x: isinstance(x, Compressed))
        live = [i for i, leaf in enumerate(leaves) if leaf is not None]
        shard_leaves = None
        if shardings is not None:
            shard_leaves, _ = pytree.tree_flatten(
                shardings, is_leaf=lambda x: x is None
                or isinstance(x, torch.device))
            if len(shard_leaves) != len(live):
                raise ValueError(
                    f"shardings tree has {len(shard_leaves)} leaves but the "
                    f"compressed tree has {len(live)}")
            for s in shard_leaves:
                if s is not None and not isinstance(s, torch.device):
                    raise NotImplementedError(
                        f"placement {s!r} is not ported yet: ROADMAP A9 "
                        f"(sharded restore); a shardings leaf is a "
                        f"torch.device or None")
        idx = [i for i, leaf in enumerate(leaves)
               if isinstance(leaf, Compressed)]
        outs = self.decompress_batch([leaves[i] for i in idx])
        for i, out in zip(idx, outs):
            leaves[i] = out
        if shard_leaves is not None:
            for i, s in zip(live, shard_leaves):
                if s is not None:
                    leaves[i] = torch.as_tensor(leaves[i]).to(s)
        return pytree.tree_unflatten(leaves, treedef)


def _leaf_dtype_name(leaf) -> "str | None":
    if isinstance(leaf, torch.Tensor):
        return compressor.dtype_name(leaf.dtype)
    dtype = getattr(leaf, "dtype", None)
    if dtype is None:
        return None
    try:
        return np.dtype(dtype).name
    except TypeError:
        return str(dtype)


def _leaf_size(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel()
    return int(np.size(leaf))


# ---------------------------------------------------------------------------
# Default codec + module-level shims
# ---------------------------------------------------------------------------

_DEFAULT_CODEC: "Codec | None" = None
_SHIM_CODECS: dict = {}
_SHIM_LOCK = threading.Lock()


def default_codec() -> Codec:
    """The process-wide default ``Codec`` (default config, on the card,
    shared ``DEFAULT_PLAN_CACHE``) used by the module-level shims and by
    consumers constructed without an explicit codec.  Raises, as every
    ``Codec()`` does, when PyTorch sees no CUDA device."""
    global _DEFAULT_CODEC
    if _DEFAULT_CODEC is None:
        _DEFAULT_CODEC = Codec(CodecConfig(), plan_cache=DEFAULT_PLAN_CACHE)
    return _DEFAULT_CODEC


def _codec_for(config: CodecConfig) -> Codec:
    """Memoized per-config codecs for the shims; all share the default plan
    cache so kwarg-style callers still get digest-keyed plan reuse."""
    if config == CodecConfig():
        return default_codec()
    with _SHIM_LOCK:
        codec = _SHIM_CODECS.get(config)
        if codec is None:
            codec = Codec(config, plan_cache=DEFAULT_PLAN_CACHE)
            if len(_SHIM_CODECS) >= 64:   # kwarg soup bound, not a cache
                _SHIM_CODECS.clear()
            _SHIM_CODECS[config] = codec
        return codec


_REMOVED_FLAGS = ("use_tiles", "use_kernels", "tuned")


def _reject_removed(fn_name: str, kwargs: dict):
    bad = sorted(set(kwargs) & set(_REMOVED_FLAGS))
    if bad:
        raise TypeError(
            f"{fn_name}() no longer accepts {', '.join(bad)}; configure a "
            f"repro_torch.core.Codec instead -- CodecConfig(backend='cuda'|"
            f"'ref') replaces use_kernels, CodecConfig(strategy='tuned'|"
            f"'tile'|'padded') replaces tuned/use_tiles")
    if kwargs:
        raise TypeError(f"{fn_name}() got unexpected keyword arguments "
                        f"{sorted(kwargs)}")


def _replace_some(config: CodecConfig, **overrides) -> CodecConfig:
    changes = {k: v for k, v in overrides.items() if v is not None}
    return config.replace(**changes) if changes else config


def compress(x, eb: "float | None" = None, mode: "str | None" = None,
             radius: "int | None" = None, max_len: "int | None" = None,
             subseqs_per_seq: "int | None" = None,
             encode_backend: "str | None" = None, *,
             device: "str | None" = None, **removed) -> Compressed:
    """Compress a float tensor (shim over a default ``Codec``).

    mode="rel": bound is ``eb * (max(x) - min(x))`` (the paper's setting,
    "relative error bound 1e-3"); mode="abs": bound is ``eb`` directly.
    ``device`` (the port's, where the reference has JAX's default device)
    asks for another device than the card, such as "cpu".  Prefer holding
    a ``Codec`` when compressing more than once.
    """
    _reject_removed("compress", removed)
    cfg = _replace_some(CodecConfig(), eb=eb, mode=mode, radius=radius,
                        max_len=max_len, subseqs_per_seq=subseqs_per_seq,
                        encode_backend=encode_backend, device=device)
    return _codec_for(cfg).compress(x)


def decompress(c: Compressed, method: "str | None" = None,
               tile_syms: "int | None" = None, *,
               backend: "str | None" = None, strategy: "str | None" = None,
               t_high: "int | None" = None, fused: "bool | None" = None,
               plan=None, **removed):
    """Decompress one tensor (shim over a default ``Codec``; on the CPU
    with ``backend="ref"``).

    The legacy ``use_tiles`` / ``use_kernels`` / ``tuned`` flags are gone;
    they raise ``TypeError`` pointing at ``CodecConfig``.
    """
    _reject_removed("decompress", removed)
    cfg = _replace_some(CodecConfig(), method=method, tile_syms=tile_syms,
                        backend=backend, strategy=strategy, t_high=t_high,
                        fused=fused)
    return _codec_for(cfg).decompress(c, plan=plan)


def decompress_batch(cs, method: "str | None" = None, *,
                     backend: "str | None" = None,
                     t_high: "int | None" = None, fused: "bool | None" = None,
                     plans=None, **removed) -> list:
    """Decompress many tensors with class-batched decode dispatch (shim
    over a default ``Codec``); see ``Codec.decompress_batch``."""
    _reject_removed("decompress_batch", removed)
    cfg = _replace_some(CodecConfig(), method=method, backend=backend,
                        t_high=t_high, fused=fused)
    return _codec_for(cfg).decompress_batch(cs, plans=plans)
