"""Public compression API: the Codec session is the single entry point.

Port of ``src/repro/core/api.py``.  A ``Codec`` binds a frozen
``CodecConfig`` (error bound and bound mode on the quantizer side; sync
method, decode strategy, backend and tuner ``t_high`` on the decoder side;
the device) to a backend handle and a digest-keyed ``PlanCache``:

    from repro_torch.core.api import Codec, CodecConfig

    codec = Codec(CodecConfig(eb=1e-4, strategy="tuned"))   # on the card
    c = codec.compress(x)
    xhat = codec.decompress(c)                 # phase 1-3 plan cached
    tree = codec.compress_tree(params)         # pytree of Compressed leaves
    back = codec.decompress_tree(tree)         # one decompress_batch call

Every consumer rides on a Codec: ``repro_torch.store`` (``Archive`` /
``KVPager`` take ``codec=``; chunk digests key the codec's plan cache, so a
warm open rebuilds zero plans).  The module-level ``compress`` /
``decompress`` / ``decompress_batch`` functions are thin shims over a
default Codec; the legacy ``use_tiles`` / ``use_kernels`` / ``tuned`` flags
raise ``TypeError`` pointing at ``CodecConfig``.

Decoding is served by ``repro_torch.core.huffman.pipeline``: ``build_plan``
runs the sync/count/prefix-sum phases and CR classification, ``decode``
executes the plan on a registered backend ("cuda" kernels or "ref" torch
ops), and ``decode_batch`` merges the per-CR-class decode dispatch across
tensors.
"""

from __future__ import annotations

from repro_torch.core.cache import (  # noqa: F401  (public re-exports)
    DEFAULT_PLAN_CACHE,
    PlanCache,
    compressed_digest,
)
from repro_torch.core.codec import (  # noqa: F401  (public re-exports)
    Codec,
    CodecConfig,
    compress,
    decompress,
    decompress_batch,
    default_codec,
)
from repro_torch.core.huffman.pipeline import (  # noqa: F401
    DecodeBackend,
    DecoderPlan,
    available_backends,
    build_plan,
    decode,
    decode_batch,
    get_backend,
    register_backend,
)
from repro_torch.core.sz.compressor import Compressed  # noqa: F401
from repro_torch.core.sz import lorenzo  # noqa: F401


def roundtrip_error(x, c: "Compressed", xhat) -> float:
    """Max abs error of a round trip (must be <= c.eb)."""
    import numpy as np
    import torch

    def host(a):
        if isinstance(a, torch.Tensor):
            return a.detach().to("cpu", torch.float64).numpy()
        return np.asarray(a, np.float64)

    return float(np.max(np.abs(host(x) - host(xhat))))
