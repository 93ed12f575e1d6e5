"""Core of the port: Huffman coding, SZ quantization, codec sessions.

Exports the reference's ``repro.core`` names: ``PlanCache`` and
``DEFAULT_PLAN_CACHE`` (``core/cache.py``), ``Codec``, ``CodecConfig`` and
``default_codec`` (``core/codec.py``).  The codec's names resolve on first
use: ``core/codec.py`` imports the kernel wrappers, which import this
package's Huffman modules, so importing it here would make a cycle.
"""

from repro_torch.core.cache import DEFAULT_PLAN_CACHE, PlanCache  # noqa: F401

_CODEC_NAMES = ("Codec", "CodecConfig", "default_codec")


def __getattr__(name):
    if name in _CODEC_NAMES:
        from repro_torch.core import codec

        return getattr(codec, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

