"""SZ-style error-bounded quantization and the compressor around it.

Exports the reference's ``Compressed``, ``compress`` and ``decompress``
(``core/sz/compressor.py``), resolved on first use: the compressor imports
the kernel wrappers, which import ``core/sz/lorenzo.py``, so importing it
here would make a cycle.
"""

_COMPRESSOR_NAMES = ("Compressed", "compress", "decompress")


def __getattr__(name):
    if name in _COMPRESSOR_NAMES:
        from repro_torch.core.sz import compressor

        return getattr(compressor, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

