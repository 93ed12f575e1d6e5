"""Huffman coding: codebooks, encoder, reference decoders, decode pipeline."""

from repro_torch.core.huffman import bits, codebook, decode, encode  # noqa: F401
from repro_torch.core.huffman.codebook import (  # noqa: F401
    Codebook,
    build_codebook,
)
from repro_torch.core.huffman.encode import EncodedStream  # noqa: F401
