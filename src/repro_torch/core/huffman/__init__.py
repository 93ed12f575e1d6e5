"""Huffman coding: codebooks, encoder, reference decoders, decode pipeline."""
