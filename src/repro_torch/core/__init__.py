"""Core of the port: Huffman coding, SZ quantization, codec sessions."""
