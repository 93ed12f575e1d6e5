"""PyTorch / CUDA port of the Huffman-decode reproduction (``src/repro``).

The package mirrors ``src/repro`` module for module; each module names its
reference.  It imports ``torch`` and ``numpy`` and nothing of JAX or of the
JAX package.  The hand-written CUDA kernels for the H100 live in
``csrc/`` and are built at first use (``kernels/_build.py``).

    from repro_torch.core.codec import Codec, CodecConfig
    codec = Codec(CodecConfig())          # backend "cuda" on device "cuda"
    xhat = codec.decompress(codec.compress(x))
"""
