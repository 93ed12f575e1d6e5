"""Build and load the CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` is compiled on its own with ``nvcc`` for ``sm_90a``
into ``build/kernels/lib<name>-<hash>.so`` at the repository root, where the
hash covers the sources and the flags, so an edited source never loads a
stale library.  The libraries have a plain C interface and are loaded with
``ctypes``; nothing includes PyTorch's headers, which keeps a build to
seconds.  :func:`build` compiles every missing library with one ``nvcc``
per source, all started together.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
#: C entry point and argument types of each kernel library.
SIGNATURES = {
    "count_subseq": ("repro_count_subseq",
                     [_P, _L, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I,
                      _P, _P, _P]),
    "decode_tiles": ("repro_decode_tiles",
                     [_P, _L, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I,
                      _I, _I, _L, _I, _I, _I, _I, _I, _P, _P]),
    "decode_padded": ("repro_decode_padded",
                      [_P, _L, _P, _P, _I, _I, _P, _P, _I, _I, _I, _P, _P,
                       _P]),
    "decode_tiles_fused": ("repro_decode_tiles_fused",
                           [_P, _L, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I,
                            _I, _I, _I, _L, _I, _I, _I, _I, _I, _P, _P, _P,
                            _I, _F, _P, _P, _I, _P, _P]),
    "decode_tiles_fused_nd": ("repro_decode_tiles_fused_nd",
                              [_P, _L, _P, _P, _P, _P, _P, _I, _I, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _L, _I, _P, _P, _P, _I, _F,
                               _I, _I, _P, _P, _P, _P, _I, _P, _P]),
    "dequant_reconstruct": ("repro_dequant_reconstruct",
                            [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _F,
                             _P, _P, _I, _P, _P]),
    "dequant_reconstruct_nd": ("repro_dequant_reconstruct_nd",
                               [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _L, _P, _P, _P, _I, _F, _I, _I, _P,
                                _P, _P, _P, _I, _P, _P]),
    "lorenzo_quantize": ("repro_lorenzo_quantize",
                         [_P, _L, _P, _I, _I, _I, _F, _I, _P, _P, _P, _P]),
    "reconstruct1d": ("repro_reconstruct1d",
                      [_P, _L, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P]),
    "histogram": ("repro_histogram",
                  [_P, _L, _I, _I, _I, _L, _I, _I, _I, _I, _P, _P]),
    "pack_tiles": ("repro_pack_tiles",
                   [_P, _P, _L, _P, _P, _I, _L, _I, _I, _I, _P, _P]),
    "selfsync_intra": ("repro_selfsync_intra",
                       [_P, _L, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _P, _P, _P, _P, _P]),
    "flash_attn": ("repro_flash_attn",
                   [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                    _I, _P]),
    "gla_time_mix": ("repro_gla_time_mix",
                     [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _P]),
    "decode_chunked": ("repro_decode_chunked",
                       [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                        _P]),
}

_lock = threading.Lock()
_libs: dict = {}
_loaded: dict = {}
#: ptxas report (registers, shared memory, spills) of each build.
build_log: dict = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
            "kernels are built from src/repro_torch/csrc at first use")
    return nvcc


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> float:
    """Compile the missing kernel libraries in parallel; returns seconds.

    Raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    names = list(SIGNATURES if names is None else names)
    t0 = time.perf_counter()
    with _lock:
        todo = [n for n in names if not library_path(n).exists()]
        if not todo:
            return 0.0
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in todo:
            out = library_path(name)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_log[name] = log
            if proc.returncode != 0:
                failed.append(f"--- {name} (nvcc exit {proc.returncode})\n"
                              f"{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str):
    """The C entry point of kernel library ``name``, built if missing."""
    fn = _loaded.get(name)
    if fn is not None:
        return fn
    build([name])
    with _lock:
        if name not in _loaded:
            symbol, argtypes = SIGNATURES[name]
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return _loaded[name]
