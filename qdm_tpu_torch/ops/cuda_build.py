"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into
``build/qdm_tpu_torch/`` beside the package.  All sources build in
parallel (one ``nvcc`` each).  The libraries are loaded with ``ctypes``;
every pointer and the stream cross as ``c_void_p``.  A library is named by
a hash of the sources it was built from, so an edited source rebuilds.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine that has no ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "qdm_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C entry point of each kernel and its argument types; the kernel's source is
# csrc/<name>.cu unless SOURCE_OF names another
ENTRY_POINTS = {
    "w8a8_fused_epi": ("qdm_w8a8_fused_epi",
                       (P, I, P, P, P, P, P, I, P, P, P, P, F, I, I, I, I, P)),
    "w8a8_geglu": ("qdm_w8a8_geglu",
                   (P, I, P, P, P, P, I, P, P, I, I, I, I, I, I, I, I, P)),
    "w8a8_matmul_fused": ("qdm_w8a8_matmul_fused",
                          (P, I, P, P, P, I, P, P, I, I, I, I, I, I, I, P)),
    "w4a16_matmul": ("qdm_w4a16_matmul",
                     (P, I, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, P)),
    "w4a8_matmul": ("qdm_w4a8_matmul",
                    (P, I, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P)),
    "decode_dense": ("qdm_decode_dense",
                     (P, I, P, I, P, P, I, F, P, P, P, I, P, I, P, I, I, I, I, I, I, I, I,
                      P)),
    "decode_dense_i8": ("qdm_decode_dense_i8",
                        (P, I, P, P, P, P, P, I, F, P, P, P, I, P, I, P, I, P, I, I, I, I, I, I,
                         I, I, P)),
    "decode_attention_kv": ("qdm_decode_attention_kv",
                            (P, I, I, P, P, I, F, F, P, I, I, I, I, I, I, P)),
    "decode_mlp_i8": ("qdm_decode_mlp_i8",
                      (P, I, P, P, P, P, P, P, P, P, P, I, F, I, I, P, I, P, P, I, I, I, I, I, I,
                       I, I, I, I, P)),
    "flash_prefill": ("qdm_flash_prefill",
                      (P, P, P, I, L, L, L, L, L, L, L, L, L, P, L, L, L, P, P, P, I, I, I, I, I,
                       F, I, P)),
    "decode_attention_kv_flash": ("qdm_decode_attention_kv_flash",
                                  (P, I, L, P, P, I, F, F, P, I, I, I, I, I, I, I, I, I, P)),
    "decode_mlp": ("qdm_decode_mlp",
                   (P, P, P, P, P, P, I, F, I, I, P, I, P, I, I, I, I, I, I, I, I, I, I, P)),
    "decode_attention_kv_q": ("qdm_decode_attention_kv_q",
                              (P, I, L, P, P, P, I, F, I, P, I, I, I, I, I, I, P, P)),
    "decode_attention_kv_flash_q": ("qdm_decode_attention_kv_flash_q",
                                    (P, I, L, P, P, P, I, F, F, I, P, I, I, I, I, I, I, I, I, P)),
    "decode_dense_i4": ("qdm_decode_dense_i4",
                        (P, I, P, P, P, P, F, P, P, I, P, I, P, I, P, I, I, I, I, I, P, P)),
    "decode_mlp_i4": ("qdm_decode_mlp_i4",
                      (P, I, P, P, P, P, P, P, P, P, F, I, I, P, I, P, P, I, I, I, I, I, I, I, I,
                       I, I, I, P)),
    "decode_o_mlp_i8": ("qdm_decode_o_mlp_i8",
                        (P, I, P, P, P, I, P, P, P, P, P, P, P, P, P, F, I, P, I, P, P, P, P, P,
                         I, I, I, I, I, I, I, I, I, I, I, I, P)),
    "decode_o_mlp_i4": ("qdm_decode_o_mlp_i4",
                        (P, I, P, P, P, I, P, P, P, P, P, P, P, P, P, F, I, P, I, P, P, P, P, P,
                         I, I, I, I, I, I, I, I, I, I, I, I, I, P)),
    "flash_prefill_i8": ("qdm_flash_prefill_i8",
                         (P, I, L, L, L, P, L, L, L, P, L, L, L, P, P, P, P, P, L, L, L, P, P, P,
                          P, P, P, I, I, I, I, I, F, I, P)),
    "flash_int8": ("qdm_flash_int8",
                   (P, L, L, L, P, L, L, L, P, L, L, L, I, P, P, P, P, P, P, P, P, P, I, I, I, I,
                    F, I, P)),
    "decode_moe_i4": ("qdm_decode_moe_i4",
                      (P, I, P, P, P, P, P, P, P, P, I, P, I, P, P, I, I, I, I, I, I, I, I, I, I,
                       I, I, P)),
    "decode_attention": ("qdm_decode_attention",
                         (P, I, L, P, P, I, F, I, P, I, I, I, I, I, I, I, P)),
    "decode_attention_i8": ("qdm_decode_attention_i8",
                            (P, I, L, P, P, P, P, I, F, I, P, I, I, I, I, I, I, I, P, P)),
    "w8a8_matmul": ("qdm_w8a8_matmul", (P, P, P, P, P, I, I, I, I, P)),
}
SOURCE_OF = {"decode_dense": "decode_dense_bf16", "decode_dense_i8": "decode_dense",
             "w8a8_matmul_fused": "w8a8_matmul", "w8a8_geglu": "w8a8_matmul"}

_LOCK = threading.Lock()
_FUNCS: Dict[str, object] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or NVCC): the CUDA "
                       "kernels of qdm_tpu_torch are built from source at "
                       "first use")


def source(name: str) -> str:
    """The csrc/*.cu source (without suffix) that holds kernel ``name``."""
    return SOURCE_OF.get(name, name)


def _lib_path(src: str) -> Path:
    """The library built from ``csrc/<src>.cu`` (a source's name, not a kernel's)."""
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{src}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src}_{h.hexdigest()[:12]}.so"


def build_all() -> None:
    """Compile every source that has no up-to-date library, all ``nvcc``
    processes at once; raise with the compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    for name in dict.fromkeys(source(n) for n in ENTRY_POINTS):
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def kernel(name: str):
    """The C entry point of ``csrc/<name>.cu``, building it if needed."""
    fn = _FUNCS.get(name)
    if fn is not None:
        return fn
    with _LOCK:
        if name not in _FUNCS:
            path = _lib_path(source(name))
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            sym, argtypes = ENTRY_POINTS[name]
            fn = getattr(lib, sym)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _FUNCS[name] = fn
    return _FUNCS[name]


def variant_path(name: str, *defines: str) -> Path:
    """The library of kernel ``name`` built with ``-D<define>`` for each of
    ``defines`` (build_variants, variant)."""
    lib = _lib_path(source(name))
    return lib.with_name(lib.stem + "_" + "_".join(d.lower() for d in defines) + ".so")


def build_variants(variants) -> None:
    """Compile each (name, defines) variant that has no library yet, all
    ``nvcc`` processes at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, defines in variants:
        out = variant_path(name, *defines)
        if out.exists():
            continue
        src = source(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, *[f"-D{d}" for d in defines], "-I", str(CSRC), "-o",
               str(tmp), str(CSRC / f"{src}.cu")]
        procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), tmp, out, src))
    errors = []
    for proc, tmp, out, src in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {src}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


@contextlib.contextmanager
def variant(name: str, *defines: str) -> Iterator[None]:
    """Kernel ``name`` built from its source with ``-D<define>`` for each of
    ``defines`` (a profile's variant of it), taking the place of the
    library's own while the context lasts."""
    build_variants([(name, defines)])
    out = variant_path(name, *defines)
    sym, argtypes = ENTRY_POINTS[name]
    fn = getattr(ctypes.CDLL(str(out)), sym)
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    kept = kernel(name)
    _FUNCS[name] = fn
    try:
        yield
    finally:
        _FUNCS[name] = kept


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
