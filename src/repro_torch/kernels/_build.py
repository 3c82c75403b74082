"""Lazy ``nvcc`` build and ``ctypes`` load of the port's CUDA kernels.

Every ``src/repro_torch/csrc/*.cu`` file is one shared library with a plain
C interface.  The first CUDA launch builds the libraries that are missing:
one ``nvcc`` process per source, all started together, for ``sm_90a``
only, into ``build/repro_torch/`` at the repository root (listed in
``.gitignore``).  A library's file name carries a hash of its source and of
the shared headers (``csrc/*.cuh``), so an edited source is rebuilt and a
stale one is never loaded.  Nothing here
runs at import time, so the CPU tests import every module without a
compiler.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on anything but 0.  Each wrapper counts its launches in
:data:`LAUNCHES`, a plain integer per kernel, so a run can show that its
main path went through the kernels.

A wrapper given fake tensors (``torch._subclasses.FakeTensor``, the dry
run's) builds and launches nothing: it returns fake outputs of the right
shapes and reports the launch it stands for to the hooks in
:data:`FAKE_HOOKS` (``launch.op_cost`` adds its bytes), never to
:data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence

__all__ = [
    "LAUNCHES",
    "SOURCES",
    "BUILD_DIR",
    "build_all",
    "library",
    "check",
    "stream_handle",
    "is_fake",
    "note_fake",
    "FAKE_HOOKS",
]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("level_fused", "bitonic", "merge_path", "dispatch_rank", "classify",
           "block_permute", "permute_inplace", "flash_decode", "flash_attention", "glue",
           "codec", "fallback")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-lineinfo",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler=-fPIC",
)

# kernel name -> launches since the last reset
LAUNCHES: Dict[str, int] = {
    "level_fused": 0, "rank_hist": 0, "sort_windows": 0,
    "level_fused_radix": 0, "level_fused_batched": 0, "rank_hist_batched": 0,
    "merge_path": 0, "dispatch_ranks": 0, "partition_ranks": 0, "partition_ranks_batched": 0,
    "classify_histogram": 0, "classify_histogram_batched": 0, "radix_histogram": 0,
    "permute_blocks_by_dest": 0, "permute_blocks_inplace": 0,
    "flash_decode": 0, "flash_attention": 0, "flash_attention_f32": 0,
    # the 64-bit forms of K1, K1r, K4 level_fused_batched and K3
    "level_fused64": 0, "level_fused_radix64": 0, "level_fused_batched64": 0,
    "sort_windows64": 0,
    # the 64-bit form of K5, and K7 by key width (the names above: 32-bit keys)
    "merge_path64": 0,
    "classify_histogram8": 0, "classify_histogram16": 0, "classify_histogram64": 0,
    "classify_histogram_batched8": 0, "classify_histogram_batched16": 0,
    "classify_histogram_batched64": 0, "radix_histogram64": 0,
    # the one-device sort's glue (G1-G4, csrc/glue.cu); G3's int64 form apart
    "close_placement": 0, "segment_ids": 0, "composite_ids": 0, "composite_ids64": 0,
    "scatter_rows": 0, "gather_windows": 0,
    # G5 (csrc/codec.cu), G6 (csrc/glue.cu) and G7 (csrc/fallback.cu)
    "codec_encode": 0, "codec_decode": 0, "sample_splitters": 0,
    "fallback_list": 0, "fallback_sort": 0,
}

# callables (name, flops, bytes) told of each launch a wrapper stands in for
FAKE_HOOKS: List[Callable[[str, float, float], None]] = []

_LIBS: Dict[str, ctypes.CDLL] = {}
P = ctypes.c_void_p
I = ctypes.c_int


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(stem: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # the shared device code
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}-{digest.hexdigest()[:12]}.so"


def build_all(stems: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Build every missing library, one ``nvcc`` per source in parallel.

    Returns {stem: compiler log} for the sources built by this call (the
    ``-Xptxas=-v`` register and shared-memory report); raises with the log
    if any build fails.
    """
    todo = [s for s in stems if not _lib_path(s).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in todo:
        final = _lib_path(stem)
        tmp = final.with_name(f"{final.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    logs, failed = {}, []
    for stem, (tmp, proc) in procs.items():
        logs[stem] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, _lib_path(stem))
        else:
            failed.append(stem)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[s] for s in failed)
        )
    return logs


def library(stem: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built on first use, with
    ``argtypes`` set from ``signatures`` ({function: argtypes}); every entry
    returns an int CUDA error code."""
    lib = _LIBS.get(stem)
    if lib is None:
        build_all([stem])
        lib = ctypes.CDLL(str(_lib_path(stem)))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        err_fn = getattr(lib, f"{stem}_error_string")
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
        _LIBS[stem] = lib
    return lib


def check(lib: ctypes.CDLL, stem: str, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err:
        msg: Optional[bytes] = getattr(lib, f"{stem}_error_string")(err)
        raise RuntimeError(f"{what}: CUDA error {err} ({(msg or b'').decode()})")


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the int ctypes passes."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (shapes and dtypes, no storage)."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def note_fake(name: str, flops: float, nbytes: float) -> None:
    """Report a launch of kernel ``name`` made on fake tensors, with the
    operations and bytes it would do, to every hook of :data:`FAKE_HOOKS`."""
    for hook in FAKE_HOOKS:
        hook(name, flops, nbytes)
