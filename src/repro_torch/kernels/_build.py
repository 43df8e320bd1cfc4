"""Build the CUDA sources under ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has one or more plain C entry points and
compiles on its own into ``<build dir>/<name>-<hash>.so``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so csrc/<name>.cu

(``-Xptxas -v``: each kernel's registers, spills and shared memory, in
the log :func:`build_all` returns.)

The hash covers the source, every header under ``csrc/`` and the flags,
so an unchanged source is not rebuilt and a header edit rebuilds every
source. The build directory is ``kernels/.build`` beside this file
(listed in ``.gitignore``). No source includes PyTorch's headers, so a
build takes seconds; :func:`build_all` starts one ``nvcc`` per source,
all at once. Nothing here runs at import time: the first wrapper call
on a CUDA tensor builds and loads its library, inside a
``kernels.build`` span of the process-global recorder (so a build or
load inside a traced window shows as such).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

from ..obs import get_recorder
from ..obs import events as tr

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / ".build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signature of every entry point: source -> {symbol: argtypes}
SIGNATURES: Dict[str, Dict[str, list]] = {
    "paged_decode": {
        "batched_paged_decode_launch": [_P] * 10 + [_I] * 9 + [_F, _F, _I, _P],
        "paged_decode_launch": [_P] * 8 + [_I] * 8 + [_F, _F, _I, _P],
        "slot_decode_launch": [_P] * 7 + [_I] * 7 + [_L, _L] + [_F, _F, _I, _P],
    },
    "chunked_prefill": {
        "chunked_prefill_launch": [_P] * 7 + [_I] * 7 + [_F, _F, _I, _P],
    },
    "flash_attention": {
        "flash_attention_launch": [_P] * 4 + [_I] * 9 + [_F, _F, _I, _P],
    },
    "ssd_scan": {
        "ssd_scan_launch": [_P] * 7 + [_I] * 8 + [_P],
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the "
                       "CUDA toolkit (on PATH or under CUDA_HOME)")


def _lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of its source,
    every header under ``csrc/`` (which it may include) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``csrc/<name>.cu`` unless its library is current.
    Builds into a temporary name and renames, so a concurrent build
    never loads a half-written library. Returns (process, tmp, out) or
    None when the library is current."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    """Wait for nvcc; its log ("" if the library was current)."""
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, str]:
    """Build every source in ``SIGNATURES`` in parallel (one nvcc per
    source). Returns each name's nvcc log ("" where it was current)."""
    names = list(SIGNATURES)
    procs = {n: _start(n) for n in names}
    logs = {}
    try:
        for n in names:
            logs[n] = _finish(n, procs[n])
    finally:
        for started in procs.values():
            if started is not None and started[0].poll() is None:
                started[0].kill()
                started[0].wait()
    return logs


def load(name: str, symbol: str):
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, built on first
    use, with its ``argtypes`` set (``c_void_p`` for pointers and the
    stream) and ``restype`` ``c_int`` (the ``cudaGetLastError()`` after
    launch)."""
    if name not in _loaded:
        with get_recorder().span(tr.KERNELS_BUILD):
            _finish(name, _start(name))
            _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
    fn = getattr(_loaded[name], symbol)
    fn.argtypes = SIGNATURES[name][symbol]
    fn.restype = ctypes.c_int
    return fn


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data does not start on 16 bytes:
    the kernels load rows 16 bytes at a time (a contiguous view can start
    mid-row)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
