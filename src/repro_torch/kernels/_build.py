"""Build and load the CUDA kernel library.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` — one
``nvcc -c`` process per source, all started together — and linked into one
shared library with a plain C interface, loaded with ``ctypes``.  Nothing here
includes PyTorch's headers, so a build takes seconds.  The library is built at
first use (never at import) into ``build/`` at the root of the checkout, or
into ``$REPRO_TORCH_BUILD_DIR``; its file name carries a hash of the sources
and flags, so an edited source is rebuilt and a built one is reused.

A failed build raises: callers on a CUDA tensor get the error, not a slower
substitute.
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
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("demm_xwt.cu", "demm_xwt_q8.cu", "demm_block_spmm.cu",
           "demm_block_spmm_q8.cu", "demm_spmm_tc.cu")
HEADERS = ("demm_xwt_common.cuh", "demm_block_spmm_common.cuh",
           "hopper_async.cuh", "demm_block_cluster.cuh", "demm_spmm_tc.cuh",
           "demm_xwt_bulk.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None    # wall time of the last real build


class KernelCompileError(RuntimeError):
    """nvcc is missing or refused a source."""


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> the checkout root
    return Path(__file__).resolve().parents[3] / "build"


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home:
            cands.append(os.path.join(home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelCompileError(
        "nvcc not found (looked on PATH, $CUDA_HOME, $CUDA_PATH and "
        "/usr/local/cuda): the CUDA kernels cannot be built on this machine")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS + _extra_flags()).encode())
    return h.hexdigest()[:16]


def _extra_flags():
    """``$REPRO_TORCH_NVCC_FLAGS`` (e.g. ``-Xptxas -v``) is appended to every
    nvcc call, and the compiler's output is then shown."""
    return tuple(os.environ.get("REPRO_TORCH_NVCC_FLAGS", "").split())


def _run_all(cmds) -> None:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failures = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out}")
        elif _extra_flags() and out.strip():
            print(f"$ {' '.join(cmd)}\n{out}", flush=True)
    if failures:
        raise KernelCompileError("nvcc failed:\n" + "\n".join(failures))


def _build(target: Path) -> None:
    nvcc = find_nvcc()
    out_dir = target.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{target.stem}.{os.getpid()}"
    objs = [out_dir / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    tmp = out_dir / f"{tag}.so"
    try:
        _run_all([[nvcc, *NVCC_FLAGS, *_extra_flags(), "-c", str(CSRC / s),
                   "-o", str(o)]
                  for s, o in zip(SOURCES, objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                   "-o", str(tmp)]])
        os.replace(tmp, target)       # atomic: a reader never sees half a file
    finally:
        for f in (*objs, tmp):
            if f.exists():
                f.unlink()


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # pointers and the stream are c_void_p: without argtypes ctypes would
    # pass them as 32-bit ints and cut the addresses
    lib.demm_xwt_launch.argtypes = [p, p, p, p, *[i] * 13, p]
    lib.demm_xwt_q8_launch.argtypes = [p, p, p, p, p, *[i] * 14, p]
    lib.demm_block_spmm_launch.argtypes = [p, p, p, p, p, *[i] * 8, *[ll] * 7,
                                           *[i] * 7, p]
    lib.demm_block_spmm_q8_launch.argtypes = [p, p, p, p, p, p, *[i] * 8,
                                              *[ll] * 4, *[i] * 5, p]
    lib.demm_spmm_tc_launch.argtypes = [p, i, p, p, p, *[i] * 5, *[ll] * 3,
                                        *[i] * 6, p]
    lib.demm_empty_launch.argtypes = [i, i, i, i, i, p]
    for fn in (lib.demm_xwt_launch, lib.demm_xwt_q8_launch,
               lib.demm_block_spmm_launch, lib.demm_block_spmm_q8_launch,
               lib.demm_spmm_tc_launch, lib.demm_empty_launch):
        fn.restype = i


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            target = build_dir() / f"libdemm_kernels_{_source_hash()}.so"
            if not target.exists():
                t0 = time.perf_counter()
                _build(target)
                build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(str(target))
            _declare(lib)
            _lib = lib
    return _lib
