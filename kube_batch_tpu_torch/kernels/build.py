"""Build and load the CUDA kernels of this package.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` into its own shared library, loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

A library is built at first use, from the sources in this checkout, into
`kernels/_build/` (listed in .gitignore), under a name that carries the
hash of its source, the local headers it includes (`#include "x.cuh"`,
e.g. `csrc/cta_sort.cuh`, `csrc/affinity_words.cuh`) and the flags, so an edited source or header
is rebuilt.
`build_all()` starts one `nvcc` per source at once and waits for all of
them.  Nothing here runs at import time: the CPU tests import every
module of the package on a machine without `nvcc`.

`--fmad=false` keeps every float multiply and add separately rounded:
the propose kernel's scores must equal the plain version's bit for bit,
because ties decide placements.  `--use_fast_math` is never used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
SOURCES = ("predicate_mask", "propose", "resolve", "failure_counts", "victim_prefix",
           "preempt_scan", "segment_sum", "lex_rank", "row_patch",
           "resident_tables", "affinity_mask", "joint_tier", "podaff_score")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_lock = threading.Lock()
#: name → ptxas report (registers, shared memory, spills) of the last build
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels need the CUDA toolkit to build"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(path: str, seen: list[str]) -> list[str]:
    """`path` and the local headers it includes, recursively, each once."""
    if path in seen:
        return seen
    seen.append(path)
    with open(path, "rb") as f:
        text = f.read()
    for inc in _INCLUDE.findall(text):
        _sources(os.path.join(os.path.dirname(path), inc.decode()), seen)
    return seen


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(src, []):
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str):
    src, out = _target(name)
    if os.path.exists(out):
        return None
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names=SOURCES) -> None:
    """Compile every listed source not built yet, all nvcc processes at
    once, and load the libraries."""
    with _lock:
        pending = {n: _start(n) for n in names if n not in _libs}
        errors = []
        for n, started in pending.items():
            try:
                _finish(n, started)
            except RuntimeError as exc:
                errors.append(str(exc))
        if errors:
            raise RuntimeError("\n".join(errors))
        for n in pending:
            _libs[n] = ctypes.CDLL(_target(n)[1])


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = _libs[name]
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """`symbol` of `csrc/<name>.cu`'s library with its argument types and
    an int result, bound once and kept."""
    key = (name, symbol)
    fn = _functions.get(key)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[key] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError())."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: error {err}")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (None → NULL)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_handle(device) -> int:
    """The current CUDA stream of `device` as an integer handle.

    Read with torch's private `torch._C._cuda_getCurrentRawStream` (torch
    2.0 or later; TorchInductor's generated code reads it the same way):
    on an H100 host with torch 2.11 it costs 0.2 µs a call against 10-13
    µs for the public `torch.cuda.current_stream(device).cuda_stream`,
    which builds a Stream object (scripts/check_torch_k6_k7.py), and every
    kernel wrapper reads it once per launch."""
    import torch

    index = torch.cuda.current_device() if device.index is None else device.index
    return torch._C._cuda_getCurrentRawStream(index)
