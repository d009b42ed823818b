"""Lazy build of the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
into its own shared library under ``build/kernels/`` at the repository
root, loaded with ``ctypes``.  A source that includes no PyTorch header
builds in seconds, where a ``torch.utils.cpp_extension`` binding file
takes minutes of every fresh machine's time budget.  Libraries are
named by the hash of their source, of every header it includes from
``csrc/`` (``hopper.cuh``, shared by the ring-fed kernels) and of the
flags, so an edited source or header rebuilds and an unchanged one is
reused.  Nothing builds at import:
the first CUDA launch calls :func:`library`, and :func:`build_all` starts
one ``nvcc`` per source, all at once.

Every launch goes through :func:`launch`, on its operands' card: the
launchers' ``cudaFuncSetAttribute``, their context bind
(``cudaFree(nullptr)``) and the tensor maps they encode act on the
current device, and a stream belongs to one card.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("maple_spmm", "maple_sddmm", "maple_spgemm", "maple_spmspm",
           "moe_gemm", "block_attn")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built")
    return str(path)


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _sources(name: str) -> list:
    """``csrc/<name>.cu`` and every file it includes with quotes,
    transitively, each once, in the order first met."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / inc.decode()
                 for inc in _INCLUDE.findall(path.read_bytes())]
    return seen


def _target(name: str) -> Path:
    text = b"".join(path.read_bytes() for path in _sources(name))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> float:
    """Compile every missing library, one ``nvcc`` per source started
    together; returns the wall seconds spent.  Raises with the compiler's
    output if any build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _declare(name, lib)
        _LIBS[name] = lib
    return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "maple_spmm":
        lib.maple_spmm_naive.argtypes = [p] * 5 + [i] * 10 + [p]
        lib.maple_spmm_naive.restype = i
        lib.maple_spmm_naive_layout.argtypes = [i] * 8 + [p]
        lib.maple_spmm_naive_layout.restype = i
        lib.maple_spmm_compact.argtypes = [p] * 6 + [i] * 12 + [p]
        lib.maple_spmm_compact.restype = i
        lib.maple_spmm_planned.argtypes = [p] * 9 + [i] * 12 + [p]
        lib.maple_spmm_planned.restype = i
        lib.maple_spmm_run_layout.argtypes = [i] * 6 + [p, p]
        lib.maple_spmm_run_layout.restype = i
    elif name == "maple_sddmm":
        lib.maple_sddmm_bsr.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                        i, i, p]
        lib.maple_sddmm_bsr.restype = i
    elif name == "maple_spgemm":
        lib.maple_spgemm.argtypes = [p] * 7 + [i] * 5 + [p]
        lib.maple_spgemm.restype = i
        lib.maple_spgemm_route.argtypes = [i, i]
        lib.maple_spgemm_route.restype = i
        lib.maple_spgemm_route_shape.argtypes = [i, p]
        lib.maple_spgemm_route_shape.restype = i
        lib.maple_sddmm_csr.argtypes = [p] * 9 + [i] * 3 + [p]
        lib.maple_sddmm_csr.restype = i
        lib.maple_spgemm_db.argtypes = [p] * 7 + [i] * 3 + [p]
        lib.maple_spgemm_db.restype = i
        lib.maple_smem_optin.argtypes = [i]
        lib.maple_smem_optin.restype = i
    elif name == "maple_spmspm":
        lib.maple_spmspm.argtypes = [p] * 4 + [i] * 4 + [p]
        lib.maple_spmspm.restype = i
    elif name == "moe_gemm":
        for fn in (lib.maple_moe_gemm, lib.maple_moe_gemm_dx,
                   lib.maple_moe_dw):
            fn.argtypes = [p] * 4 + [i] * 6 + [p]
            fn.restype = i
        for fn in (lib.maple_moe_layout, lib.maple_moe_layout_dx,
                   lib.maple_moe_layout_dw):
            fn.argtypes = [i] * 6 + [p]
            fn.restype = i
    elif name == "block_attn":
        lib.maple_block_attention.argtypes = [p] * 5 + [i] * 11 + \
            [ctypes.c_float, p]
        lib.maple_block_attention.restype = i
        lib.maple_block_attention_layout.argtypes = [i, i, i, p]
        lib.maple_block_attention_layout.restype = i
    lib.maple_error_string.argtypes = [i]
    lib.maple_error_string.restype = ctypes.c_char_p


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (the launch never ran)."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.maple_error_string(err).decode()})")


def on(device: torch.device):
    """Make ``device`` current inside the block where it is a card (no-op
    for any other device): what the block launches, allocates without a
    device or synchronises acts on that card."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def launch(fn, device: torch.device, *args) -> int:
    """``fn(*args, stream)``, a launcher of this module's libraries, with
    ``device`` (the operands' card) current and ``stream`` its current
    stream; returns the launcher's error code.  A launch under any other
    current card would run there, on memory it cannot address."""
    with on(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
