"""Build, load and call the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` (plain C interface) is compiled by ``nvcc`` for
``sm_90a`` into its own shared library, ``lib<name>.so``, and loaded with
``ctypes``. Builds happen on first use, all sources at once (one ``nvcc``
per source, started together), into ``build/kernels/<digest>/`` at the
repository root; the digest covers the sources, the headers and the
flags, so an edited kernel is rebuilt and an unchanged one is reused.

Importing this module needs no compiler: only a kernel launch (or an
explicit ``build()``) does, and without ``nvcc`` it raises.

A wrapper called with operands on the meta device (the dry run,
``launch/dryrun.py``) takes the same route as on CUDA up to the launch:
it allocates its outputs and scratch, on meta, then ``would_launch``
records the launch — one a call, with the operations and bytes its
kernel's bound counts — in place of building and calling the library.
A meta tensor computes nothing; a CUDA tensor still launches or raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import torch

__all__ = ["BUILD_ROOT", "SOURCES", "build", "call", "check", "library",
           "nbytes", "on_card", "reset_would_launch", "stream_of",
           "would_launch", "would_launch_counts"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("serve_solve", "fold", "gram", "cholesky", "ngd_apply",
           "cholupdate", "flash_attention")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

_loaded: Dict[str, ctypes.CDLL] = {}
# the meta route's record: {wrapper: {"launches", "flops", "bytes"}}
_WOULD: Dict[str, Dict[str, float]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on first "
                           "use and need the CUDA toolkit")
    return path


def _digest() -> str:
    h = hashlib.blake2b(digest_size=8)
    h.update(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()


def build_dir() -> Path:
    return BUILD_ROOT / _digest()


def build(names=SOURCES) -> Dict[str, Path]:
    """Compile every named source that is not built yet, all in parallel.
    Returns ``{name: library path}``; the ptxas report of each build is
    kept beside its library as ``lib<name>.log``."""
    out = build_dir()
    libs = {name: out / f"lib{name}.so" for name in names}
    todo = [name for name, lib in libs.items() if not lib.exists()]
    if not todo:
        return libs
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        (out / f"lib{name}.log").write_text(log)
        if proc.returncode == 0:
            os.replace(tmp, libs[name])
        else:
            os.unlink(tmp)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return libs


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built if needed), with
    ``argtypes`` set from ``signatures`` and every entry returning int."""
    lib = _loaded.get(name)
    if lib is None:
        path = build(SOURCES)[name]
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = I
        lib.repro_error_string.argtypes = [I]
        lib.repro_error_string.restype = ctypes.c_char_p
        lib.repro_set_device.argtypes = [I]
        lib.repro_set_device.restype = I
        _loaded[name] = lib
    return lib


def call(lib: ctypes.CDLL, fn: str, device: torch.device, *args) -> None:
    """Run a C launch entry on ``device``; raise if it returned a CUDA
    error."""
    err = lib.repro_set_device(device.index or 0) or getattr(lib, fn)(*args)
    if err:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{fn}: CUDA error {err} ({msg})")


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes a kernel's wrapper: a CUDA tensor (the launch)
    or a meta tensor (the dry run's would-be launch)."""
    return t.device.type in ("cuda", "meta")


def nbytes(*tensors: Optional[torch.Tensor]) -> int:
    """Bytes of the given tensors (``None`` skipped): what a kernel reads
    or writes when it touches each once."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def would_launch(device: torch.device, name: str, *, flops: float,
                 nbytes: float) -> bool:
    """On the meta device: record one would-be launch of ``name``'s kernel,
    with its operations and the bytes it must move, and return True (the
    caller then skips the build and the launch). False on any other
    device."""
    if device.type != "meta":
        return False
    rec = _WOULD.setdefault(name, {"launches": 0, "flops": 0.0,
                                   "bytes": 0.0})
    rec["launches"] += 1
    rec["flops"] += float(flops)
    rec["bytes"] += float(nbytes)
    return True


def would_launch_counts() -> Dict[str, Dict[str, float]]:
    """{wrapper: {"launches", "flops", "bytes"}} of the meta route since
    the last reset."""
    return {k: dict(v) for k, v in _WOULD.items()}


def reset_would_launch() -> None:
    _WOULD.clear()


def check(name: str, t: torch.Tensor, *, device: torch.device, dtypes,
          shape: Optional[tuple] = None) -> None:
    """Raise unless ``t`` is a contiguous tensor on ``device`` with one of
    ``dtypes`` and (when given) ``shape`` — what the kernels take."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the kernel runs on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                        f"{', '.join(str(d) for d in dtypes)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (row-major)")


def stream_of(t: torch.Tensor) -> int:
    """Handle of the current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
