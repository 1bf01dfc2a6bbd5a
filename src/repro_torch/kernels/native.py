"""Build, load and count launches of the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` (one of ``SOURCES``; ``KERNELS`` says which
source holds each kernel) compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded through ``ctypes``. The
build happens at first use into ``build/repro_torch/`` at the repository
root; the file name carries a digest of the source, the headers beside it
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and a stale library is never loaded. All missing
libraries build at once, one ``nvcc`` process per source.

There is no fallback: a missing ``nvcc``, a failed build or a failed launch
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

# Each kernel and the source that holds it: a source may hold twins that
# must share a digest (DESIGN.md §10's bit-identity contract).
KERNELS = {"query_eval": "query_eval",
           "stratified_moments": "stratified_moments",
           "stratified_weighted_moments": "weighted_moments",
           "bootstrap_moments": "weighted_moments",
           "segment_reduce": "segment_reduce",
           "weighted_segment_reduce": "segment_reduce",
           "route_multid": "route_multid",
           "sample_extremes": "sample_extremes",
           "join_cell_moments": "join_moments",
           "threefry": "threefry",
           "join_epilogue": "join_epilogue"}
SOURCES = tuple(dict.fromkeys(KERNELS.values()))
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# Launches of each kernel since the last reset_launches(); each wrapper adds
# one right after its kernel was launched without error.
LAUNCHES = {name: 0 for name in KERNELS}

_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of repro_torch are compiled from "
        f"{CSRC} at first use and need the CUDA toolkit (set CUDA_HOME)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + headers
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all() -> dict[str, str]:
    """Compile every kernel library that is not built yet, all in parallel.
    Returns {name: compiler output} for the sources compiled by this call
    (registers and shared memory per kernel, from ``-Xptxas=-v``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in SOURCES:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        log = out.with_suffix(".log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu")], stdout=fh,
                stderr=subprocess.STDOUT)
        jobs[name] = (proc, tmp, out, log)
    logs, failed = {}, []
    for name, (proc, tmp, out, log) in jobs.items():
        proc.wait()
        logs[name] = log.read_text()
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check_launch(name: str, err: int) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by kernel ``name``'s C
    entry; count the launch otherwise."""
    if err != 0:
        msg = library(KERNELS[name]).repro_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: cuda error {err} "
                           f"({msg})")
    LAUNCHES[name] += 1


def current_stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current CUDA stream, by the accessor
    that PyTorch's own generated kernel launchers call, without building
    the ``torch.cuda.Stream`` object that ``torch.cuda.current_stream``
    returns: a wrapper's host issue is part of every call's time."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def launch(name: str, device: torch.device, fn, *args) -> None:
    """Call kernel ``name``'s C entry ``fn(*args, stream)`` on the current
    stream of ``device``, switching the current device only when it is
    another one (read by the accessor ``torch.cuda.current_device`` wraps),
    and count the launch (``check_launch``)."""
    if device.index == torch._C._cuda_getDevice():
        err = fn(*args, current_stream(device))
    else:
        with torch.cuda.device(device):
            err = fn(*args, current_stream(device))
    check_launch(name, err)


def device_type(name: str, *tensors) -> str:
    """The device type ('cuda' or 'cpu') that all tensors share; raises if
    they lie on several devices or on another type."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    kind = devices.pop().type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"{name}: no version for device type {kind!r}")
    return kind


def check_tensors(name: str, **tensors) -> None:
    """Every tensor on one CUDA device and contiguous."""
    if device_type(name, *tensors.values()) != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors")
    for key, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


class DtypeError(TypeError, ValueError):
    """A tensor of a dtype the kernel does not take: a TypeError, and a
    ValueError like a wrapper's other refusals of its arguments."""


def check_dtype(name: str, dtype, **tensors) -> None:
    for key, t in tensors.items():
        if t.dtype != dtype:
            raise DtypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")


__all__ = ["SOURCES", "KERNELS", "LAUNCHES", "reset_launches", "build_all",
           "library", "library_path", "check_launch", "current_stream",
           "launch", "device_type", "check_tensors", "check_dtype",
           "DtypeError"]
