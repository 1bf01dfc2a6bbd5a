"""Device resolution shared by the port's entry points.

``None`` means the CUDA card. When no card is present the entry points
raise instead of carrying on on the CPU: a caller who wants the CPU (the
tests, a laptop) says so with ``device="cpu"``.
"""
from __future__ import annotations

import shutil
import subprocess

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raising when no CUDA device is available);
    anything else is passed to :class:`torch.device` unchanged."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def to_numpy(x) -> np.ndarray:
    """Host numpy view of a tensor (copied off the device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def device_label(device) -> str:
    """Where numbers were taken: for a CUDA device its name and power limit
    as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (the name alone when nvidia-smi is missing), else the
    device's type (``cpu``)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = shutil.which("nvidia-smi")
    if smi:
        out = subprocess.run(
            [smi, "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(index)}, power limit not read"


__all__ = ["resolve_device", "to_numpy", "device_label"]
