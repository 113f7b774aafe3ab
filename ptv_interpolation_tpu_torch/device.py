"""The port's device policy: every public entry point takes ``device=``
and runs there. Nothing falls back to the CPU when a GPU was asked for."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` (a ``torch.device`` or a string such as ``"cuda"``,
    ``"cuda:1"`` or ``"cpu"``) as a ``torch.device``. Raises when a CUDA
    device is asked for and none is available."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but torch.cuda.is_available() "
            f"is false")
    return dev


def as_f32(x, device: torch.device) -> torch.Tensor:
    """``x`` (numpy array or tensor) as a float32 tensor on ``device`` —
    numpy inputs cross to the device once, here."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


_F32_TINY = torch.finfo(torch.float32).tiny


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its subnormal values set to 0, as XLA gives them on the
    CPU and the TPU (it flushes them), where a result of the JAX package
    depends on it: the weights and kernel matrices of a cell list's empty
    slots (d² = 3.4e38), whose values fall below the smallest normal
    f32. PyTorch keeps subnormals on both devices."""
    return torch.where(x.abs() < _F32_TINY, 0.0, x)
