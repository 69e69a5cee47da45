"""Where the port's state lives: the card unless the caller asks otherwise."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card (``"cuda"``).
    Raises when a CUDA device is asked for and none is available: the port
    never carries on on the CPU unless ``device="cpu"`` is passed."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("mrt_tpu_torch runs on a CUDA device by default and none is available; "
                           "pass device='cpu' to run on the CPU")
    return device


def require_full_f32(x: torch.Tensor, what: str):
    """Raise on a CUDA tensor while f32 products may run in TF32: the port's
    dense products (LBS, the resize) are held to f32 results."""
    if x.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(f"{what} needs the f32 product in full precision; turn TF32 off "
                           "(torch.backends.cuda.matmul.allow_tf32 = False)")
