"""Device resolution and dtype helpers.

Every entry point of the port runs on the card unless the caller asks for
the CPU: ``resolve_device()`` defaults to ``"cuda"`` and raises when no
CUDA device is present; it never carries on on the CPU.  On CUDA it also
turns TF32 off for matmuls and cuDNN convolutions, so float32 work (the
log-mel plain path, LayerNorm inputs, the f32 convolutions of the
encoder stem, the logits) keeps float32 precision as in the JAX package.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]

# activation dtype of each compute_type; int8 quantizes the block weights
# on top of bf16 activations (``ops.quant``)
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.bfloat16,
           "float32": torch.float32, "int8": torch.bfloat16}


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``"cuda"`` (default), ``"cuda:N"`` or ``"cpu"`` -> torch.device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the PyTorch port runs on an NVIDIA "
                "GPU; pass device='cpu' explicitly to run the plain PyTorch "
                "versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use cuda or cpu")
    return dev


def compute_dtype(compute_type: str) -> torch.dtype:
    """CLI compute_type -> activation dtype (float16 and int8 map to bf16
    as in JAX)."""
    if compute_type not in _DTYPES:
        raise KeyError(f"unknown compute_type {compute_type!r}; options: "
                       f"{sorted(_DTYPES)}")
    return _DTYPES[compute_type]


def device_label(device: torch.device) -> str:
    """Human label for run reports: the card's name, or ``cpu``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
