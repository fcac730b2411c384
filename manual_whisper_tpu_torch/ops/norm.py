"""The decode step's bias + residual add + LayerNorm: wrapper of the kernel
in ``csrc/add_layer_norm.cu``.

No Pallas kernel corresponds: the JAX package leaves this sequence to XLA's
fusion.  In the port's decode step (``models/whisper.py`` ``decode_step``)
it runs at each of a block's three residual points and at the final
LayerNorm: ``h_new = h + (delta + bias)``, then ``y = LayerNorm(h_new)``,
where ``delta`` is a projection's output (all-reduced over the model group
first) and h the residual stream.  On a CUDA tensor ``add_layer_norm``
launches the kernel, bf16 or float32 (launches counted as
``add_layer_norm`` and ``add_layer_norm_f32``, by (rows, d)), or raises;
on a CPU tensor it runs ``add_layer_norm_plain``, the unfused sequence.
Both round where PyTorch's unfused sequence rounds, so ``h_new`` is the
same bits on the card; y is LayerNorm in float32 (eps 1e-5) rounded to the element type
once, as ``layer_norm_plain``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..spans import count
from . import _build

# widest row a block holds in registers: 1024 threads of one 16-byte load
_MAX_D = {torch.bfloat16: 8192, torch.float32: 4096}


def layer_norm_plain(x: torch.Tensor, g: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis in float32 (eps 1e-5), returned in x's
    dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(),
                     eps=1e-5)
    return y.to(x.dtype)


def add_layer_norm_plain(h: torch.Tensor, delta: Optional[torch.Tensor],
                         bias: Optional[torch.Tensor], g: torch.Tensor,
                         b: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: (h + (delta + bias), its LayerNorm).
    Without ``delta`` h itself and its LayerNorm; without ``bias``
    h + delta."""
    if delta is not None:
        h = h + (delta if bias is None else delta + bias)
    return h, layer_norm_plain(h, g, b)


def add_layer_norm(h: torch.Tensor, delta: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], g: torch.Tensor,
                   b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h_new, y): h_new = h + (delta + bias), y = LayerNorm(h_new; g, b),
    over rows of h [..., d]; delta as h, bias, g and b [d], all bf16 or all
    float32.  ``delta`` None: h_new is h (only the LayerNorm runs);
    ``bias`` None: h_new = h + delta.  d a multiple of 8."""
    if h.device.type == "cpu":
        return add_layer_norm_plain(h, delta, bias, g, b)
    name = "add_layer_norm"
    dtypes = {t.dtype for t in (h, delta, bias, g, b) if t is not None}
    if len(dtypes) != 1 or h.dtype not in _MAX_D:
        raise ValueError(f"{name}: h, delta, bias, gamma and beta must be "
                         f"all bfloat16 or all float32, got dtype "
                         f"{sorted(str(t) for t in dtypes)}")
    suffix = _build.ATTENTION_DTYPES[h.dtype]
    d = h.shape[-1]
    if d % 8 or d > _MAX_D[h.dtype]:
        raise ValueError(f"{name}: d must be a multiple of 8 up to "
                         f"{_MAX_D[h.dtype]}, got {d}")
    if bias is not None and delta is None:
        raise ValueError(f"{name}: a bias needs a delta")
    _build.require(h, "h", h.dtype, h.shape, h.device)
    for t, tname in ((g, "gamma"), (b, "beta"), (bias, "bias")):
        if t is not None:
            _build.require(t, tname, h.dtype, (d,), h.device)
    y = torch.empty_like(h)
    h_new = h
    if delta is not None:
        _build.require(delta, "delta", h.dtype, h.shape, h.device)
        h_new = torch.empty_like(h)
    entry = getattr(_build.library(name), "mwx_add_layer_norm" + suffix)
    err = entry(h.data_ptr(), None if delta is None else delta.data_ptr(),
                None if bias is None else bias.data_ptr(), g.data_ptr(),
                b.data_ptr(), h_new.data_ptr(), y.data_ptr(),
                h.numel() // d, d, _build.stream_of(h))
    _build.check(err, f"{name}{suffix} kernel")
    count(name + suffix, (h.numel() // d, d))
    return h_new, y
