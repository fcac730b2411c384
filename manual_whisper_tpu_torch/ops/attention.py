"""Encoder self-attention: wrapper of kernel K2 (``csrc/flash_attention.cu``).

Replaces ``flash_attention`` / ``_flash_kernel`` of the JAX package's
``ops/attention.py``: non-causal softmax(q k^T / sqrt(dh)) v over
``[B, H, T, dh]``.  On a CUDA tensor the wrapper launches K2, counted as
(batch x heads, t_q, t_k, dh): the bf16
build (``wgmma`` products) for bf16 q, k and v, the float32 build for
float32 ones (3xTF32 ``wgmma`` products: each operand split into two TF32
values and three TF32 products summed, float32-class where one TF32
product would not be), each with a float32 online softmax and the output
in the inputs' dtype; the ragged edge of T is masked inside the kernel,
no padding here.  Other dtypes, or a mix, raise.  On a CPU tensor
it runs ``attention_plain``, which follows ``reference_attention``: scores
and softmax in float32, output in q's dtype.
"""

from __future__ import annotations

import math

import torch

from ..spans import count
from . import _build


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """Plain PyTorch version of K2 (f32 scores/softmax/sum, q's dtype out)."""
    dh = q.shape[-1]
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(dh)
    p = torch.softmax(s, dim=-1)
    return (p @ v.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """softmax(q k^T / sqrt(dh)) v for [B, H, T, dh] inputs (non-causal)."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    suffix = _build.attention_dtype("flash attention", q, k, v)
    b, h, t_q, dh = q.shape
    t_k = k.shape[2]
    for name, t, shape in (("q", q, (b, h, t_q, dh)), ("k", k, (b, h, t_k, dh)),
                           ("v", v, (b, h, t_k, dh))):
        _build.require(t, name, q.dtype, shape, q.device)
    if dh not in (32, 64):
        raise ValueError(f"flash kernel takes head_dim 32 or 64, got {dh}")
    out = torch.empty_like(q)
    entry = getattr(_build.library("flash_attention"),
                    "mwx_flash_attention" + suffix)
    err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b * h, t_q, t_k, dh, _build.stream_of(q))
    _build.check(err, f"flash_attention{suffix} kernel")
    count("flash_attention" + suffix, (b * h, t_q, t_k, dh))
    return out
