"""Encoder self-attention: wrapper of kernel K2 (``csrc/flash_attention.cu``).

Replaces ``flash_attention`` / ``_flash_kernel`` of the JAX package's
``ops/attention.py``: non-causal softmax(q k^T / sqrt(dh)) v over
``[B, H, T, dh]``.  On a CUDA tensor the wrapper launches K2 (bf16 in and
out, float32 online softmax; the ragged edge of T is masked inside the
kernel, no padding here).  On a CPU tensor it runs ``attention_plain``,
which follows ``reference_attention``: scores and softmax in float32,
output in q's dtype.
"""

from __future__ import annotations

import math

import torch

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
    b, h, t_q, dh = q.shape
    t_k = k.shape[2]
    for name, t, shape in (("q", q, (b, h, t_q, dh)), ("k", k, (b, h, t_k, dh)),
                           ("v", v, (b, h, t_k, dh))):
        _build.require(t, name, torch.bfloat16, shape, q.device)
    if dh not in (32, 64):
        raise ValueError(f"flash kernel takes head_dim 32 or 64, got {dh}")
    out = torch.empty_like(q)
    lib = _build.library("flash_attention")
    err = lib.mwx_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  out.data_ptr(), b * h, t_q, t_k, dh,
                                  _build.stream_of(q))
    _build.check(err, "flash attention kernel")
    _build.count("flash_attention")
    return out
