"""Decode-step (q_len = 1) attention: wrappers of kernels K3, K4 and K5
(``csrc/decode_attention.cu``).

Replace ``decode_self_attention`` / ``_self_kernel``,
``decode_cross_attention`` / ``_cross_bf16_kernel`` and
``decode_cross_attention_int8`` / ``_cross_int8_kernel`` of the JAX
package's ``ops/decode_attention.py``.  Layouts are the port's: q ``[B, H, 1, dh]``,
K/V ``[B, H, T, dh]`` (the JAX package keeps ``[B, H, dh, T]`` for TPU
lane tiles).  The number of valid positions comes from a one-element
int32 tensor on q's device (``pos``: slots <= pos valid; ``kv_len``:
positions < kv_len valid), so the kernel reads it on the device.

On a CUDA tensor each wrapper launches its kernel (float32 softmax and
sums, bf16 output).  On a CPU tensor it runs the plain version, which
follows the JAX einsum paths (``whisper.py`` ``_decoder_block`` and
``_cross_attend``): f32 scores and softmax, probabilities cast to q's
dtype, then the weighted sum in q's dtype.  The int8 cross K/V of K5 is
``(k_q, k_s, v_q, v_s)`` from ``models.whisper.quantize_cross_kv``: codes
int8 ``[B, H, Ta, dh]``, per-position scales ``[B, H, Ta]`` in float32 or
bf16.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build


def attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 n_valid: Optional[int] = None,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K3/K4, and the prefill's attention: q [B, H, Tq, dh]
    over the first ``n_valid`` positions (all when None) of k/v
    [B, H, T, dh], plus an optional additive float mask [Tq, T]."""
    dh = q.shape[-1]
    s = (q.float() @ k.float().transpose(-1, -2)) * dh ** -0.5
    if n_valid is not None:
        valid = torch.arange(k.shape[2], device=q.device) < n_valid
        s = s.masked_fill(~valid, float("-inf"))
    if mask is not None:
        s = s + mask
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return p @ v


def attend_int8_plain(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
                      v_q: torch.Tensor, v_s: torch.Tensor,
                      n_valid: Optional[int] = None) -> torch.Tensor:
    """Plain version of K5, and the prefill's int8 cross-attention (the JAX
    einsum ``_cross_attend``): scores (q . k_q) / sqrt(dh) * k_s in f32,
    f32 softmax over the first ``n_valid`` positions (all when None), then
    (p * v_s) cast to q's dtype times v_q in q's dtype."""
    dh = q.shape[-1]
    s = (q.float() @ k_q.float().transpose(-1, -2)) * dh ** -0.5
    s = s * k_s.float()[:, :, None, :]
    if n_valid is not None:
        valid = torch.arange(k_q.shape[2], device=q.device) < n_valid
        s = s.masked_fill(~valid, float("-inf"))
    p = torch.softmax(s, dim=-1) * v_s.float()[:, :, None, :]
    return p.to(q.dtype) @ v_q.to(q.dtype)


def _check_lengths(name: str, q: torch.Tensor, length: torch.Tensor,
                   t_max: int) -> None:
    dh = q.shape[-1]
    if length.device != q.device or length.dtype != torch.int32 \
            or length.numel() != 1:
        raise ValueError(f"{name}: the length must be one int32 on "
                         f"{q.device}, got {length.dtype} "
                         f"{tuple(length.shape)} on {length.device}")
    if dh not in (32, 64):
        raise ValueError(f"{name}: head_dim must be 32 or 64, got {dh}")
    if t_max > 8192:
        raise ValueError(f"{name}: at most 8192 positions, got {t_max}")


def _checked_output(name: str, q, k, v, length: torch.Tensor):
    """Check what K3 and K4 take; returns (batch*heads, t_max, head_dim)
    and the empty output."""
    b, h, _, dh = q.shape
    t_max = k.shape[2]
    _build.require(q, "q", torch.bfloat16, (b, h, 1, dh), q.device)
    _build.require(k, "k", torch.bfloat16, (b, h, t_max, dh), q.device)
    _build.require(v, "v", torch.bfloat16, (b, h, t_max, dh), q.device)
    _check_lengths(name, q, length, t_max)
    return (b * h, t_max, dh), torch.empty_like(q)


def decode_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pos: torch.Tensor) -> torch.Tensor:
    """K3: q_len = 1 attention over the self cache, slots <= pos valid;
    the key axis split over a cluster of 4 blocks per (batch, head) while
    there are no more (batch, head) pairs than SMs, of 2 beyond that.

    q [B, H, 1, dh]; k/v [B, H, T_max, dh]; pos one int32.  Returns
    [B, H, 1, dh]."""
    if q.device.type == "cpu":
        return attend_plain(q, k, v, int(pos.reshape(-1)[0]) + 1)
    name = "decode_self_attention"
    dims, out = _checked_output(name, q, k, v, pos)
    err = _build.library("decode_attention").mwx_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        pos.data_ptr(), 1, *dims, _build.stream_of(q))
    _build.check(err, f"{name} kernel")
    _build.count(name)
    return out


def decode_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len: torch.Tensor) -> torch.Tensor:
    """K4: q_len = 1 attention over cross K/V, positions < kv_len valid,
    the key axis split over a cluster of blocks per (batch, head).

    q [B, H, 1, dh]; k/v [B, H, Ta, dh]; kv_len one int32.  Returns
    [B, H, 1, dh]."""
    if q.device.type == "cpu":
        return attend_plain(q, k, v, int(kv_len.reshape(-1)[0]))
    name = "decode_cross_attention"
    dims, out = _checked_output(name, q, k, v, kv_len)
    err = _build.library("decode_attention").mwx_decode_cross_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        kv_len.data_ptr(), *dims, _build.stream_of(q))
    _build.check(err, f"{name} kernel")
    _build.count(name)
    return out


def decode_cross_attention_int8(q: torch.Tensor, k_q: torch.Tensor,
                                k_s: torch.Tensor, v_q: torch.Tensor,
                                v_s: torch.Tensor,
                                kv_len: torch.Tensor) -> torch.Tensor:
    """K5: q_len = 1 attention over int8 cross K/V, positions < kv_len,
    the key axis split over a cluster of blocks per (batch, head) as K4's.

    q [B, H, 1, dh] bf16; k_q/v_q int8 [B, H, Ta, dh]; k_s/v_s [B, H, Ta]
    float32 or bf16 (both the same); kv_len one int32.  Returns
    [B, H, 1, dh] in q's dtype."""
    if q.device.type == "cpu":
        return attend_int8_plain(q, k_q, k_s, v_q, v_s,
                                 int(kv_len.reshape(-1)[0]))
    name = "decode_cross_attention_int8"
    b, h, _, dh = q.shape
    ta = k_q.shape[2]
    if k_s.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: scales must be float32 or bf16, got "
                         f"{k_s.dtype}")
    _build.require(q, "q", torch.bfloat16, (b, h, 1, dh), q.device)
    for t, tname in ((k_q, "k_q"), (v_q, "v_q")):
        _build.require(t, tname, torch.int8, (b, h, ta, dh), q.device)
    for t, tname in ((k_s, "k_s"), (v_s, "v_s")):
        _build.require(t, tname, k_s.dtype, (b, h, ta), q.device)
    _check_lengths(name, q, kv_len, ta)
    out = torch.empty_like(q)
    lib = _build.library("decode_attention")
    err = lib.mwx_decode_attention_int8(
        q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
        v_s.data_ptr(), out.data_ptr(), kv_len.data_ptr(), b * h, ta, dh,
        int(k_s.dtype == torch.bfloat16), _build.stream_of(q))
    _build.check(err, f"{name} kernel")
    _build.count(name)
    return out
