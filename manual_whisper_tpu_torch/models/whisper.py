"""Whisper encoder-decoder in PyTorch (port of the JAX ``models/whisper.py``).

Weights are a plain nested dict of tensors (see ``convert.py`` for the
layout): matmul weights are ``[K, N]`` and used as ``x @ w`` like the JAX
package (block weights may be int8 ``{q, s}``, see ``ops/quant.py``), conv
weights are torch's ``[C_out, C_in, K]``, and each stack of blocks is a
list of per-layer dicts.

Numerics follow the JAX package: LayerNorm (eps 1e-5) in float32, exact
GELU, convolutions with float32 accumulation, attention scores and softmax
in float32, logits as x . tok_emb^T accumulated in float32.

Kernels: encoder self-attention goes through ``ops.attention``
(K2), decode-step self- and cross-attention through
``ops.decode_attention`` (K3, K4, or K5 over int8 cross K/V), every block
matmul through ``ops.quant.mm`` (K6 for int8 ``{q, s}`` weights); on a
CUDA tensor those launch the hand-written kernels, on a CPU tensor they
run the plain versions.  The prefill's attention (q_len = prefix) is plain
PyTorch, as it is XLA einsum in JAX.

KV cache layout: ``[B, H, T, dh]`` per layer (the JAX package's transposed
``[B, H, dh, T]`` exists only for TPU lane padding).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import flash_attention
from ..ops.decode_attention import (attend_int8_plain, attend_plain,
                                    decode_cross_attention,
                                    decode_cross_attention_int8,
                                    decode_self_attention)
from ..ops.quant import mm

Params = Dict[str, Any]
KVCache = Tuple[List[torch.Tensor], List[torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    name: str = "tiny"
    n_mels: int = 80
    n_vocab: int = 51865
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4
    num_languages: int = 99
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head

    def with_dtype(self, dtype: torch.dtype) -> "WhisperConfig":
        return dataclasses.replace(self, dtype=dtype)


def _cfg(name, d, h, l_enc, l_dec=None, n_mels=80, n_vocab=51865, langs=99):
    return WhisperConfig(
        name=name, n_mels=n_mels, n_vocab=n_vocab,
        n_audio_state=d, n_audio_head=h, n_audio_layer=l_enc,
        n_text_state=d, n_text_head=h,
        n_text_layer=l_dec if l_dec is not None else l_enc,
        num_languages=langs)


# Model menu mirrors the reference's WHISPER_MODEL options
# (.env.example:9: tiny/base/small/medium/large-v3; default large-v3).
MODEL_CONFIGS: Dict[str, WhisperConfig] = {
    "tiny": _cfg("tiny", 384, 6, 4),
    "base": _cfg("base", 512, 8, 6),
    "small": _cfg("small", 768, 12, 12),
    "medium": _cfg("medium", 1024, 16, 24),
    "large-v1": _cfg("large-v1", 1280, 20, 32),
    "large-v2": _cfg("large-v2", 1280, 20, 32),
    "large-v3": _cfg("large-v3", 1280, 20, 32, n_mels=128,
                     n_vocab=51866, langs=100),
    "large-v3-turbo": _cfg("large-v3-turbo", 1280, 20, 32, l_dec=4,
                           n_mels=128, n_vocab=51866, langs=100),
    # tiny synthetic config for tests (256-byte test tokenizer, 3 s window)
    "test": WhisperConfig(name="test", n_mels=80, n_vocab=2000,
                          n_audio_ctx=150, n_audio_state=64, n_audio_head=2,
                          n_audio_layer=2, n_text_ctx=64, n_text_state=64,
                          n_text_head=2, n_text_layer=2, num_languages=100,
                          dtype=torch.float32),
}


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Fixed sinusoidal encoder positions (OpenAI layout: [sin | cos])."""
    if channels % 2:
        raise ValueError(f"channels must be even, got {channels}")
    log_timescale_increment = math.log(10000) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment
                            * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)],
                          axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Random init (seeded; real checkpoints come through convert.py)
# ---------------------------------------------------------------------------

def init_params(cfg: WhisperConfig, device: torch.device,
                seed: int = 0) -> Params:
    """Random weights with the scales of the JAX ``init_params_host``,
    drawn by a ``torch.Generator`` on ``device`` (numpy at 1.5 B params
    takes minutes; the card takes well under a second)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d = cfg.n_audio_state
    dtype = cfg.dtype

    def normal(shape, scale):
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (x * scale).to(dtype)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    def dense(d_in, d_out):
        return normal((d_in, d_out), 1.0 / math.sqrt(d_in))

    def ln():
        return {"g": torch.ones(d, dtype=dtype, device=device), "b": zeros(d)}

    def attn():
        return {"q_w": dense(d, d), "q_b": zeros(d), "k_w": dense(d, d),
                "v_w": dense(d, d), "v_b": zeros(d),
                "o_w": dense(d, d), "o_b": zeros(d)}

    def block(cross):
        blk = {"ln1": ln(), "attn": attn(), "ln2": ln(),
               "mlp": {"fc1_w": dense(d, 4 * d), "fc1_b": zeros(4 * d),
                       "fc2_w": dense(4 * d, d), "fc2_b": zeros(d)}}
        if cross:
            blk["lnx"] = ln()
            blk["xattn"] = attn()
        return blk

    pos = torch.from_numpy(sinusoids(cfg.n_audio_ctx, d))
    return {
        "encoder": {
            "pos": pos.to(device=device, dtype=dtype),
            "conv1_w": normal((d, cfg.n_mels, 3),
                              1.0 / math.sqrt(3 * cfg.n_mels)),
            "conv1_b": zeros(d),
            "conv2_w": normal((d, d, 3), 1.0 / math.sqrt(3 * d)),
            "conv2_b": zeros(d),
            "blocks": [block(False) for _ in range(cfg.n_audio_layer)],
            "ln_post": ln(),
        },
        "decoder": {
            "tok_emb": normal((cfg.n_vocab, d), 0.02),
            "pos_emb": normal((cfg.n_text_ctx, d), 0.02),
            "blocks": [block(True) for _ in range(cfg.n_text_layer)],
            "ln": ln(),
        },
    }


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------

def _layer_norm(x: torch.Tensor, ln: Dict[str, torch.Tensor]) -> torch.Tensor:
    y = F.layer_norm(x.float(), (x.shape[-1],), ln["g"].float(),
                     ln["b"].float(), eps=1e-5)
    return y.to(x.dtype)


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _mlp(x: torch.Tensor, mlp: Dict[str, torch.Tensor]) -> torch.Tensor:
    h = F.gelu(mm(x, mlp["fc1_w"]) + mlp["fc1_b"])
    return mm(h, mlp["fc2_w"]) + mlp["fc2_b"]


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            stride: int) -> torch.Tensor:
    """x [B, T, C_in], w [C_out, C_in, 3] -> [B, T/stride, C_out], SAME pad,
    float32 accumulation (bf16 operands are exact in f32)."""
    y = F.conv1d(x.transpose(1, 2).float(), w.float(), b.float(),
                 stride=stride, padding=1)
    return y.transpose(1, 2).to(x.dtype)


def encode(params: Params, mel: torch.Tensor, cfg: WhisperConfig
           ) -> torch.Tensor:
    """mel [B, n_mels, T_frames] -> audio states [B, T_frames//2, d]."""
    enc = params["encoder"]
    x = mel.to(cfg.dtype).transpose(1, 2)                 # [B, T, n_mels]
    x = F.gelu(_conv1d(x, enc["conv1_w"], enc["conv1_b"], 1))
    x = F.gelu(_conv1d(x, enc["conv2_w"], enc["conv2_b"], 2))
    x = x + enc["pos"][: x.shape[1]].to(cfg.dtype)
    n_head = cfg.n_audio_head
    for blk in enc["blocks"]:
        a_in = _layer_norm(x, blk["ln1"])
        att = blk["attn"]
        q = _split_heads(mm(a_in, att["q_w"]) + att["q_b"], n_head)
        k = _split_heads(mm(a_in, att["k_w"]), n_head)
        v = _split_heads(mm(a_in, att["v_w"]) + att["v_b"], n_head)
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
        x = x + (mm(_merge_heads(out), att["o_w"]) + att["o_b"])
        x = x + _mlp(_layer_norm(x, blk["ln2"]), blk["mlp"])
    return _layer_norm(x, enc["ln_post"])


# -- decoder -----------------------------------------------------------------

def precompute_cross_kv(params: Params, xa: torch.Tensor, cfg: WhisperConfig,
                        quantize: bool = False,
                        scale_dtype: torch.dtype = torch.float32,
                        out: Optional[list] = None) -> list:
    """Per-layer cross-attention (k, v), each [B, H, Ta, dh], from encoder
    output xa [B, Ta, d]; computed once per batch, read by every step.

    With ``quantize`` each layer's K/V is quantized inside the layer loop
    (``quantize_cross_kv``), so the full-precision K/V of all layers never
    exists at once; each layer is then ``(k_q, k_s, v_q, v_s)``.  ``out``
    (a list of the same structure, e.g. ``alloc_cross_kv``) takes the
    results in place and is returned: the static buffers a captured decode
    chunk reads."""
    n_head = cfg.n_text_head
    layers = []
    for i, blk in enumerate(params["decoder"]["blocks"]):
        xat = blk["xattn"]
        k = _split_heads(mm(xa, xat["k_w"]), n_head).contiguous()
        v = _split_heads(mm(xa, xat["v_w"]) + xat["v_b"], n_head).contiguous()
        kv = quantize_cross_kv(k, v, scale_dtype) if quantize else (k, v)
        if out is not None:
            for dst, src in zip(out[i], kv):
                dst.copy_(src)
            kv = out[i]
        layers.append(kv)
    return layers


def alloc_cross_kv(cfg: WhisperConfig, batch: int, ta: int,
                   device: torch.device, quantize: bool = False,
                   scale_dtype: torch.dtype = torch.float32) -> list:
    """Zeroed buffers shaped as ``precompute_cross_kv``'s result, for its
    ``out``: per layer (k, v) [B, H, Ta, dh] in cfg.dtype, or with
    ``quantize`` (k_q, k_s, v_q, v_s): int8 codes and [B, H, Ta] scales."""
    h = cfg.n_text_head
    shape = (batch, h, ta, cfg.n_text_state // h)
    if not quantize:
        return [tuple(torch.zeros(shape, dtype=cfg.dtype, device=device)
                      for _ in range(2)) for _ in range(cfg.n_text_layer)]
    return [tuple(torch.zeros(s, dtype=t, device=device)
                  for s, t in ((shape, torch.int8), (shape[:3], scale_dtype))
                  * 2) for _ in range(cfg.n_text_layer)]


def quantize_cross_kv(k: torch.Tensor, v: torch.Tensor,
                      scale_dtype: torch.dtype = torch.float32):
    """Per-(batch, head, position) symmetric int8 of one layer's cross K/V
    [B, H, Ta, dh] (JAX ``quantize_cross_kv``): scale max(absmax over dh /
    127, 1e-8) in ``scale_dtype``; codes divide by the scale as stored (the
    rounded bf16 one for bf16), so they are exact for it.  Returns
    (k_q, k_s, v_q, v_s): codes int8 [B, H, Ta, dh], scales [B, H, Ta]."""
    def q(x):
        x32 = x.float()
        s = x32.abs().amax(dim=-1) / 127.0
        s = torch.clamp_min(s, 1e-8).to(scale_dtype)
        codes = torch.clamp(torch.round(x32 / s.float()[..., None]),
                            -127, 127).to(torch.int8)
        return codes, s
    k_q, k_s = q(k)
    v_q, v_s = q(v)
    return k_q, k_s, v_q, v_s


def init_kv_cache(cfg: WhisperConfig, batch: int, max_len: int,
                  device: torch.device) -> KVCache:
    """Self-attention cache: per-layer [B, H, max_len, dh] zeros."""
    shape = (batch, cfg.n_text_head, max_len,
             cfg.n_text_state // cfg.n_text_head)
    k = [torch.zeros(shape, dtype=cfg.dtype, device=device)
         for _ in range(cfg.n_text_layer)]
    v = [torch.zeros(shape, dtype=cfg.dtype, device=device)
         for _ in range(cfg.n_text_layer)]
    return k, v


@dataclasses.dataclass
class StepLengths:
    """Device-side lengths a decode step reads: ``pos`` (one int32, the
    cache slot the step writes and the last its self-attention reads) and
    ``cross_len`` (one int32, valid cross K/V)."""
    pos: torch.Tensor
    cross_len: torch.Tensor


def _decoder_block(h, blk, n_head, self_k, self_v, self_mask, xkv,
                   step: Optional[StepLengths] = None):
    """One decoder block.  ``step`` set (q_len = 1) routes both attentions
    through the decode kernels; otherwise the plain einsum path runs.
    ``xkv`` is the layer's cross (k, v) or its int8 4-tuple."""
    a_in = _layer_norm(h, blk["ln1"])
    att = blk["attn"]
    q = _split_heads(mm(a_in, att["q_w"]) + att["q_b"], n_head)
    if step is not None:
        attn_out = decode_self_attention(q, self_k, self_v, step.pos)
    else:
        attn_out = attend_plain(q, self_k, self_v, mask=self_mask)
    h = h + (mm(_merge_heads(attn_out), att["o_w"]) + att["o_b"])

    x_in = _layer_norm(h, blk["lnx"])
    xat = blk["xattn"]
    xq = _split_heads(mm(x_in, xat["q_w"]) + xat["q_b"], n_head)
    if len(xkv) == 2 and step is not None:
        xout = decode_cross_attention(xq, *xkv, step.cross_len)
    elif len(xkv) == 2:
        xout = attend_plain(xq, *xkv)
    elif step is not None:
        xout = decode_cross_attention_int8(xq, *xkv, step.cross_len)
    else:
        xout = attend_int8_plain(xq, *xkv)
    h = h + (mm(_merge_heads(xout), xat["o_w"]) + xat["o_b"])
    return h + _mlp(_layer_norm(h, blk["ln2"]), blk["mlp"])


def logits_f32(x: torch.Tensor, tok_emb_f32: torch.Tensor) -> torch.Tensor:
    """x [.., d] . tok_emb^T with float32 accumulation: bf16 operands are
    exact in f32, so this equals the JAX bf16 dot with f32 accumulation
    (bf16-rounded logits could flip a greedy argmax)."""
    return x.float() @ tok_emb_f32.t()


def decoder_forward(params: Params, tokens: torch.Tensor,
                    xa: Optional[torch.Tensor], cfg: WhisperConfig,
                    pos_offset: int = 0, kv_cache: Optional[KVCache] = None,
                    cross_kv=None) -> Tuple[torch.Tensor, KVCache]:
    """Teacher-forced / prefill decoder pass (plain PyTorch).

    tokens [B, T] -> (logits [B, T, n_vocab] f32, cache).  With
    ``kv_cache`` (per-layer [B, H, max_len, dh]) K/V are written at
    [pos_offset, pos_offset + T) and the queries attend causally over the
    cache; ``cross_kv`` takes the output of ``precompute_cross_kv`` (then
    ``xa`` may be None)."""
    dec = params["decoder"]
    n_head = cfg.n_text_head
    b, t = tokens.shape
    if kv_cache is None and pos_offset:
        raise ValueError("decoder_forward with pos_offset > 0 requires a "
                         "kv_cache sized for pos_offset + T")
    if kv_cache is None:
        kv_cache = init_kv_cache(cfg, b, t, tokens.device)
    if cross_kv is None:
        cross_kv = precompute_cross_kv(params, xa, cfg)

    x = (dec["tok_emb"][tokens]
         + dec["pos_emb"][pos_offset:pos_offset + t]).to(cfg.dtype)
    end = pos_offset + t
    q_pos = pos_offset + torch.arange(t, device=tokens.device)[:, None]
    k_pos = torch.arange(end, device=tokens.device)[None, :]
    mask = torch.zeros(t, end, device=tokens.device).masked_fill(
        k_pos > q_pos, float("-inf"))

    for blk, ck, cv, xkv in zip(dec["blocks"], kv_cache[0], kv_cache[1],
                                cross_kv):
        a_in = _layer_norm(x, blk["ln1"])
        att = blk["attn"]
        ck[:, :, pos_offset:end] = _split_heads(mm(a_in, att["k_w"]), n_head)
        cv[:, :, pos_offset:end] = _split_heads(mm(a_in, att["v_w"])
                                                + att["v_b"], n_head)
        x = _decoder_block(x, blk, n_head, ck[:, :, :end], cv[:, :, :end],
                           mask, xkv)
    x = _layer_norm(x, dec["ln"])
    return logits_f32(x, dec["tok_emb"].float()), kv_cache


def decode_step(params: Params, token: torch.Tensor, lengths: StepLengths,
                kv_cache: KVCache, cross_kv, cfg: WhisperConfig,
                tok_emb_f32: torch.Tensor) -> torch.Tensor:
    """One decode step: token [B] at position ``lengths.pos`` -> logits
    [B, V] f32.

    The position is read on the device only (one int32, as the kernels
    read it): the position embedding through ``index_select`` and slot
    ``pos`` of every layer's cache written in place with ``index_copy_``
    (the JAX version returns a new cache), so a CUDA graph of the step
    replays at every position.  ``tok_emb_f32`` is the float32 view of the
    embedding the caller keeps for the whole loop."""
    dec = params["decoder"]
    n_head = cfg.n_text_head
    slot = lengths.pos.long()
    x = dec["tok_emb"][token] + dec["pos_emb"].index_select(0, lengths.pos)
    h = x[:, None, :].to(cfg.dtype)                        # [B, 1, d]
    for blk, ck, cv, xkv in zip(dec["blocks"], kv_cache[0], kv_cache[1],
                                cross_kv):
        a_in = _layer_norm(h, blk["ln1"])
        att = blk["attn"]
        b = ck.shape[0]
        ck.index_copy_(2, slot, mm(a_in[:, 0], att["k_w"]).reshape(
            b, n_head, 1, -1))
        cv.index_copy_(2, slot, (mm(a_in[:, 0], att["v_w"])
                                 + att["v_b"]).reshape(b, n_head, 1, -1))
        h = _decoder_block(h, blk, n_head, ck, cv, None, xkv, step=lengths)
    x = _layer_norm(h, dec["ln"])[:, 0, :]
    return logits_f32(x, tok_emb_f32)
