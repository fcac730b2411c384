"""wav2vec2 CTC acoustic model (port of the JAX ``models/wav2vec2.py``).

The forced-alignment backbone: a seven-layer conv feature extractor, a
feature projection, a grouped positional convolution and a pre-LN
transformer with a CTC head, in the *stable-layer-norm* variant of
wav2vec2-large / XLSR (``do_stable_layer_norm=True``,
``feat_extract_norm='layer'``) that the alignment checkpoints use.

``Wav2Vec2`` is an ``nn.Module`` whose forward is ``wav2vec2_logits`` of
the JAX package, in float32 as the JAX ``AlignModel`` runs it: LayerNorm
(eps 1e-5) after every extractor conv, exact GELU, frames past a row's
``n_valid`` samples zeroed and masked out of attention as keys (HF
``attention_mask`` semantics), the positional conv padded by k // 2 on both
sides with its last frame dropped for an even kernel, pre-LN blocks, a
final LayerNorm and an f32 ``log_softmax`` head.  Its matmuls, attention
products and convolutions are library calls (``torch.matmul``, ``conv1d``,
cuDNN), as the JAX package computes them outside any Pallas kernel; on
CUDA they run with TF32 off (``device.resolve_device``).

Weights arrive as the JAX package's param tree (numpy leaves) through
``convert.from_jax_wav2vec2``; ``convert.convert_wav2vec2_state_dict``
maps an HF ``Wav2Vec2ForCTC`` state dict to that tree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (channels, kernel, stride) of the 7 conv feature-extractor layers;
# total stride 320 => one output frame per 20 ms at 16 kHz.
CONV_LAYERS: Tuple[Tuple[int, int, int], ...] = (
    (512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 3, 2),
    (512, 2, 2), (512, 2, 2))


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """The JAX package's defaults: XLSR-53 large (hidden 1024, 24 layers,
    16 heads, ffn 4096, conv 512, positional conv 128 in 16 groups)."""
    vocab_size: int = 32
    hidden: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    ffn: int = 4096
    conv_dim: int = 512
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16

    @classmethod
    def tiny_test(cls) -> "Wav2Vec2Config":
        return cls(vocab_size=12, hidden=64, n_layers=2, n_heads=2, ffn=128,
                   conv_dim=32, pos_conv_kernel=16, pos_conv_groups=2)


def frames_for_samples(n_samples: int) -> int:
    n = n_samples
    for _, k, s in CONV_LAYERS:
        n = (n - k) // s + 1
    return max(n, 0)


def valid_frames(n_valid: torch.Tensor) -> torch.Tensor:
    """Per-row sample counts -> per-row frame counts through the extractor
    (at least 1: a row with every key masked would NaN the softmax)."""
    nf = n_valid.to(torch.int64)
    for _, k, s in CONV_LAYERS:
        nf = torch.clamp(torch.div(nf - k, s, rounding_mode="floor") + 1,
                         min=0)
    return torch.clamp(nf, min=1)


class _Block(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        h, f = cfg.hidden, cfg.ffn
        self.ln1 = nn.LayerNorm(h, eps=1e-5)
        self.q, self.k, self.v, self.o = (nn.Linear(h, h) for _ in range(4))
        self.ln2 = nn.LayerNorm(h, eps=1e-5)
        self.fc1 = nn.Linear(h, f)
        self.fc2 = nn.Linear(f, h)


class Wav2Vec2(nn.Module):
    """audio ``[B, T]`` (zero-mean / unit-variance rows) -> CTC log-probs
    ``[B, frames, vocab]``, float32.

    ``n_valid`` ``[B]`` (optional) gives each row's real sample count:
    hidden states past its frame count are zeroed and those frames masked
    as attention keys, so bucket padding leaves the valid frames' logits
    as they would be unpadded.  ``conv_bias``: the extractor convs carry a
    bias (every XLSR-53 fine-tune does)."""

    def __init__(self, cfg: Wav2Vec2Config = Wav2Vec2Config(),
                 conv_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        c, h = cfg.conv_dim, cfg.hidden
        self.conv = nn.ModuleList(
            nn.Conv1d(1 if i == 0 else c, c, k, stride=s, bias=conv_bias)
            for i, (_, k, s) in enumerate(CONV_LAYERS))
        self.conv_ln = nn.ModuleList(nn.LayerNorm(c, eps=1e-5)
                                     for _ in CONV_LAYERS)
        self.fp_ln = nn.LayerNorm(c, eps=1e-5)
        self.fp = nn.Linear(c, h)
        self.pos_conv = nn.Conv1d(h, h, cfg.pos_conv_kernel,
                                  padding=cfg.pos_conv_kernel // 2,
                                  groups=cfg.pos_conv_groups)
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.n_layers))
        self.final_ln = nn.LayerNorm(h, eps=1e-5)
        self.lm_head = nn.Linear(h, cfg.vocab_size)
        self.requires_grad_(False)
        self.eval()

    def forward(self, audio: torch.Tensor,
                n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        x = audio.to(torch.float32)[:, None, :]             # [B, 1, T]
        for conv, ln in zip(self.conv, self.conv_ln):
            x = F.gelu(ln(conv(x).transpose(1, 2))).transpose(1, 2)
        x = x.transpose(1, 2)                                # [B, F, C]

        mask = None
        if n_valid is not None:
            nf = valid_frames(torch.as_tensor(n_valid, device=x.device))
            mask = torch.arange(x.shape[1], device=x.device)[None] \
                < nf[:, None]                                # [B, F]
            x = torch.where(mask[:, :, None], x, 0.0)

        x = self.fp(self.fp_ln(x))
        if mask is not None:
            x = torch.where(mask[:, :, None], x, 0.0)

        pos = self.pos_conv(x.transpose(1, 2))
        if cfg.pos_conv_kernel % 2 == 0:
            pos = pos[:, :, :-1]
        x = x + F.gelu(pos).transpose(1, 2)

        b, t, d = x.shape
        nh = cfg.n_heads
        dh = d // nh
        scale = dh ** -0.5
        key_mask = None if mask is None else ~mask[:, None, None, :]

        def heads(y):
            return y.reshape(b, t, nh, dh).transpose(1, 2)
        for blk in self.blocks:
            a = blk.ln1(x)
            q = heads(blk.q(a)) * scale
            s = q @ heads(blk.k(a)).transpose(-1, -2)
            if key_mask is not None:
                s = s.masked_fill(key_mask, float("-inf"))
            o = torch.softmax(s, dim=-1) @ heads(blk.v(a))
            x = x + blk.o(o.transpose(1, 2).reshape(b, t, d))
            x = x + blk.fc2(F.gelu(blk.fc1(blk.ln2(x))))
        x = self.final_ln(x)
        return F.log_softmax(self.lm_head(x), dim=-1)


def init_wav2vec2_params(generator: torch.Generator,
                         cfg: Wav2Vec2Config) -> Dict[str, Any]:
    """Random wav2vec2 params in the JAX package's tree layout (numpy
    leaves, blocks stacked ``[L, ...]``; ``convert.from_jax_wav2vec2``
    makes the module), drawn from ``generator`` with the JAX init's scales:
    normal / sqrt(fan_in) weights, zero biases, unit LayerNorms."""
    def normal(*shape, fan_in):
        w = torch.randn(*shape, generator=generator, dtype=torch.float32)
        return (w / math.sqrt(fan_in)).numpy()

    def zeros(n):
        return np.zeros(n, np.float32)

    def ones(n):
        return np.ones(n, np.float32)

    h, f, c = cfg.hidden, cfg.ffn, cfg.conv_dim
    conv = []
    c_in = 1
    for _, k, _ in CONV_LAYERS:
        conv.append({"w": normal(k, c_in, c, fan_in=k * c_in),
                     "ln_g": ones(c), "ln_b": zeros(c)})
        c_in = c

    def blk():
        return {"ln1_g": ones(h), "ln1_b": zeros(h),
                "q_w": normal(h, h, fan_in=h), "q_b": zeros(h),
                "k_w": normal(h, h, fan_in=h), "k_b": zeros(h),
                "v_w": normal(h, h, fan_in=h), "v_b": zeros(h),
                "o_w": normal(h, h, fan_in=h), "o_b": zeros(h),
                "ln2_g": ones(h), "ln2_b": zeros(h),
                "fc1_w": normal(h, f, fan_in=h), "fc1_b": zeros(f),
                "fc2_w": normal(f, h, fan_in=f), "fc2_b": zeros(h)}

    layers = [blk() for _ in range(cfg.n_layers)]
    blocks = {k: np.stack([layer[k] for layer in layers])
              for k in layers[0]}
    return {
        "conv": conv,
        "fp_ln_g": ones(c), "fp_ln_b": zeros(c),
        "fp_w": normal(c, h, fan_in=c), "fp_b": zeros(h),
        "pos_conv_w": normal(cfg.pos_conv_kernel, h // cfg.pos_conv_groups,
                             h, fan_in=cfg.pos_conv_kernel * h),
        "pos_conv_b": zeros(h),
        "blocks": blocks,
        "final_ln_g": ones(h), "final_ln_b": zeros(h),
        "lm_w": normal(h, cfg.vocab_size, fan_in=h),
        "lm_b": zeros(cfg.vocab_size),
    }
