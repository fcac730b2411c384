"""Plain float32 Whisper with int8 weights and int8 cross K/V: the int8
model that ``compute_type="int8"`` with ``int8_cross_kv`` serves, written
from its description alone, beside the published model of
``whisper_ref``.

The int8 model is the published one with two roundings, its departures
from the paper:

- every block matmul weight (the q, k, v and o projections of each
  attention, both MLP weights, encoder and decoder) rounded to int8,
  symmetric per output channel: scale = max(absmax over the input axis /
  127, 1e-10), codes rounded half to even and clipped to +-127, the weight
  used as codes x scale (``quantize_weight``, ``dequantize_params``);
  embeddings, convolutions, norms, biases and positions stay as given;
- each decoder layer's cross K and V rounded to int8 per (row, head,
  position) over the head's dims: scale = max(absmax / 127, 1e-8) in
  float32, codes rounded half to even and clipped, attended as codes x
  scale (``quantize_rows``).

Everything else is ``whisper_ref``'s, reused and not changed: log-mel,
the 16-bit PCM crossing, the convolutions and the encoder, LayerNorm,
attention and the MLP, every product in float32 with TF32 off.  Imports
neither the program under test nor JAX.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from reference import whisper_ref

# the weights rounded to int8 inside each block (biases and norms excluded)
BLOCK_WEIGHTS = ("q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w")


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 of a weight [K, N] used as x @ w:
    {"q": int8 codes [K, N], "s": float32 scales [N]}."""
    w32 = w.float()
    scale = torch.clamp_min(w32.abs().amax(dim=0) / 127.0, 1e-10)
    codes = torch.clamp(torch.round(w32 / scale), -127, 127)
    return {"q": codes.to(torch.int8), "s": scale}


def dequantize(qw: Dict[str, torch.Tensor]) -> torch.Tensor:
    return qw["q"].float() * qw["s"]


def dequantize_params(w: Dict) -> Dict:
    """``w`` (``harness.weights`` layout) with every block weight replaced
    by its int8 rounding, dequantized to float32; every other leaf is
    shared with ``w``."""
    def block(blk):
        return {name: ({k: (dequantize(quantize_weight(v))
                            if k in BLOCK_WEIGHTS else v)
                        for k, v in sub.items()}
                       if isinstance(sub, dict) else sub)
                for name, sub in blk.items()}

    return {part: {**w[part], "blocks": [block(b) for b in w[part]["blocks"]]}
            for part in ("encoder", "decoder")}


def quantize_rows(x: torch.Tensor) -> torch.Tensor:
    """x [..., dh] (one head's K or V at each position) rounded to int8
    over its last axis with a float32 scale, and dequantized."""
    scale = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-8)
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


def _cross_attn_int8(x, xa, a, n_head):
    """``whisper_ref``'s cross-attention with K and V rounded per (row,
    head, position) before they are attended."""
    f = whisper_ref._f
    q = whisper_ref._mm(x, a["q_w"]) + f(a["q_b"])
    k = whisper_ref._mm(xa, a["k_w"])
    v = whisper_ref._mm(xa, a["v_w"]) + f(a["v_b"])
    k, v = (quantize_rows(whisper_ref._heads(z, n_head)).transpose(1, 2)
            .reshape(z.shape) for z in (k, v))
    return (whisper_ref._mm(whisper_ref._attention(q, k, v, n_head),
                            a["o_w"]) + f(a["o_b"]))


def decoder_logits(w: Dict, tokens: torch.Tensor, xa: torch.Tensor,
                   n_head: int, first: int) -> torch.Tensor:
    """``whisper_ref.decoder_logits`` with int8 cross K/V: teacher-forced
    over ``tokens`` [B, L]; logits [B, L - first, vocab]."""
    f = whisper_ref._f
    dec = w["decoder"]
    emb = f(dec["tok_emb"])
    x = emb[tokens] + f(dec["pos_emb"])[: tokens.shape[1]]
    for blk in dec["blocks"]:
        x = x + whisper_ref._self_attn(whisper_ref._ln(x, blk["ln1"]),
                                       blk["attn"], n_head, causal=True)
        x = x + _cross_attn_int8(whisper_ref._ln(x, blk["lnx"]), xa,
                                 blk["xattn"], n_head)
        x = x + whisper_ref._mlp(whisper_ref._ln(x, blk["ln2"]), blk["mlp"])
    x = whisper_ref._ln(x[:, first:], dec["ln"])
    return whisper_ref._mm(x, emb.t())


def window_logits(wq: Dict, cfg: Dict, windows: torch.Tensor,
                  sequences: Sequence[List[int]], first: int
                  ) -> List[torch.Tensor]:
    """``whisper_ref.window_logits`` of the int8 model: ``wq`` is
    ``dequantize_params`` of the weights."""
    with whisper_ref.no_tf32():
        mel = whisper_ref.log_mel(whisper_ref.pcm16(windows.float()),
                                  cfg["num_mel_bins"])
        xa = whisper_ref.encoder(wq, mel, cfg["encoder_attention_heads"])
        out = []
        for i, seq in enumerate(sequences):
            toks = torch.tensor([seq[:-1]], dtype=torch.long,
                                device=windows.device)
            out.append(decoder_logits(wq, toks, xa[i:i + 1],
                                      cfg["decoder_attention_heads"],
                                      first)[0])
        return out
