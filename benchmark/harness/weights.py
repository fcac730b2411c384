"""Seeded Whisper weights, made on the device in the type they are served
in: one ``torch.Generator`` draw for the whole model, then each leaf a
view of it, scaled.  The program and the reference are each given the
weights of the same seed, made anew for each.

Layout (the benchmark's, which the port also reads): matmul weights
``[in, out]`` used as ``x @ w``, convolutions ``[out, in, 3]``, each stack
of blocks a list of dicts.  Scales: 1 / sqrt(fan_in) for matmuls and
convolutions, 0.02 for embeddings and biases, LayerNorm gains 1 + 0.1 n
and shifts 0.02 n, so that no bias or norm parameter is trivially 0 or 1.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

ALIGN = 64          # elements: every leaf starts 128-byte aligned


def whisper_dims(cfg: Dict) -> Dict:
    d = cfg["d_model"]
    if cfg["encoder_ffn_dim"] != 4 * d or cfg["decoder_ffn_dim"] != 4 * d:
        raise ValueError("the program's blocks have feed-forward width 4 d")
    return {"d": d, "mels": cfg["num_mel_bins"], "vocab": cfg["vocab_size"],
            "ta": cfg["max_source_positions"],
            "tt": cfg["max_target_positions"],
            "enc": cfg["encoder_layers"], "dec": cfg["decoder_layers"]}


def _leaves(cfg: Dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str]]:
    """(path, shape, kind) of every random leaf, in draw order."""
    z = whisper_dims(cfg)
    d = z["d"]
    out = []

    def ln(path):
        out.append((path + ("g",), (d,), "gain"))
        out.append((path + ("b",), (d,), "bias"))

    def attn(path):
        for name in ("q", "k", "v", "o"):
            out.append((path + (f"{name}_w",), (d, d), "dense"))
            if name != "k":
                out.append((path + (f"{name}_b",), (d,), "bias"))

    def block(path, cross):
        ln(path + ("ln1",))
        attn(path + ("attn",))
        if cross:
            ln(path + ("lnx",))
            attn(path + ("xattn",))
        ln(path + ("ln2",))
        out.append((path + ("mlp", "fc1_w"), (d, 4 * d), "dense"))
        out.append((path + ("mlp", "fc1_b"), (4 * d,), "bias"))
        out.append((path + ("mlp", "fc2_w"), (4 * d, d), "dense"))
        out.append((path + ("mlp", "fc2_b"), (d,), "bias"))

    out.append((("encoder", "conv1_w"), (d, z["mels"], 3), "conv"))
    out.append((("encoder", "conv1_b"), (d,), "bias"))
    out.append((("encoder", "conv2_w"), (d, d, 3), "conv"))
    out.append((("encoder", "conv2_b"), (d,), "bias"))
    for i in range(z["enc"]):
        block(("encoder", "blocks", i), False)
    ln(("encoder", "ln_post"))
    out.append((("decoder", "tok_emb"), (z["vocab"], d), "embedding"))
    out.append((("decoder", "pos_emb"), (z["tt"], d), "embedding"))
    for i in range(z["dec"]):
        block(("decoder", "blocks", i), True)
    ln(("decoder", "ln"))
    return out


def _put(tree: Dict, path: Tuple, value) -> None:
    node = tree
    for i, key in enumerate(path[:-1]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(
                key, [] if isinstance(path[i + 1], int) else {})
    node[path[-1]] = value


def sinusoids(length: int, channels: int) -> torch.Tensor:
    inc = math.log(10000) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64))
    t = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1).float()


def make_whisper(cfg: Dict, seed: int, device,
                 dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The weights of ``cfg`` from ``seed``: a dict in the layout above,
    every leaf of ``dtype`` on ``device``."""
    leaves = _leaves(cfg)
    offsets, total = [], 0
    for _, shape, _ in leaves:
        offsets.append(total)
        total += -(-math.prod(shape) // ALIGN) * ALIGN
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    tree: Dict = {}
    for (path, shape, kind), off in zip(leaves, offsets):
        t = flat[off:off + math.prod(shape)].view(shape)
        if kind == "dense":
            t.mul_(1.0 / math.sqrt(shape[0]))
        elif kind == "conv":
            t.mul_(1.0 / math.sqrt(shape[1] * shape[2]))
        elif kind == "gain":
            t.mul_(0.1).add_(1.0)
        else:                                   # bias, embedding
            t.mul_(0.02)
        _put(tree, path, t)
    z = whisper_dims(cfg)
    tree["encoder"]["pos"] = sinusoids(z["ta"], z["d"]).to(device, dtype)
    return tree


def n_params(cfg: Dict) -> int:
    return sum(math.prod(shape) for _, shape, _ in _leaves(cfg))
