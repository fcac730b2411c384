"""HF Whisper checkpoints -> the port's weights (port of the JAX
``convert/from_hf.py``).

A checkpoint directory holds ``config.json`` and its weights as
``model.safetensors``, as shards listed in ``model.safetensors.index.json``,
or as ``pytorch_model.bin``.  The HF tensor names are mapped to the JAX
package's param tree (numpy leaves, stacked ``[L, ...]`` blocks, ``[K, N]``
matmul weights, ``[K, C_in, C_out]`` convs), which then crosses into the
port through ``convert.from_jax_tree``, the one bridge for both.

Safetensors files are read here, without the ``safetensors`` package: an
8-byte little-endian header length, a JSON header naming each tensor's
dtype, shape and byte range, then the raw buffers.  F32, F16 and BF16 are
read; bf16 goes through ``torch.frombuffer`` (no ``ml_dtypes``).

``load_params`` reads the param trees the JAX package saves with orbax
(``ocdbt.py``), the counterpart of the JAX ``load_params``.
"""

from __future__ import annotations

import json
import math
import struct
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .convert import from_jax_tree
from .models.whisper import Params, WhisperConfig
from .ocdbt import read_checkpoint

_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16}


def load_safetensors(path) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, as CPU tensors of the
    file's dtypes (F32, F16, BF16); raises ValueError on a malformed file
    or another dtype."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: no safetensors header")
        (n_header,) = struct.unpack("<Q", raw)
        header = json.loads(f.read(n_header).decode("utf-8"))
        data = bytearray(f.read())
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}; "
                             f"read: {sorted(_SAFETENSORS_DTYPES)}")
        shape = [int(d) for d in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        count = math.prod(shape)
        if not 0 <= begin <= end <= len(data) \
                or end - begin != count * dtype.itemsize:
            raise ValueError(f"{path}: {name}: byte range {begin}..{end} "
                             f"does not hold {shape} {info['dtype']}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(data, dtype=dtype, count=count,
                                         offset=begin).reshape(shape)
    return out


def hf_config_to_whisper_config(hf_cfg: Mapping[str, Any],
                                name: str = "converted") -> WhisperConfig:
    """Map a transformers WhisperConfig dict to the port's WhisperConfig."""
    vocab = int(hf_cfg["vocab_size"])
    # 51865 => 99 languages (v1/v2 layout); 51866 => 100 (large-v3 adds yue)
    num_languages = 100 if vocab >= 51866 else 99
    return WhisperConfig(
        name=name,
        n_mels=int(hf_cfg["num_mel_bins"]),
        n_vocab=vocab,
        n_audio_ctx=int(hf_cfg.get("max_source_positions", 1500)),
        n_audio_state=int(hf_cfg["d_model"]),
        n_audio_head=int(hf_cfg["encoder_attention_heads"]),
        n_audio_layer=int(hf_cfg["encoder_layers"]),
        n_text_ctx=int(hf_cfg.get("max_target_positions", 448)),
        n_text_state=int(hf_cfg["d_model"]),
        n_text_head=int(hf_cfg["decoder_attention_heads"]),
        n_text_layer=int(hf_cfg["decoder_layers"]),
        num_languages=num_languages,
    )


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    if t.dtype == torch.bfloat16:       # exact in float32; numpy has no bf16
        t = t.float()
    return t.detach().cpu().numpy()


def _ln(sd, prefix):
    return {"g": _to_numpy(sd[f"{prefix}.weight"]),
            "b": _to_numpy(sd[f"{prefix}.bias"])}


def _attn(sd, prefix):
    return {
        "q_w": _to_numpy(sd[f"{prefix}.q_proj.weight"]).T,
        "q_b": _to_numpy(sd[f"{prefix}.q_proj.bias"]),
        "k_w": _to_numpy(sd[f"{prefix}.k_proj.weight"]).T,
        "v_w": _to_numpy(sd[f"{prefix}.v_proj.weight"]).T,
        "v_b": _to_numpy(sd[f"{prefix}.v_proj.bias"]),
        "o_w": _to_numpy(sd[f"{prefix}.out_proj.weight"]).T,
        "o_b": _to_numpy(sd[f"{prefix}.out_proj.bias"]),
    }


def _block(sd, prefix, cross: bool):
    blk = {
        "ln1": _ln(sd, f"{prefix}.self_attn_layer_norm"),
        "attn": _attn(sd, f"{prefix}.self_attn"),
        "ln2": _ln(sd, f"{prefix}.final_layer_norm"),
        "mlp": {
            "fc1_w": _to_numpy(sd[f"{prefix}.fc1.weight"]).T,
            "fc1_b": _to_numpy(sd[f"{prefix}.fc1.bias"]),
            "fc2_w": _to_numpy(sd[f"{prefix}.fc2.weight"]).T,
            "fc2_b": _to_numpy(sd[f"{prefix}.fc2.bias"]),
        },
    }
    if cross:
        blk["lnx"] = _ln(sd, f"{prefix}.encoder_attn_layer_norm")
        blk["xattn"] = _attn(sd, f"{prefix}.encoder_attn")
    return blk


def _stack(blocks):
    """Per-layer dicts -> one dict of ``[L, ...]`` leaves."""
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return np.stack(blocks)


def convert_whisper_state_dict(state_dict: Mapping[str, Any],
                               cfg: WhisperConfig) -> Params:
    """HF WhisperModel/WhisperForConditionalGeneration weights -> the JAX
    package's param tree (numpy leaves, the checkpoint's dtypes; bf16 as
    float32).  Accepts torch tensors or numpy arrays; handles the optional
    ``model.`` prefix of the ForConditionalGeneration wrapper."""
    sd = {}
    for k, v in state_dict.items():
        if k.startswith("model."):
            k = k[len("model."):]
        sd[k] = v

    enc_blocks = [_block(sd, f"encoder.layers.{i}", cross=False)
                  for i in range(cfg.n_audio_layer)]
    dec_blocks = [_block(sd, f"decoder.layers.{i}", cross=True)
                  for i in range(cfg.n_text_layer)]
    return {
        "encoder": {
            # sinusoidal in real checkpoints; carried verbatim regardless
            "pos": _to_numpy(sd["encoder.embed_positions.weight"]),
            # torch conv weight [out, in, k] -> the JAX tree's [k, in, out]
            "conv1_w": _to_numpy(sd["encoder.conv1.weight"]).transpose(
                2, 1, 0),
            "conv1_b": _to_numpy(sd["encoder.conv1.bias"]),
            "conv2_w": _to_numpy(sd["encoder.conv2.weight"]).transpose(
                2, 1, 0),
            "conv2_b": _to_numpy(sd["encoder.conv2.bias"]),
            "blocks": _stack(enc_blocks),
            "ln_post": _ln(sd, "encoder.layer_norm"),
        },
        "decoder": {
            "tok_emb": _to_numpy(sd["decoder.embed_tokens.weight"]),
            "pos_emb": _to_numpy(sd["decoder.embed_positions.weight"]),
            "blocks": _stack(dec_blocks),
            "ln": _ln(sd, "decoder.layer_norm"),
        },
    }


def read_state_dict(path) -> Dict[str, Any]:
    """The weights of an HF checkpoint directory: ``model.safetensors``,
    the shards of ``model.safetensors.index.json``, or
    ``pytorch_model.bin``, in that order of preference."""
    path = Path(path)
    st = path / "model.safetensors"
    index = path / "model.safetensors.index.json"
    if st.exists():
        return load_safetensors(st)
    if index.exists():
        shards = sorted(set(json.loads(index.read_text())
                            ["weight_map"].values()))
        sd: Dict[str, Any] = {}
        for shard in shards:
            sd.update(load_safetensors(path / shard))
        return sd
    if (path / "pytorch_model.bin").exists():
        return torch.load(str(path / "pytorch_model.bin"),
                          map_location="cpu", weights_only=True)
    raise FileNotFoundError(
        f"no weights under {path}: expected model.safetensors, "
        "model.safetensors.index.json (+ shards), or pytorch_model.bin")


def load_whisper_checkpoint(path, device: torch.device,
                            dtype: torch.dtype = torch.bfloat16
                            ) -> Tuple[Params, WhisperConfig]:
    """An HF Whisper checkpoint directory (config.json + weights) -> the
    port's weights on ``device`` in ``dtype``, and its config."""
    path = Path(path)
    hf_cfg = json.loads((path / "config.json").read_text())
    cfg = hf_config_to_whisper_config(hf_cfg, name=path.name) \
        .with_dtype(dtype)
    tree = convert_whisper_state_dict(read_state_dict(path), cfg)
    return from_jax_tree(tree, cfg, device), cfg


def load_params(path) -> Optional[Dict[str, Any]]:
    """A param tree the JAX package saved with orbax (``save_params``: the
    registry's ``jax/`` trees, ``.synth_ckpt``), as orbax's ``restore``
    gives it: nested dicts and lists of numpy arrays; None when ``path``
    does not exist, as in the JAX ``load_params``.  Read by ``ocdbt.py``,
    without orbax; an unreadable tree raises."""
    path = Path(path).resolve()
    if not path.exists():
        return None
    return read_checkpoint(path)
