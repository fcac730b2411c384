"""Weight bridge: the JAX package's Whisper param tree -> the port's weights.

Input is the nested dict of numpy arrays that ``init_params_host``,
``init_params`` (after ``np.asarray``), ``convert/from_hf.py``
``load_params`` or ``ops/quant.py`` ``quantize_params`` return.  Output is
the port's layout (``models/whisper.py``):

- stacked ``[L, ...]`` block leaves are split into a list of per-layer dicts;
- ``[K, N]`` matmul weights stay ``[K, N]`` (used as ``x @ w``, as JAX's
  ``ops/quant.py`` ``mm`` does);
- int8 ``{q, s}`` weights (stacked ``[L, K, N]`` int8 and ``[L, N]``
  float32) become per-layer ``{"q": int8 [K, N], "s": float32 [N]}``, kept
  in those dtypes;
- conv weights ``[K, C_in, C_out]`` become torch's ``[C_out, C_in, K]``;
- bf16 leaves (``arr.dtype.name == "bfloat16"``) cross through a 16-bit
  integer view, so ``ml_dtypes`` is never imported.

Every other leaf is cast to the config's dtype; all move to ``device``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .models.whisper import Params, WhisperConfig
from .ops.quant import is_quantized

_CONV_KEYS = ("conv1_w", "conv2_w")


def tensor_from_numpy(arr: Any) -> torch.Tensor:
    """numpy array (f32/f16/bf16/int...) -> CPU tensor of the same dtype."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _quantized(node: Dict[str, Any], name: str,
               device: torch.device) -> Dict[str, torch.Tensor]:
    q, s = np.asarray(node["q"]), np.asarray(node["s"])
    if q.dtype != np.int8 or s.dtype != np.float32 or q.ndim != 2 \
            or s.shape != q.shape[1:]:
        raise ValueError(f"{name}: an int8 weight needs q int8 [K, N] and s "
                         f"float32 [N], got q {q.dtype} {q.shape}, s "
                         f"{s.dtype} {s.shape}")
    return {"q": tensor_from_numpy(q).to(device),
            "s": tensor_from_numpy(s).to(device)}


def _leaf(arr: Any, name: str, cfg: WhisperConfig,
          device: torch.device) -> torch.Tensor:
    t = tensor_from_numpy(arr)
    if name.split("/")[-1] in _CONV_KEYS:
        t = t.permute(2, 1, 0).contiguous()
    return t.to(device=device, dtype=cfg.dtype)


def _tree(node: Dict[str, Any], prefix: str, cfg, device) -> Dict[str, Any]:
    out = {}
    for key, val in node.items():
        name = f"{prefix}/{key}"
        if isinstance(val, dict):
            out[key] = _tree(val, name, cfg, device)
        else:
            out[key] = _leaf(val, name, cfg, device)
    return out


def _unstack(blocks: Dict[str, Any], n_layers: int, prefix: str, cfg,
             device) -> list:
    def layer_of(arr, layer, name):
        arr = np.asarray(arr)
        if arr.shape[0] != n_layers:
            raise ValueError(f"{name}: leading axis {arr.shape[0]} != "
                             f"{n_layers} layers")
        return arr[layer]

    def take(node, layer, name):
        if is_quantized(node):
            return _quantized({k: layer_of(v, layer, f"{name}/{k}")
                               for k, v in node.items()}, name, device)
        if isinstance(node, dict):
            return {k: take(v, layer, f"{name}/{k}") for k, v in node.items()}
        return _leaf(layer_of(node, layer, name), name, cfg, device)
    return [take(blocks, layer, f"{prefix}/blocks")
            for layer in range(n_layers)]


def from_jax_tree(tree: Dict[str, Any], cfg: WhisperConfig,
                  device: torch.device) -> Params:
    """JAX param tree (numpy leaves) -> the port's weights on ``device``."""
    out: Params = {}
    for part, n_layers in (("encoder", cfg.n_audio_layer),
                           ("decoder", cfg.n_text_layer)):
        section = dict(tree[part])
        blocks = section.pop("blocks")
        out[part] = _tree(section, part, cfg, device)
        out[part]["blocks"] = _unstack(blocks, n_layers, part, cfg, device)
    return out
