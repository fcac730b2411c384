"""Weight bridge: the JAX package's param trees -> the port's weights.

Whisper (``from_jax_tree``):

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

PyanNet (``from_jax_pyannet``): the JAX ``models/vad.py`` tree (``[K, C_in,
C_out]`` convs, ``x @ w`` linears, a list of per-layer LSTM dicts in
torch's gate layout) becomes a ``models.vad.PyanNet`` on ``device``, in
float32.  ``convert_pyannote_segmentation`` maps a pyannote state dict to
that tree, and ``load_segmentation_params`` reads one from the registry.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from . import config
from .models.vad import PyanNet, PyanNetConfig, sinc_filters
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


# ---------------------------------------------------------------------------
# PyanNet
# ---------------------------------------------------------------------------

SEGMENTATION_NAME = "pyannote-segmentation-3.0"


def from_jax_pyannet(tree: Dict[str, Any], device: torch.device,
                     cfg: PyanNetConfig = PyanNetConfig()) -> PyanNet:
    """JAX PyanNet param tree (numpy leaves) -> ``PyanNet`` on ``device``
    with its sinc filters materialised."""
    def t(arr):
        return tensor_from_numpy(arr).to(torch.float32)

    sd = {"sinc_low_hz": t(tree["sinc_low_hz"]),
          "sinc_band_hz": t(tree["sinc_band_hz"]),
          "conv1.weight": t(tree["conv1_w"]).permute(2, 1, 0),
          "conv1.bias": t(tree["conv1_b"]),
          "conv2.weight": t(tree["conv2_w"]).permute(2, 1, 0),
          "conv2.bias": t(tree["conv2_b"])}
    for norm in ("in_norm", "norm0", "norm1", "norm2"):
        sd[f"{norm}_g"] = t(tree[norm]["g"])
        sd[f"{norm}_b"] = t(tree[norm]["b"])
    for i, layer in enumerate(tree["lstm"]):
        for rev in ("", "_rev"):
            suffix = f"l{i}" + ("_reverse" if rev else "")
            for w in ("ih", "hh"):
                sd[f"lstm.weight_{w}_{suffix}"] = t(layer[f"w_{w}{rev}"])
                sd[f"lstm.bias_{w}_{suffix}"] = t(layer[f"b_{w}{rev}"])
    for name in ("fc1", "fc2", "cls"):
        sd[f"{name}.weight"] = t(tree[f"{name}_w"]).T
        sd[f"{name}.bias"] = t(tree[f"{name}_b"])
    # materialised once, on the CPU in float32, so that every device
    # convolves with the same filters
    sd["sinc"] = sinc_filters(sd["sinc_low_hz"], sd["sinc_band_hz"],
                              cfg.sinc_kernel)
    model = PyanNet(cfg)
    model.load_state_dict(sd)
    return model.to(device)


def convert_pyannote_segmentation(state_dict: Mapping[str, Any]) -> Dict:
    """pyannote/segmentation-3.0 torch state dict -> the JAX package's
    PyanNet param tree (numpy leaves)."""
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
              else np.asarray(v)) for k, v in state_dict.items()}
    # pyannote versions differ: nn.LSTM at "lstm." or wrapped at "lstm.lstm."
    lstm_prefix = "lstm.lstm." if "lstm.lstm.weight_ih_l0" in sd else "lstm."
    lstm = []
    i = 0
    while f"{lstm_prefix}weight_ih_l{i}" in sd:
        lstm.append({
            "w_ih": sd[f"{lstm_prefix}weight_ih_l{i}"],
            "w_hh": sd[f"{lstm_prefix}weight_hh_l{i}"],
            "b_ih": sd[f"{lstm_prefix}bias_ih_l{i}"],
            "b_hh": sd[f"{lstm_prefix}bias_hh_l{i}"],
            "w_ih_rev": sd[f"{lstm_prefix}weight_ih_l{i}_reverse"],
            "w_hh_rev": sd[f"{lstm_prefix}weight_hh_l{i}_reverse"],
            "b_ih_rev": sd[f"{lstm_prefix}bias_ih_l{i}_reverse"],
            "b_hh_rev": sd[f"{lstm_prefix}bias_hh_l{i}_reverse"],
        })
        i += 1
    return {
        "sinc_low_hz": sd["sincnet.conv1d.0.low_hz_"],
        "sinc_band_hz": sd["sincnet.conv1d.0.band_hz_"],
        "in_norm": {"g": sd["sincnet.wav_norm1d.weight"],
                    "b": sd["sincnet.wav_norm1d.bias"]},
        "norm0": {"g": sd["sincnet.norm1d.0.weight"],
                  "b": sd["sincnet.norm1d.0.bias"]},
        "conv1_w": sd["sincnet.conv1d.1.weight"].transpose(2, 1, 0),
        "conv1_b": sd["sincnet.conv1d.1.bias"],
        "norm1": {"g": sd["sincnet.norm1d.1.weight"],
                  "b": sd["sincnet.norm1d.1.bias"]},
        "conv2_w": sd["sincnet.conv1d.2.weight"].transpose(2, 1, 0),
        "conv2_b": sd["sincnet.conv1d.2.bias"],
        "norm2": {"g": sd["sincnet.norm1d.2.weight"],
                  "b": sd["sincnet.norm1d.2.bias"]},
        "lstm": lstm,
        "fc1_w": sd["linear.0.weight"].T, "fc1_b": sd["linear.0.bias"],
        "fc2_w": sd["linear.1.weight"].T, "fc2_b": sd["linear.1.bias"],
        "cls_w": sd["classifier.weight"].T, "cls_b": sd["classifier.bias"],
    }


def load_segmentation_params(name: str = SEGMENTATION_NAME
                             ) -> Optional[Dict]:
    """Segmentation weights from ``$MWX_WEIGHTS_DIR/<name>/pytorch_model.bin``
    (a pyannote state dict) as the JAX package's tree, or None when the
    registry has no such file.  The JAX package prefers an orbax ``jax/``
    tree there; the port cannot read orbax, so that form is not looked at.
    """
    root = config.weights_dir()
    if not root:
        return None
    path = Path(root) / name / "pytorch_model.bin"
    if not path.exists():
        return None
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    config.warn_if_synth_checkpoint(path.parent, "segmentation VAD")
    return convert_pyannote_segmentation(sd)
