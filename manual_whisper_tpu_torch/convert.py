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
``to_jax_tree`` is the inverse: the port's weights, or a tree shaped like
them (gradients, AdamW moments), back in the JAX layout as numpy.

PyanNet (``from_jax_pyannet``): the JAX ``models/vad.py`` tree (``[K, C_in,
C_out]`` convs, ``x @ w`` linears, a list of per-layer LSTM dicts in
torch's gate layout) becomes a ``models.vad.PyanNet`` on ``device``, in
float32.  ``convert_pyannote_segmentation`` maps a pyannote state dict to
that tree, and ``load_segmentation_params`` reads one from the registry
(its orbax ``jax/`` tree, else ``pytorch_model.bin``).

wav2vec2 (``from_jax_wav2vec2``): the JAX ``models/wav2vec2.py`` tree
becomes a ``models.wav2vec2.Wav2Vec2`` on ``device``, in float32;
``convert_wav2vec2_state_dict`` maps an HF ``Wav2Vec2ForCTC`` state dict to
that tree and ``wav2vec2_hf_state_dict`` writes the tree back in HF keys.

ResNet34 (``from_jax_resnet``): the JAX ``models/diarize.py`` embedding
tree becomes a ``models.diarize.ResNet34`` on ``device``, in float32;
``wespeaker_state_dict`` writes the tree in wespeaker keys, which
``models.diarize.convert_wespeaker_resnet`` reads back.
"""

from __future__ import annotations

from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from . import config
from .models.diarize import EmbeddingConfig, ResNet34
from .models.vad import PyanNet, PyanNetConfig, sinc_filters
from .models.wav2vec2 import CONV_LAYERS as W2V_CONV_LAYERS
from .models.wav2vec2 import Wav2Vec2, Wav2Vec2Config
from .models.whisper import Params, WhisperConfig
from .ops.quant import is_quantized

_CONV_KEYS = ("conv1_w", "conv2_w")


def tensor_from_numpy(arr: Any) -> torch.Tensor:
    """numpy array (f32/f16/bf16/int...) -> CPU tensor of the same dtype.
    A tensor is copied as it is: ``ocdbt`` gives a bf16 leaf as one where
    numpy has no ``bfloat16``."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().clone()
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
        if not isinstance(arr, torch.Tensor):
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


def _numpy_leaf(t: torch.Tensor) -> np.ndarray:
    """CPU copy of ``t`` as numpy in its own dtype; bf16 crosses through a
    16-bit integer view as numpy's ``bfloat16``, the dtype ``ml_dtypes``
    registers (JAX imports it; the port does not)."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy().copy()
    try:
        bf16 = np.dtype("bfloat16")
    except TypeError as exc:
        raise TypeError("a bf16 leaf needs numpy's bfloat16 dtype, which "
                        "ml_dtypes registers on import") from exc
    return t.view(torch.int16).numpy().copy().view(bf16)


def to_jax_tree(params: Params) -> Dict[str, Any]:
    """The port's weights, or any tree shaped like them (gradients, AdamW
    moments) -> the JAX package's param tree of numpy arrays: per-layer
    blocks stacked on a leading axis (int8 ``{q, s}`` too), conv weights
    ``[K, C_in, C_out]``, every leaf in its tensor's dtype.  The inverse
    of ``from_jax_tree``."""
    def tree(node, name=""):
        if isinstance(node, dict):
            return {k: tree(v, k) for k, v in node.items()}
        arr = _numpy_leaf(node)
        return arr.transpose(2, 1, 0).copy() if name in _CONV_KEYS else arr

    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([layer[k] for layer in layers])
                    for k in layers[0]}
        return np.stack(layers)

    out = {}
    for part in ("encoder", "decoder"):
        out[part] = tree({k: v for k, v in params[part].items()
                          if k != "blocks"})
        out[part]["blocks"] = stack([tree(b) for b in params[part]["blocks"]])
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
    """Segmentation weights from the registry as the JAX package's tree, or
    None when it has neither form.  The two forms under
    ``$MWX_WEIGHTS_DIR/<name>/``, in the JAX package's order: ``jax/``, an
    orbax tree in this layout (``from_hf.load_params``; an unreadable one
    raises, as in JAX), then ``pytorch_model.bin``, a pyannote state dict,
    converted."""
    from .from_hf import load_params
    root = config.weights_dir()
    if not root:
        return None
    params = load_params(Path(root) / name / "jax")
    if params is not None:
        config.warn_if_synth_checkpoint(Path(root) / name, "segmentation VAD")
        return params
    path = Path(root) / name / "pytorch_model.bin"
    if not path.exists():
        return None
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    config.warn_if_synth_checkpoint(path.parent, "segmentation VAD")
    return convert_pyannote_segmentation(sd)


# ---------------------------------------------------------------------------
# wav2vec2 (alignment)
# ---------------------------------------------------------------------------

def _f32(arr: Any) -> torch.Tensor:
    return tensor_from_numpy(arr).to(torch.float32)


def from_jax_wav2vec2(tree: Dict[str, Any], cfg: Wav2Vec2Config,
                      device: torch.device) -> Wav2Vec2:
    """JAX wav2vec2 param tree (numpy leaves, blocks stacked ``[L, ...]``)
    -> ``Wav2Vec2`` on ``device`` in float32.  ``[K, C_in, C_out]`` convs
    become torch's ``[C_out, C_in, K]``, ``x @ w`` weights ``nn.Linear``'s
    ``[out, in]``; the extractor's conv biases are kept when the tree has
    them."""
    conv_bias = "b" in tree["conv"][0]
    sd = {}
    for i, conv in enumerate(tree["conv"]):
        sd[f"conv.{i}.weight"] = _f32(conv["w"]).permute(2, 1, 0)
        if conv_bias:
            sd[f"conv.{i}.bias"] = _f32(conv["b"])
        sd[f"conv_ln.{i}.weight"] = _f32(conv["ln_g"])
        sd[f"conv_ln.{i}.bias"] = _f32(conv["ln_b"])
    for name, key in (("fp_ln", "fp_ln"), ("final_ln", "final_ln")):
        sd[f"{name}.weight"] = _f32(tree[f"{key}_g"])
        sd[f"{name}.bias"] = _f32(tree[f"{key}_b"])
    sd["fp.weight"] = _f32(tree["fp_w"]).T
    sd["fp.bias"] = _f32(tree["fp_b"])
    sd["pos_conv.weight"] = _f32(tree["pos_conv_w"]).permute(2, 1, 0)
    sd["pos_conv.bias"] = _f32(tree["pos_conv_b"])
    sd["lm_head.weight"] = _f32(tree["lm_w"]).T
    sd["lm_head.bias"] = _f32(tree["lm_b"])
    blocks = tree["blocks"]
    for i in range(cfg.n_layers):
        p = f"blocks.{i}"
        for ln in ("ln1", "ln2"):
            sd[f"{p}.{ln}.weight"] = _f32(np.asarray(blocks[f"{ln}_g"])[i])
            sd[f"{p}.{ln}.bias"] = _f32(np.asarray(blocks[f"{ln}_b"])[i])
        for lin in ("q", "k", "v", "o", "fc1", "fc2"):
            sd[f"{p}.{lin}.weight"] = _f32(
                np.asarray(blocks[f"{lin}_w"])[i]).T
            sd[f"{p}.{lin}.bias"] = _f32(np.asarray(blocks[f"{lin}_b"])[i])
    model = Wav2Vec2(cfg, conv_bias=conv_bias)
    model.load_state_dict({k: v.contiguous() for k, v in sd.items()})
    return model.to(device)


def _numpy(t: Any) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.detach().cpu().numpy()
    return np.asarray(t)


_W2V_ATTN = (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
             ("o", "out_proj"))
_W2V_FFN = (("fc1", "intermediate_dense"), ("fc2", "output_dense"))


def convert_wav2vec2_state_dict(state_dict: Mapping[str, Any],
                                cfg: Wav2Vec2Config) -> Dict[str, Any]:
    """HF ``Wav2Vec2ForCTC`` weights (stable-LN variant) -> the JAX
    package's wav2vec2 tree (numpy leaves), as its
    ``convert_wav2vec2_state_dict`` makes it.  The positional conv's
    weight norm comes as ``weight_g``/``weight_v`` or, from torch 2.1 on,
    ``parametrizations.weight.original0``/``original1``."""
    sd = {k[len("wav2vec2."):] if k.startswith("wav2vec2.") else k: v
          for k, v in state_dict.items()}

    conv = []
    for i in range(len(W2V_CONV_LAYERS)):
        p = f"feature_extractor.conv_layers.{i}"
        layer = {"w": _numpy(sd[f"{p}.conv.weight"]).transpose(2, 1, 0),
                 "ln_g": _numpy(sd[f"{p}.layer_norm.weight"]),
                 "ln_b": _numpy(sd[f"{p}.layer_norm.bias"])}
        # conv_bias=true checkpoints (every XLSR-53 fine-tune) carry a
        # per-channel conv bias that LN does not absorb
        if f"{p}.conv.bias" in sd:
            layer["b"] = _numpy(sd[f"{p}.conv.bias"])
        conv.append(layer)

    blocks = []
    i = 0
    while f"encoder.layers.{i}.attention.q_proj.weight" in sd:
        p = f"encoder.layers.{i}"
        blk = {"ln1_g": _numpy(sd[f"{p}.layer_norm.weight"]),
               "ln1_b": _numpy(sd[f"{p}.layer_norm.bias"])}
        for ours, theirs in _W2V_ATTN:
            blk[f"{ours}_w"] = _numpy(
                sd[f"{p}.attention.{theirs}.weight"]).T
            blk[f"{ours}_b"] = _numpy(sd[f"{p}.attention.{theirs}.bias"])
        blk["ln2_g"] = _numpy(sd[f"{p}.final_layer_norm.weight"])
        blk["ln2_b"] = _numpy(sd[f"{p}.final_layer_norm.bias"])
        for ours, theirs in _W2V_FFN:
            blk[f"{ours}_w"] = _numpy(
                sd[f"{p}.feed_forward.{theirs}.weight"]).T
            blk[f"{ours}_b"] = _numpy(sd[f"{p}.feed_forward.{theirs}.bias"])
        blocks.append(blk)
        i += 1
    stacked = {k: np.stack([b[k] for b in blocks]) for k in blocks[0]}

    if "encoder.pos_conv_embed.conv.weight_g" in sd:
        g = _numpy(sd["encoder.pos_conv_embed.conv.weight_g"])
        v = _numpy(sd["encoder.pos_conv_embed.conv.weight_v"])
    else:
        g = _numpy(sd["encoder.pos_conv_embed.conv.parametrizations"
                      ".weight.original0"])
        v = _numpy(sd["encoder.pos_conv_embed.conv.parametrizations"
                      ".weight.original1"])
    norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True) + 1e-12)
    pos_w = (g / norm * v).transpose(2, 1, 0)   # [out, in/g, k] -> [k, ..]

    return {
        "conv": conv,
        "fp_ln_g": _numpy(sd["feature_projection.layer_norm.weight"]),
        "fp_ln_b": _numpy(sd["feature_projection.layer_norm.bias"]),
        "fp_w": _numpy(sd["feature_projection.projection.weight"]).T,
        "fp_b": _numpy(sd["feature_projection.projection.bias"]),
        "pos_conv_w": pos_w,
        "pos_conv_b": _numpy(sd["encoder.pos_conv_embed.conv.bias"]),
        "blocks": stacked,
        "final_ln_g": _numpy(sd["encoder.layer_norm.weight"]),
        "final_ln_b": _numpy(sd["encoder.layer_norm.bias"]),
        "lm_w": _numpy(sd["lm_head.weight"]).T,
        "lm_b": _numpy(sd["lm_head.bias"]),
    }


def wav2vec2_hf_state_dict(tree: Dict[str, Any]
                           ) -> "OrderedDict[str, torch.Tensor]":
    """The JAX package's wav2vec2 tree as an HF ``Wav2Vec2ForCTC`` state
    dict (float32 CPU tensors), the inverse of
    ``convert_wav2vec2_state_dict``: the positional conv is written in
    weight-norm form with ``weight_v`` the conv weight and ``weight_g`` its
    norm computed as the converter computes it, so that g / norm is 1 and
    the converter gives back the tree's array bit for bit."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a,
                                                                np.float32)))

    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    w = "wav2vec2."
    for i, conv in enumerate(tree["conv"]):
        p = f"{w}feature_extractor.conv_layers.{i}"
        sd[f"{p}.conv.weight"] = t(np.asarray(conv["w"]).transpose(2, 1, 0))
        if "b" in conv:
            sd[f"{p}.conv.bias"] = t(conv["b"])
        sd[f"{p}.layer_norm.weight"] = t(conv["ln_g"])
        sd[f"{p}.layer_norm.bias"] = t(conv["ln_b"])
    sd[f"{w}feature_projection.layer_norm.weight"] = t(tree["fp_ln_g"])
    sd[f"{w}feature_projection.layer_norm.bias"] = t(tree["fp_ln_b"])
    sd[f"{w}feature_projection.projection.weight"] = t(
        np.asarray(tree["fp_w"]).T)
    sd[f"{w}feature_projection.projection.bias"] = t(tree["fp_b"])
    v = np.ascontiguousarray(
        np.asarray(tree["pos_conv_w"], np.float32).transpose(2, 1, 0))
    g = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True) + 1e-12)
    sd[f"{w}encoder.pos_conv_embed.conv.bias"] = t(tree["pos_conv_b"])
    sd[f"{w}encoder.pos_conv_embed.conv.weight_g"] = t(g)
    sd[f"{w}encoder.pos_conv_embed.conv.weight_v"] = t(v)
    blocks = tree["blocks"]
    for i in range(len(np.asarray(blocks["q_w"]))):
        p = f"{w}encoder.layers.{i}"

        def leaf(k):
            return np.asarray(blocks[k])[i]
        sd[f"{p}.layer_norm.weight"] = t(leaf("ln1_g"))
        sd[f"{p}.layer_norm.bias"] = t(leaf("ln1_b"))
        for ours, theirs in _W2V_ATTN:
            sd[f"{p}.attention.{theirs}.weight"] = t(leaf(f"{ours}_w").T)
            sd[f"{p}.attention.{theirs}.bias"] = t(leaf(f"{ours}_b"))
        sd[f"{p}.final_layer_norm.weight"] = t(leaf("ln2_g"))
        sd[f"{p}.final_layer_norm.bias"] = t(leaf("ln2_b"))
        for ours, theirs in _W2V_FFN:
            sd[f"{p}.feed_forward.{theirs}.weight"] = t(
                leaf(f"{ours}_w").T)
            sd[f"{p}.feed_forward.{theirs}.bias"] = t(leaf(f"{ours}_b"))
    sd[f"{w}encoder.layer_norm.weight"] = t(tree["final_ln_g"])
    sd[f"{w}encoder.layer_norm.bias"] = t(tree["final_ln_b"])
    sd["lm_head.weight"] = t(np.asarray(tree["lm_w"]).T)
    sd["lm_head.bias"] = t(tree["lm_b"])
    return sd


# ---------------------------------------------------------------------------
# ResNet34 speaker embedding (diarization)
# ---------------------------------------------------------------------------

def _resnet_items(tree: Dict[str, Any]):
    """(torch-style name, wespeaker name, leaf) for each conv, BatchNorm
    and the embedding linear of a JAX ResNet tree; convs in the tree's
    HWIO layout with time on H."""
    def bn(ours, theirs, node):
        for o, t, k in (("weight", "weight", "g"), ("bias", "bias", "b"),
                        ("running_mean", "running_mean", "mean"),
                        ("running_var", "running_var", "var")):
            yield f"{ours}.{o}", f"{theirs}.{t}", node[k]

    yield "stem.weight", "conv1.weight", tree["stem_w"]
    yield from bn("stem_bn", "bn1", tree["stem_bn"])
    for si, stage in enumerate(tree["stages"]):
        for bi, blk in enumerate(stage):
            ours, theirs = f"stages.{si}.{bi}", f"layer{si + 1}.{bi}"
            for k in ("1", "2"):
                yield (f"{ours}.conv{k}.weight", f"{theirs}.conv{k}.weight",
                       blk[f"conv{k}_w"])
                yield from bn(f"{ours}.bn{k}", f"{theirs}.bn{k}",
                              blk[f"bn{k}"])
            if "down_w" in blk:
                yield (f"{ours}.down.0.weight",
                       f"{theirs}.downsample.0.weight", blk["down_w"])
                yield from bn(f"{ours}.down.1", f"{theirs}.downsample.1",
                              blk["down_bn"])


def from_jax_resnet(tree: Dict[str, Any], cfg: EmbeddingConfig,
                    device: torch.device) -> ResNet34:
    """JAX ResNet34 embedding tree (numpy leaves, HWIO convs with time on
    H) -> ``models.diarize.ResNet34`` on ``device`` in float32: each conv
    becomes torch's ``[out, in, kh (freq), kw (time)]``, the embedding
    linear ``nn.Linear``'s ``[out, in]``."""
    model = ResNet34(cfg)
    sd = dict(model.state_dict())
    for ours, _, leaf in _resnet_items(tree):
        t = _f32(leaf)
        sd[ours] = t.permute(3, 2, 1, 0) if t.ndim == 4 else t
    sd["fc.weight"] = _f32(tree["fc_w"]).T
    sd["fc.bias"] = _f32(tree["fc_b"])
    model.load_state_dict({k: v.contiguous() for k, v in sd.items()})
    return model.to(device)


def wespeaker_state_dict(tree: Dict[str, Any]
                         ) -> "OrderedDict[str, torch.Tensor]":
    """The JAX package's ResNet34 tree as a wespeaker state dict (float32
    CPU tensors, the embedding linear at ``seg_1``), the inverse of
    ``convert_wespeaker_resnet``: every value keeps its bits."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for _, theirs, leaf in _resnet_items(tree):
        a = np.asarray(leaf, np.float32)
        sd[theirs] = torch.from_numpy(np.ascontiguousarray(
            a.transpose(3, 2, 1, 0) if a.ndim == 4 else a))
    sd["seg_1.weight"] = torch.from_numpy(np.ascontiguousarray(
        np.asarray(tree["fc_w"], np.float32).T))
    sd["seg_1.bias"] = torch.from_numpy(np.ascontiguousarray(
        np.asarray(tree["fc_b"], np.float32)))
    return sd
