"""Speaker diarization: embeddings + clustering + speaker assignment (port
of the JAX ``models/diarize.py``).

Replaces the pyannote.audio 3.1 pipeline the reference drives through
``whisperx.diarize.DiarizationPipeline`` and
``whisperx.assign_word_speakers`` (reference: transcribe.py:142-145).
Structure mirrors pyannote 3.1:

1. local speaker activities from the PyanNet segmentation model
   (``models/vad.py``) over sliding windows — or VAD regions when no
   segmentation weights are available;
2. a speaker embedding per active region: ResNet34 with temporal
   statistics pooling over 80-mel log-mel features (wespeaker-voxceleb
   layout) — or a spectral-statistics embedding over 40 mels for
   weightless environments;
3. agglomerative clustering (cosine, average linkage) on host numpy with
   threshold / num_speakers control;
4. interval-overlap voting to attach speakers to segments and words.

The segmentation network and the ResNet live on the pipeline's device
(CUDA unless the caller asks for the CPU).  Every log-mel goes through
``ops.mel.unnormalized_log_mel``: kernel K1 on the card, at 80 mels for
the ResNet and 40 for the statistics embedding, its plain version on the
CPU.  The ResNet's convolutions and BatchNorms are cuDNN calls with TF32
off (``device.resolve_device``); the JAX package computes them with XLA,
outside any Pallas kernel.  The JAX package's ``embed_compute_device``
(pinning the ResNet to the host CPU, a TPU workaround) has no counterpart.

The clustering (``agglomerative_cluster``,
``constrained_agglomerative_cluster``, ``_absorb_small_clusters``,
``_stable_labels``, ``_agglomerative_cluster_py``) and the speaker
assignment (``_overlap``, ``_best_speaker``, ``assign_word_speakers``) are
copies of the JAX package's (numpy and scipy).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.mel import unnormalized_log_mel
from .vad import (PyanNetConfig, VadOptions, VoiceActivityDetector, binarize,
                  powerset_to_speaker_activity, pyannet_forward_chunked)

SAMPLE_RATE = 16000
EMBEDDING_NAME = "wespeaker-voxceleb-resnet34-LM"

# DiarizationPipeline's settings: the JAX package's constructor defaults
WINDOW_SEC = 3.0        # windows flow (no segmentation weights): length
STEP_SEC = 1.5          # and stride; PyanNet's windows step by half a window
THRESHOLD = 0.8         # clustering cut, cosine distance
CL_TRUST_FLOOR = 0.3    # cannot-link pairs closer than this are one voice
MIN_CLUSTER_SIZE = 2    # smaller clusters join the nearest big one
ACTIVITY_ONSET = 0.5    # binarisation of the stitched per-speaker activity
ACTIVITY_OFFSET = 0.35


# ---------------------------------------------------------------------------
# Embedding model: ResNet34 + temporal stats pooling (wespeaker layout)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
    n_mels: int = 80
    channels: Tuple[int, ...] = (32, 64, 128, 256)
    blocks: Tuple[int, ...] = (3, 4, 6, 3)       # ResNet34
    embed_dim: int = 256

    @classmethod
    def tiny_test(cls) -> "EmbeddingConfig":
        return cls(n_mels=80, channels=(8, 16, 16, 32), blocks=(1, 1, 1, 1),
                   embed_dim=32)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5)


class _BasicBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int, down: bool):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(c_in, c_out, 3, stride, 1, bias=False)
        self.bn1 = _bn(c_out)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, 1, 1, bias=False)
        self.bn2 = _bn(c_out)
        self.down = (nn.Sequential(nn.Conv2d(c_in, c_out, 1, stride,
                                             bias=False), _bn(c_out))
                     if down else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.down is not None:
            x = self.down(x)
        return F.relu(x + y)


class ResNet34(nn.Module):
    """log-mel ``[B, T, n_mels]`` -> L2-normalised embeddings ``[B, D]``
    (the JAX ``embed_forward``), float32.

    wespeaker's layout: activations NCHW ``[B, C, F, T]`` with frequency on
    H and time on W, torch ``[out, in, kh (freq), kw (time)]`` conv weights,
    symmetric padding (``Conv2d(..., padding=1)``), stride 2 at the first
    block of stages 2-4, BatchNorm in inference form (eps 1e-5).  Temporal
    statistics pooling flattens ``[C, F]`` per frame in (C, F) order as the
    JAX function does, takes the mean and the unbiased standard deviation
    (1e-7 inside the sqrt) over time, then the embedding linear; the
    result is L2-normalised with the norm clipped at 1e-8.  Runs in the
    module's dtype (``.double()`` gives a float64 reference)."""

    def __init__(self, cfg: EmbeddingConfig = EmbeddingConfig()):
        super().__init__()
        self.cfg = cfg
        self.stem = nn.Conv2d(1, cfg.channels[0], 3, 1, 1, bias=False)
        self.stem_bn = _bn(cfg.channels[0])
        stages = []
        c_in = cfg.channels[0]
        for si, (c_out, n_blocks) in enumerate(zip(cfg.channels,
                                                   cfg.blocks)):
            blocks = []
            for bi in range(n_blocks):
                first = bi == 0
                blocks.append(_BasicBlock(
                    c_in if first else c_out, c_out,
                    2 if (si > 0 and first) else 1,
                    first and (c_in != c_out or si > 0)))
            stages.append(nn.Sequential(*blocks))
            c_in = c_out
        self.stages = nn.Sequential(*stages)
        feat = (cfg.n_mels // 8) * cfg.channels[-1]
        self.fc = nn.Linear(2 * feat, cfg.embed_dim)
        self.requires_grad_(False)
        self.eval()

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = feats.to(self.stem.weight.dtype).transpose(1, 2)[:, None]
        x = F.relu(self.stem_bn(self.stem(x)))
        x = self.stages(x)
        b, c, f, t = x.shape
        x = x.reshape(b, c * f, t)
        mean = x.mean(dim=-1)
        std = torch.sqrt(x.var(dim=-1, unbiased=True) + 1e-7)
        emb = self.fc(torch.cat([mean, std], dim=-1))
        return emb / torch.linalg.norm(emb, dim=-1,
                                       keepdim=True).clamp(min=1e-8)


def init_embedding_params(generator: torch.Generator,
                          cfg: EmbeddingConfig) -> Dict[str, Any]:
    """Random ResNet params in the JAX package's tree layout (numpy
    leaves; HWIO convs with H over time), drawn from ``generator`` with
    the JAX init's scales; ``convert.from_jax_resnet`` makes the
    module."""
    def conv(kh, kw, ci, co):
        w = torch.randn(kh, kw, ci, co, generator=generator)
        return (w / np.sqrt(kh * kw * ci)).numpy().astype(np.float32)

    def bn(c):
        return {"g": np.ones(c, np.float32), "b": np.zeros(c, np.float32),
                "mean": np.zeros(c, np.float32),
                "var": np.ones(c, np.float32)}

    stages = []
    c_in = cfg.channels[0]
    for si, (c_out, n_blocks) in enumerate(zip(cfg.channels, cfg.blocks)):
        stage = []
        for bi in range(n_blocks):
            blk = {"conv1_w": conv(3, 3, c_in if bi == 0 else c_out, c_out),
                   "bn1": bn(c_out),
                   "conv2_w": conv(3, 3, c_out, c_out),
                   "bn2": bn(c_out)}
            if bi == 0 and (c_in != c_out or si > 0):
                blk["down_w"] = conv(1, 1, c_in, c_out)
                blk["down_bn"] = bn(c_out)
            stage.append(blk)
            c_in = c_out
        stages.append(stage)
    feat = (cfg.n_mels // 8) * cfg.channels[-1]
    fc_w = torch.randn(2 * feat, cfg.embed_dim, generator=generator)
    return {"stem_w": conv(3, 3, 1, cfg.channels[0]),
            "stem_bn": bn(cfg.channels[0]),
            "stages": stages,
            "fc_w": (fc_w / np.sqrt(2 * feat)).numpy().astype(np.float32),
            "fc_b": np.zeros(cfg.embed_dim, np.float32)}


def convert_wespeaker_resnet(state_dict, cfg: EmbeddingConfig
                             ) -> Dict[str, Any]:
    """torchvision-style ResNet speaker checkpoint -> the JAX package's
    tree (numpy leaves), as its ``convert_wespeaker_resnet`` makes it.

    Expects wespeaker's ResNet34 naming (conv1/bn1, layerN.M.convK/bnK,
    layerN.0.downsample.{0,1}, embedding linear at seg_1 or bottleneck),
    optionally behind a prefix like ``resnet.`` (pyannote wrapping)."""
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
              else np.asarray(v)) for k, v in state_dict.items()}
    prefixes = ("", "resnet.", "speaker_encoder.", "model.")
    prefix = next((p for p in prefixes if f"{p}conv1.weight" in sd), None)
    if prefix is None:
        raise KeyError("no conv1.weight found under known prefixes")

    def g(name):
        return sd[f"{prefix}{name}"]

    def conv(name):
        # torch [out, in, kh (freq), kw (time)] -> HWIO with time on H
        return g(name).transpose(3, 2, 1, 0)

    def bn(name):
        return {"g": g(f"{name}.weight"), "b": g(f"{name}.bias"),
                "mean": g(f"{name}.running_mean"),
                "var": g(f"{name}.running_var")}

    stages = []
    for si in range(1, len(cfg.blocks) + 1):
        stage = []
        bi = 0
        while f"{prefix}layer{si}.{bi}.conv1.weight" in sd:
            blk = {
                "conv1_w": conv(f"layer{si}.{bi}.conv1.weight"),
                "bn1": bn(f"layer{si}.{bi}.bn1"),
                "conv2_w": conv(f"layer{si}.{bi}.conv2.weight"),
                "bn2": bn(f"layer{si}.{bi}.bn2"),
            }
            if f"{prefix}layer{si}.{bi}.downsample.0.weight" in sd:
                blk["down_w"] = conv(f"layer{si}.{bi}.downsample.0.weight")
                blk["down_bn"] = bn(f"layer{si}.{bi}.downsample.1")
            stage.append(blk)
            bi += 1
        stages.append(stage)

    emb_key = next(
        (k for k in (f"{prefix}seg_1.weight", f"{prefix}bottleneck.weight",
                     f"{prefix}embedding.weight") if k in sd), None)
    if emb_key is None:
        raise KeyError("no embedding linear (seg_1/bottleneck) found")
    fc_w = sd[emb_key].T
    fc_b_key = emb_key.replace("weight", "bias")
    fc_b = sd.get(fc_b_key, np.zeros(fc_w.shape[1], np.float32))

    return {
        "stem_w": conv("conv1.weight"),
        "stem_bn": bn("bn1"),
        "stages": stages,
        "fc_w": fc_w,
        "fc_b": fc_b,
    }


def load_embedding_params(name: str = EMBEDDING_NAME,
                          cfg: Optional[EmbeddingConfig] = None
                          ) -> Optional[Dict[str, Any]]:
    """Speaker-embedding weights from the registry as the JAX package's
    tree, or None when it has neither form.  The two forms under
    ``$MWX_WEIGHTS_DIR/<name>/``, in the JAX package's order: ``jax/``, an
    orbax tree in this layout (``from_hf.load_params``; an unreadable one
    raises, as in JAX), then ``pytorch_model.bin``, a wespeaker state dict
    (the checkpoint pyannote 3.1 downloads), converted."""
    from pathlib import Path

    from .. import config
    from ..from_hf import load_params
    root = config.weights_dir()
    if not root:
        return None
    params = load_params(Path(root) / name / "jax")
    if params is not None:
        config.warn_if_synth_checkpoint(Path(root) / name,
                                        "speaker embedding")
        return params
    path = Path(root) / name / "pytorch_model.bin"
    if not path.exists():
        return None
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    config.warn_if_synth_checkpoint(path.parent, "speaker embedding")
    return convert_wespeaker_resnet(sd, cfg or EmbeddingConfig())


_EMBED_CHUNK = 256  # windows per device forward (fixed shape)


def stats_embeddings(batch: torch.Tensor, frames: torch.Tensor,
                     n_mels: int) -> torch.Tensor:
    """Batched spectral_stats_embedding (the JAX ``_stats_emb_jit``): rows
    ``[C, L]`` (zero-padded windows) and per-row valid mel-frame counts
    ``[C]`` -> L2-normalised embeddings ``[C, 3 * n_mels]``: the masked
    mean, standard deviation and mean absolute frame-to-frame delta of the
    raw log-mel, on the rows' device."""
    mel = unnormalized_log_mel(batch, n_mels)            # [C, T, M]
    t = mel.shape[1]
    idx = torch.arange(t, device=mel.device)[None, :, None]
    f = frames.to(mel.device)[:, None, None]
    mask = (idx < f).to(mel.dtype)
    cnt = torch.clamp(frames.to(mel.device)[:, None].to(mel.dtype), min=1.0)
    mean = (mel * mask).sum(dim=1) / cnt
    var = (((mel - mean[:, None]) ** 2) * mask).sum(dim=1) / cnt
    std = torch.sqrt(var)
    dmask = (idx[:, :-1] < f - 1).to(mel.dtype)
    delta = ((mel[:, 1:] - mel[:, :-1]).abs() * dmask).sum(dim=1) \
        / torch.clamp(cnt - 1.0, min=1.0)
    emb = torch.cat([mean, std, delta], dim=-1)
    norm = torch.linalg.norm(emb, dim=-1, keepdim=True)
    return emb / torch.clamp(norm, min=1e-12)


def spectral_stats_embedding(audio: np.ndarray, n_mels: int = 40,
                             device: DeviceLike = "cuda") -> np.ndarray:
    """Weightless fallback speaker signature of one clip: one row of
    ``stats_embeddings`` over all of its log-mel frames (``L // 160``),
    computed on ``device``."""
    dev = resolve_device(device)
    if len(audio) < 400:
        audio = np.pad(audio, (0, 400 - len(audio)))
    rows = torch.from_numpy(np.ascontiguousarray(audio[None], np.float32))
    frames = torch.tensor([len(audio) // 160])
    return stats_embeddings(rows.to(dev), frames, n_mels)[0].cpu().numpy()


# ---------------------------------------------------------------------------
# Agglomerative clustering (cosine, average linkage) — host numpy
# ---------------------------------------------------------------------------

def agglomerative_cluster(embeddings: np.ndarray,
                          threshold: float = 0.7,
                          min_speakers: int = 1,
                          max_speakers: Optional[int] = None) -> np.ndarray:
    """Cluster L2-normalised embeddings; returns labels [N].

    Average-linkage cosine AHC cut at ``threshold``, re-cut to the
    speaker-count bounds when they bind.  Uses scipy's O(n^2) linkage — a
    1-hour recording yields ~2400 sliding windows, where a naive
    pairwise-rescan merge loop takes hours; falls back to that loop only
    when scipy is unavailable.
    """
    n = len(embeddings)
    if n == 0:
        return np.zeros(0, np.int64)
    if n == 1:
        return np.zeros(1, np.int64)
    max_speakers = max_speakers or n
    try:
        from scipy.cluster.hierarchy import fcluster, linkage
        from scipy.spatial.distance import squareform
    except ImportError:
        return _agglomerative_cluster_py(embeddings, threshold,
                                         min_speakers, max_speakers)

    dist = np.clip(1.0 - embeddings @ embeddings.T, 0.0, None)
    np.fill_diagonal(dist, 0.0)
    link = linkage(squareform(dist, checks=False), method="average")
    labels = fcluster(link, t=threshold, criterion="distance") - 1
    k = int(labels.max()) + 1
    if k > max_speakers:      # keep merging past the threshold (as the
        k = max_speakers      # merge loop would) until the cap holds
    elif k < min_speakers:    # never merge below the floor
        k = min(min_speakers, n)
    else:
        k = None
    if k is not None:
        labels = fcluster(link, t=k, criterion="maxclust") - 1
    return _stable_labels(labels)


def constrained_agglomerative_cluster(embeddings: np.ndarray,
                                      groups: np.ndarray,
                                      threshold: float = 0.7,
                                      min_speakers: int = 1,
                                      max_speakers: Optional[int] = None,
                                      cl_trust_floor: float = 0.3
                                      ) -> np.ndarray:
    """Average-linkage cosine AHC with CANNOT-LINK constraints: two
    entries sharing a ``groups`` id never merge into one cluster.

    pyannote-3.1's clustering applies the same rule: distinct local
    speakers of one segmentation window are, by construction, different
    people — an unconstrained merge of two such embeddings is the single
    biggest source of under-clustering (measured here: the 4-speaker
    eval's closest voice pair merged on 1 of 4 files, zeroing one
    speaker's accuracy and double-claiming frames downstream).

    ``cl_trust_floor`` (r5): a cannot-link edge between two clusters is
    ENFORCED only while their (average-linkage) distance exceeds this
    value; closer than it, the edge is treated as a segmentation
    artifact and ignored.  The constraint propagates transitively
    through merges, so windows where segmentation hallucinates one
    voice as two local speakers permanently split that speaker no
    matter the threshold (measured: threshold 0.7→0.85 left the same
    pred-4-of-3 splits at DER 0.22-0.26).  A hallucinated split yields
    embeddings of the SAME voice — near-identical — while genuinely
    distinct speakers in an overlap window are far apart, so distance
    separates trustworthy constraints from artifacts.  The floor is
    applied DYNAMICALLY against the evolving cluster distance, not once
    at entry level: the overlap-heavy segmentation checkpoint
    hallucinates often enough on hour-scale audio that every
    same-speaker cluster pair eventually accumulates an edge (measured:
    60-min 3-spk file predicted 8 speakers, DER 0.357, with entry-level
    dropping only), and the cluster-level average distance is the
    statistic that stays small for same-voice pairs.

    Vectorised Lance-Williams merge loop: O(n^2) memory, argmin over the
    full matrix per merge (n sliding-window entries for an hour of audio
    is ~2-3k, a few seconds of numpy; scipy's linkage cannot express
    constraints)."""
    n = len(embeddings)
    if n <= 1:
        return np.zeros(n, np.int64)
    max_speakers = max_speakers or n
    d = np.clip(1.0 - embeddings @ embeddings.T, 0.0, None
                ).astype(np.float64)
    cannot = np.asarray(groups)[:, None] == np.asarray(groups)[None, :]
    np.fill_diagonal(d, np.inf)
    np.fill_diagonal(cannot, False)
    # an edge only blocks a merge while the pair is far apart (see
    # docstring: near-identical cannot-linked clusters are one voice
    # segmentation split in two, not two people)
    dw = np.where(cannot & (d > cl_trust_floor), np.inf, d)
    size = np.ones(n)
    merged_into = np.arange(n)      # union-find, path-free (small n)
    n_active = n
    while n_active > min_speakers:
        flat = int(np.argmin(dw))
        i, j = divmod(flat, n)
        d_min = dw[i, j]
        if not np.isfinite(d_min):
            # every remaining pair cannot-link.  A user-supplied
            # max_speakers cap still wins over the heuristic constraint
            # (segmentation can hallucinate a second local speaker in a
            # window): keep merging by RAW distance until the cap holds.
            if n_active <= max_speakers:
                break
            flat = int(np.argmin(d))
            i, j = divmod(flat, n)
            d_min = d[i, j]
            if not np.isfinite(d_min):
                break
        elif d_min > threshold and n_active <= max_speakers:
            break
        if j < i:
            i, j = j, i
        # average linkage (Lance-Williams): d(i+j, c)
        new_row = (size[i] * d[i] + size[j] * d[j]) / (size[i] + size[j])
        d[i], d[:, i] = new_row, new_row
        cannot[i] |= cannot[j]
        cannot[:, i] |= cannot[:, j]
        d[i, i] = np.inf
        dw[i] = np.where(cannot[i] & (d[i] > cl_trust_floor),
                         np.inf, d[i])
        dw[:, i] = dw[i]
        d[j], d[:, j] = np.inf, np.inf
        dw[j], dw[:, j] = np.inf, np.inf
        size[i] += size[j]
        merged_into[merged_into == j] = i
        n_active -= 1
    return _stable_labels(merged_into)


def _absorb_small_clusters(labels: np.ndarray, embeddings: np.ndarray,
                           min_size: int = 2, floor: int = 1,
                           groups: Optional[np.ndarray] = None) -> np.ndarray:
    """Reassign clusters with fewer than ``min_size`` members to the
    nearest (cosine, centroid) surviving cluster — pyannote-3.1's
    min_cluster_size rule.  Residual mixture embeddings (overlap frames
    that never occur solo) otherwise mint one-window phantom speakers.
    Never drops below ``floor`` surviving clusters; no-op when every
    cluster is small."""
    if len(labels) == 0:
        return labels
    ids, counts = np.unique(labels, return_counts=True)
    big = [int(i) for i, c in zip(ids, counts) if c >= min_size]
    if not big or len(big) == len(ids):
        return labels
    if len(big) < floor:   # keep the largest `floor` clusters instead
        order = np.argsort(-counts)
        big = [int(ids[i]) for i in order[:floor]]
    centroids = {}
    for g in big:
        c = embeddings[labels == g].mean(axis=0)
        centroids[g] = c / max(float(np.linalg.norm(c)), 1e-8)
    out = labels.copy()
    for g in ids:
        if int(g) in big:
            continue
        members = labels == g
        e = embeddings[members].mean(axis=0)
        e = e / max(float(np.linalg.norm(e)), 1e-8)
        # cannot-link (same segmentation window as a member): absorbing
        # into such a cluster would put two simultaneous local speakers
        # under one label; fall back over the remaining candidates
        allowed = list(centroids)
        if groups is not None:
            member_groups = set(np.asarray(groups)[members].tolist())
            ok = [k for k in centroids
                  if not (member_groups
                          & set(np.asarray(groups)[labels == k].tolist()))]
            if ok:
                allowed = ok
        nearest = max(allowed, key=lambda k: float(e @ centroids[k]))
        out[members] = nearest
    return _stable_labels(out)


def _stable_labels(labels: np.ndarray) -> np.ndarray:
    """Renumber clusters by first appearance (SPEAKER_00 speaks first)."""
    out = np.zeros(len(labels), np.int64)
    remap: Dict[int, int] = {}
    for i, lab in enumerate(labels):
        if lab not in remap:
            remap[lab] = len(remap)
        out[i] = remap[lab]
    return out


def _agglomerative_cluster_py(embeddings: np.ndarray, threshold: float,
                              min_speakers: int, max_speakers: int
                              ) -> np.ndarray:
    """Pure-python merge loop (exact but O(n^3)-ish; small n only)."""
    n = len(embeddings)
    clusters: List[List[int]] = [[i] for i in range(n)]
    dist = 1.0 - embeddings @ embeddings.T

    def avg_dist(a: List[int], b: List[int]) -> float:
        return float(dist[np.ix_(a, b)].mean())

    while len(clusters) > min_speakers:
        best = None
        best_d = np.inf
        for i in range(len(clusters)):
            for j in range(i + 1, len(clusters)):
                d = avg_dist(clusters[i], clusters[j])
                if d < best_d:
                    best_d = d
                    best = (i, j)
        if best is None:
            break
        if best_d > threshold and len(clusters) <= max_speakers:
            break
        i, j = best
        clusters[i] = clusters[i] + clusters[j]
        del clusters[j]

    labels = np.zeros(n, np.int64)
    clusters.sort(key=min)
    for ci, members in enumerate(clusters):
        for m in members:
            labels[m] = ci
    return labels


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

class DiarizationPipeline:
    """whisperx.diarize.DiarizationPipeline surface (transcribe.py:142-144),
    on ``device`` (CUDA unless the caller asks for the CPU).

    ``use_auth_token`` is accepted for compatibility; weights come from the
    registry instead of the HF hub: the segmentation network from
    ``pyannote-segmentation-3.0`` and the ResNet34 from
    ``wespeaker-voxceleb-resnet34-LM`` (each its orbax ``jax/`` tree, else
    its ``pytorch_model.bin``).
    ``segmentation_params`` and ``embedding_params`` take the JAX
    package's trees (numpy leaves) instead.  A weight that fails to load
    leaves its part on the weightless flow, as in the JAX package: no
    segmentation runs the windows flow over VAD regions, no embedding
    weights the 40-mel statistics embedding.  The settings are the module
    constants (``WINDOW_SEC`` ... ``ACTIVITY_OFFSET``), the JAX
    constructor's defaults, with the segmentation windows at half-window
    stride and pyannote's argmax powerset decode.
    """

    def __init__(self, use_auth_token: Optional[str] = None,
                 device: DeviceLike = "cuda",
                 segmentation_params: Optional[dict] = None,
                 segmentation_cfg: Optional[PyanNetConfig] = None,
                 embedding_params: Optional[dict] = None,
                 embedding_cfg: Optional[EmbeddingConfig] = None):
        from ..convert import (from_jax_pyannet, from_jax_resnet,
                               load_segmentation_params)
        self.device = resolve_device(device)
        if segmentation_params is None:
            try:
                segmentation_params = load_segmentation_params()
            except Exception:
                segmentation_params = None
        self.vad = VoiceActivityDetector(
            None if segmentation_params is None else from_jax_pyannet(
                segmentation_params, self.device,
                segmentation_cfg or PyanNetConfig()))
        self.embedding_cfg = embedding_cfg or EmbeddingConfig()
        if embedding_params is None:
            try:
                embedding_params = load_embedding_params(
                    cfg=self.embedding_cfg)
            except Exception:
                embedding_params = None
        # the ResNet34 on the pipeline's device, or None (statistics
        # embeddings)
        self.embedding = None if embedding_params is None else \
            from_jax_resnet(embedding_params, self.embedding_cfg,
                            self.device)

    # _embed pads clips to this ladder (seconds), 32 rows a forward: at
    # most five shapes however many clips
    _EMBED_LEN_BUCKETS_SEC = (0.5, 1.0, 2.0, 4.0, 10.0)

    _EMBED_ROW_CHUNK = 32  # rows per bucketed embed forward (fixed shape)

    def _len_bucket_samples(self, n: int) -> int:
        for sec in self._EMBED_LEN_BUCKETS_SEC:
            if n <= int(sec * SAMPLE_RATE):
                return int(sec * SAMPLE_RATE)
        return int(self._EMBED_LEN_BUCKETS_SEC[-1] * SAMPLE_RATE)

    def embed_rows(self, rows: np.ndarray, frames: np.ndarray
                   ) -> torch.Tensor:
        """One padded embedding forward on the pipeline's device: ``[R, L]``
        audio rows with their valid mel-frame counts -> ``[R, D]``
        embeddings (left on the device): the ResNet34 over 80-mel
        log-mel, or without its weights the 40-mel statistics
        embedding."""
        x = torch.from_numpy(rows).to(self.device)
        with torch.inference_mode():
            if self.embedding is None:
                return stats_embeddings(
                    x, torch.from_numpy(frames).to(self.device), 40)
            return self.embedding(unnormalized_log_mel(
                x, self.embedding_cfg.n_mels))

    def _embed_clips(self, clips) -> np.ndarray:
        """Variable-length clips -> [N, D] embeddings, grouped by length
        bucket into fixed _EMBED_ROW_CHUNK-row forwards."""
        out = [None] * len(clips)
        groups: Dict[int, List[int]] = {}
        for i, c in enumerate(clips):
            groups.setdefault(self._len_bucket_samples(len(c)), []).append(i)
        for bucket, idxs in groups.items():
            for lo in range(0, len(idxs), self._EMBED_ROW_CHUNK):
                sel = idxs[lo: lo + self._EMBED_ROW_CHUNK]
                rows = np.zeros((self._EMBED_ROW_CHUNK, bucket), np.float32)
                frames = np.ones(self._EMBED_ROW_CHUNK, np.int32)
                for r, i in enumerate(sel):
                    c = clips[i][:bucket]
                    rows[r, : len(c)] = c
                    frames[r] = max(len(c), 400) // 160
                emb = self.embed_rows(rows, frames).cpu().numpy()
                for r, i in enumerate(sel):
                    out[i] = emb[r]
        return np.stack(out)

    def _embed_windows(self, audio: np.ndarray,
                       windows: List[Tuple[float, float]]) -> np.ndarray:
        """Embed every sliding window in _EMBED_CHUNK-row forwards
        (zero-padded rows + valid-frame masks for trailing short
        windows)."""
        row_len = max(int(round(WINDOW_SEC * SAMPLE_RATE)), 400)
        n = len(windows)
        rows = np.zeros((n, row_len), np.float32)
        frames = np.zeros(n, np.int32)
        for i, (s, e) in enumerate(windows):
            clip = audio[int(s * SAMPLE_RATE): int(e * SAMPLE_RATE)]
            clip = clip[:row_len]
            rows[i, : len(clip)] = clip
            frames[i] = max(len(clip), 400) // 160

        out = []
        for lo in range(0, n, _EMBED_CHUNK):
            chunk = rows[lo: lo + _EMBED_CHUNK]
            cnt = frames[lo: lo + _EMBED_CHUNK]
            pad = _EMBED_CHUNK - len(chunk)  # fixed shape across forwards
            if pad:
                chunk = np.pad(chunk, ((0, pad), (0, 0)))
                cnt = np.pad(cnt, (0, pad), constant_values=1)
            emb = self.embed_rows(chunk, cnt).cpu().numpy()
            out.append(emb[: len(chunk) - pad if pad else None])
        return np.concatenate(out, axis=0)

    def _diarize_with_segmentation(self, audio: np.ndarray,
                                   min_speakers: Optional[int],
                                   max_speakers: Optional[int]
                                   ) -> List[dict]:
        """pyannote-3.1-style flow: sliding segmentation windows give local
        per-speaker activities (powerset); each active local speaker gets
        an embedding over its active samples; clustering maps local
        speakers to global labels; frame-level activities are stitched
        across windows and re-binarised per global speaker.  Split into
        ``_segment_and_embed`` (the device work) and
        ``_cluster_and_stitch`` (host clustering and binarisation)."""
        state = self._segment_and_embed(audio)
        if state is None:
            return []
        return self._cluster_and_stitch(state, len(audio),
                                        min_speakers, max_speakers)

    def _segment_and_embed(self, audio: np.ndarray):
        seg_cfg = self.vad.cfg
        window = int(seg_cfg.window_sec * SAMPLE_RATE)
        step = window // 2
        n = len(audio)
        starts = list(range(0, max(n - window // 2, 1), step))
        batch = np.zeros((len(starts), window), np.float32)
        for i, s in enumerate(starts):
            clip = audio[s: s + window]
            batch[i, : len(clip)] = clip

        log_probs = pyannet_forward_chunked(self.vad.model, batch)
        # pyannote's Powerset.to_multilabel hard decode
        spk = powerset_to_speaker_activity(log_probs)            # [W,F,3]
        n_frames = spk.shape[1]
        frame_dur = seg_cfg.window_sec / n_frames

        # active-speaker clips first, embeddings second in bucketed
        # batches
        keys = []   # (window_idx, local_spk)
        clips = []
        for wi, s in enumerate(starts):
            clip = batch[wi]
            for ls in range(spk.shape[2]):
                act = spk[wi, :, ls]
                if act.mean() < 0.1 or (act > 0.5).sum() * frame_dur < 0.4:
                    continue
                # embed on frames where this local speaker talks ALONE
                # (pyannote-3.1 semantics); fall back to all active frames
                # when the speaker is never alone in this window
                others = np.delete(spk[wi], ls, axis=1).max(axis=1)
                solo = (act > 0.5) & (others < 0.5)
                frames_mask = solo if solo.sum() * frame_dur >= 0.4 \
                    else (act > 0.5)
                mask = np.repeat(frames_mask,
                                 int(np.ceil(window / n_frames)))[:window]
                active_audio = clip[mask]
                if len(active_audio) < SAMPLE_RATE // 4:
                    continue
                keys.append((wi, ls))
                clips.append(active_audio)
        if not keys:
            return None
        entries = [(wi, ls, emb) for (wi, ls), emb in
                   zip(keys, self._embed_clips(clips))]

        embs = np.stack([e[2] for e in entries])
        if len(embs) > 1:
            embs = embs - embs.mean(axis=0, keepdims=True)
            embs = embs / np.clip(
                np.linalg.norm(embs, axis=1, keepdims=True), 1e-8, None)
        return {"entries": entries, "embs": embs, "spk": spk,
                "starts": starts, "n_frames": n_frames,
                "frame_dur": frame_dur}

    def _cluster_and_stitch(self, state: dict, n_samples: int,
                            min_speakers: Optional[int],
                            max_speakers: Optional[int]) -> List[dict]:
        entries, embs = state["entries"], state["embs"]
        spk, starts = state["spk"], state["starts"]
        n_frames, frame_dur = state["n_frames"], state["frame_dur"]
        n = n_samples
        # cannot-link groups: entries from the same segmentation window
        # are distinct local speakers, hence distinct people
        groups = np.asarray([wi for wi, _, _ in entries])
        labels = constrained_agglomerative_cluster(
            embs, groups, threshold=THRESHOLD,
            min_speakers=min_speakers or 1, max_speakers=max_speakers,
            cl_trust_floor=CL_TRUST_FLOOR)
        labels = _absorb_small_clusters(labels, embs,
                                        min_size=MIN_CLUSTER_SIZE,
                                        floor=min_speakers or 1,
                                        groups=groups)

        # stitch: accumulate global speaker activity on an absolute frame
        # grid (average across overlapping windows)
        n_global = int(labels.max()) + 1
        total_frames = int(np.ceil(n / SAMPLE_RATE / frame_dur)) + 1
        acc = np.zeros((n_global, total_frames), np.float64)
        cnt = np.zeros((n_global, total_frames), np.float64)
        for (wi, ls, _), g in zip(entries, labels):
            f0 = int(round(starts[wi] / SAMPLE_RATE / frame_dur))
            f1 = min(f0 + n_frames, total_frames)
            acc[g, f0:f1] += spk[wi, : f1 - f0, ls]
            cnt[g, f0:f1] += 1.0
        activity = np.where(cnt > 0, acc / np.maximum(cnt, 1), 0.0)

        segments: List[dict] = []
        duration = n / SAMPLE_RATE
        for g in range(n_global):
            for s, e in binarize(activity[g].astype(np.float32), frame_dur,
                                 VadOptions(vad_onset=ACTIVITY_ONSET,
                                            vad_offset=ACTIVITY_OFFSET,
                                            min_duration_on=0.3,
                                            min_duration_off=0.3)):
                segments.append({"start": round(max(0.0, s), 3),
                                 "end": round(min(duration, e), 3),
                                 "speaker": f"SPEAKER_{g:02d}"})
        segments.sort(key=lambda d: (d["start"], d["end"]))
        return segments

    def __call__(self, audio: np.ndarray,
                 min_speakers: Optional[int] = None,
                 max_speakers: Optional[int] = None) -> List[dict]:
        """audio -> [{start, end, speaker}] (SPEAKER_00, SPEAKER_01, ...)."""
        audio = np.asarray(audio, np.float32)
        if self.vad.model is not None:
            return self._diarize_with_segmentation(audio, min_speakers,
                                                   max_speakers)
        regions = self.vad(audio, VadOptions(min_duration_on=0.3,
                                             min_duration_off=0.3))
        # slide windows over speech regions
        windows: List[Tuple[float, float]] = []
        for s, e in regions:
            t = s
            while t < e:
                w_end = min(t + WINDOW_SEC, e)
                if w_end - t >= 0.4:
                    windows.append((t, w_end))
                if w_end >= e:
                    break
                t += STEP_SEC
        if not windows:
            return []

        embs = self._embed_windows(audio, windows)
        # center across the recording: shared structure (channel, silence
        # floor) otherwise dominates cosine similarity between speakers
        if len(embs) > 1:
            embs = embs - embs.mean(axis=0, keepdims=True)
            norms = np.linalg.norm(embs, axis=1, keepdims=True)
            embs = embs / np.clip(norms, 1e-8, None)

        labels = agglomerative_cluster(
            embs, threshold=THRESHOLD,
            min_speakers=min_speakers or 1,
            max_speakers=max_speakers)

        # merge consecutive same-speaker windows into segments
        segments: List[dict] = []
        for (s, e), lab in zip(windows, labels):
            name = f"SPEAKER_{lab:02d}"
            if segments and segments[-1]["speaker"] == name \
                    and s <= segments[-1]["end"] + 1e-6:
                segments[-1]["end"] = max(segments[-1]["end"], e)
            else:
                segments.append({"start": round(s, 3), "end": round(e, 3),
                                 "speaker": name})
        return segments


# ---------------------------------------------------------------------------
# Word/segment -> speaker assignment (D7)
# ---------------------------------------------------------------------------

def _overlap(a_start, a_end, b_start, b_end) -> float:
    return max(0.0, min(a_end, b_end) - max(a_start, b_start))


def _best_speaker(diarize_segments: Sequence[dict], start: float,
                  end: float) -> Optional[str]:
    votes: Dict[str, float] = {}
    for d in diarize_segments:
        ov = _overlap(start, end, d["start"], d["end"])
        if ov > 0:
            votes[d["speaker"]] = votes.get(d["speaker"], 0.0) + ov
    if not votes:
        return None
    return max(votes.items(), key=lambda kv: kv[1])[0]


def assign_word_speakers(diarize_segments: Sequence[dict], result: dict,
                         fill_nearest: bool = False) -> dict:
    """Interval-overlap speaker voting (whisperx.assign_word_speakers
    surface, transcribe.py:145).  Adds ``speaker`` to segments and words."""
    diarize_segments = list(diarize_segments)
    out = dict(result)
    segments = [dict(s) for s in result.get("segments", [])]
    for seg in segments:
        spk = _best_speaker(diarize_segments, seg.get("start", 0),
                            seg.get("end", 0))
        if spk is None and fill_nearest and diarize_segments:
            mid = (seg.get("start", 0) + seg.get("end", 0)) / 2
            spk = min(diarize_segments,
                      key=lambda d: min(abs(d["start"] - mid),
                                        abs(d["end"] - mid)))["speaker"]
        if spk is not None:
            seg["speaker"] = spk
        words = []
        for w in seg.get("words", []):
            w = dict(w)
            wspk = _best_speaker(diarize_segments, w.get("start", 0),
                                 w.get("end", 0))
            if wspk is not None:
                w["speaker"] = wspk
            elif spk is not None:
                w["speaker"] = spk
            words.append(w)
        if words:
            seg["words"] = words
    out["segments"] = segments
    return out
