"""PyTorch port: diarization's models and host code against the JAX package.

Same trees (numpy leaves) and the same seeded numpy inputs through
``manual_whisper_tpu.models.diarize`` and
``manual_whisper_tpu_torch.models.diarize`` on the CPU, float32:

- ``ResNet34`` against ``embed_forward`` within 1e-4 (embeddings are unit
  vectors), at ``tiny_test`` with non-trivial BatchNorm statistics and at
  the repository's ResNet34 on log-mel of short synthetic clips; the port
  also within 1e-5 of its own float64 evaluation;
- the 40-mel statistics embeddings (batched, and per clip as one row of
  the batched function) within 1e-5;
- a registry with the JAX tree but no torch export: the port reads the
  tree as the JAX package does; an empty ``jax/`` fails both alike;
- the copied clustering and speaker assignment equal exactly on seeded
  embeddings and segments.

The pipelines' flows are in ``tests/test_torch_diarize_pipeline.py``.
"""

import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from manual_whisper_tpu.convert.from_hf import load_params
from manual_whisper_tpu.eval.synth import render_conversation
from manual_whisper_tpu.models import diarize as jd
from manual_whisper_tpu.ops.mel import unnormalized_log_mel as j_mel
from manual_whisper_tpu_torch.convert import from_jax_resnet
from manual_whisper_tpu_torch.models import diarize as td
from cpu_budget import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
EMBED_DIR = ROOT / ".weights" / "wespeaker-voxceleb-resnet34-LM"
CPU = torch.device("cpu")
SR = 16000
TOL = 1e-4


def _tcfg(jcfg):
    return td.EmbeddingConfig(n_mels=jcfg.n_mels, channels=jcfg.channels,
                              blocks=jcfg.blocks, embed_dim=jcfg.embed_dim)


def _with_bn_stats(tree, seed):
    """Random BatchNorm gains, biases, means and variances in every norm,
    so a swapped statistic or a mislaid channel shows."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict) and set(node) == {"g", "b", "mean", "var"}:
            c = node["g"].shape
            return {"g": (1 + 0.2 * rng.standard_normal(c)).astype(np.float32),
                    "b": (0.1 * rng.standard_normal(c)).astype(np.float32),
                    "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node
    return walk(tree)


@pytest.fixture(scope="module")
def embedder():
    tree = load_params(EMBED_DIR / "jax")
    if tree is None:
        pytest.skip("no synthetic speaker embedder in the repository")
    return jax.tree.map(np.asarray, tree)


def _tiny_tree(seed):
    """A seeded ``tiny_test`` ResNet tree from the port's init (numpy
    leaves in the JAX layout): eager jax.random compiles every leaf's
    draw, seconds of CPU a process."""
    return td.init_embedding_params(torch.Generator().manual_seed(seed),
                                    td.EmbeddingConfig.tiny_test())


def _port_embed(tree, cfg, feats, dtype=torch.float32):
    model = from_jax_resnet(tree, cfg, CPU).to(dtype)
    with torch.inference_mode():
        return model(torch.tensor(feats, dtype=dtype)).numpy()


@pytest.mark.parametrize("frames", [48, 63])
def test_embed_forward_tiny_matches_jax(frames):
    jcfg = jd.EmbeddingConfig.tiny_test()
    tree = _with_bn_stats(_tiny_tree(frames), frames)
    feats = np.random.default_rng(frames).standard_normal(
        (3, frames, jcfg.n_mels)).astype(np.float32)
    ref = np.asarray(jd.embed_forward(tree, feats, jcfg))
    got = _port_embed(tree, _tcfg(jcfg), feats)
    assert got.shape == ref.shape == (3, jcfg.embed_dim)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def _clip_feats(seconds, seed, n_mels=80):
    audio, _ = render_conversation(n_turns=2, seed=seed, n_speakers=2)
    rows = np.stack([audio[int(o * SR): int((o + seconds) * SR)]
                     for o in (0.3, 1.1)])
    return np.asarray(j_mel(rows, n_mels))


@pytest.mark.parametrize("seconds", [0.5, 2.0])
def test_embed_forward_repository_resnet_matches_jax(embedder, seconds):
    """The full-size ResNet34 with the repository's trained weights, on
    log-mel of two clips of a synthetic conversation: within TOL of JAX
    and within 1e-5 of the port's own float64 evaluation."""
    cfg = td.EmbeddingConfig()
    feats = _clip_feats(seconds, seed=int(seconds * 10))
    ref = np.asarray(jd.embed_forward(embedder, feats, jd.EmbeddingConfig()))
    got = _port_embed(embedder, cfg, feats)
    f64 = _port_embed(embedder, cfg, feats.astype(np.float64),
                      torch.float64)
    np.testing.assert_allclose(got, f64, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    assert abs(float(got[0] @ got[1])) < 0.999   # two different clips


def test_init_embedding_params_match_jax_layout():
    cfg = td.EmbeddingConfig.tiny_test()
    ours = td.init_embedding_params(torch.Generator().manual_seed(0), cfg)
    theirs = jd.init_embedding_params(jax.random.PRNGKey(0),
                                      jd.EmbeddingConfig.tiny_test())
    a = jax.tree_util.tree_leaves_with_path(ours)
    b = jax.tree_util.tree_leaves_with_path(theirs)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.shape == np.asarray(y).shape and x.dtype == np.float32, k
    assert td.EmbeddingConfig() == _tcfg(jd.EmbeddingConfig())


def test_convert_wespeaker_resnet_matches_jax():
    """A torch state dict in wespeaker keys (behind pyannote's ``resnet.``
    prefix, embedding at ``bottleneck``) converts to equal trees."""
    from manual_whisper_tpu_torch.convert import wespeaker_state_dict
    jcfg = jd.EmbeddingConfig.tiny_test()
    tree = _with_bn_stats(_tiny_tree(5), 5)
    sd = {f"resnet.{k.replace('seg_1', 'bottleneck')}": v
          for k, v in wespeaker_state_dict(tree).items()}
    ours = td.convert_wespeaker_resnet(sd, _tcfg(jcfg))
    theirs = jd.convert_wespeaker_resnet(sd, jcfg)
    a = jax.tree_util.tree_leaves_with_path(ours)
    b = jax.tree_util.tree_leaves_with_path(theirs)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), k
    with pytest.raises(KeyError):
        td.convert_wespeaker_resnet({"x.weight": np.zeros(1)}, _tcfg(jcfg))


def test_load_embedding_params_reads_registry(tmp_path, monkeypatch):
    from manual_whisper_tpu_torch import config as tconfig
    from manual_whisper_tpu_torch.convert import wespeaker_state_dict
    monkeypatch.setenv("MWX_WEIGHTS_DIR", str(tmp_path))
    tconfig.clear_env_cache()
    assert td.load_embedding_params() is None
    jcfg = jd.EmbeddingConfig.tiny_test()
    tree = _tiny_tree(1)
    d = tmp_path / td.EMBEDDING_NAME
    d.mkdir()
    torch.save({"state_dict": wespeaker_state_dict(tree)},
               d / "pytorch_model.bin")
    (d / "SYNTH_TRAINED").write_text("synthetic\n")
    with pytest.warns(RuntimeWarning, match="synthetic"):
        loaded = td.load_embedding_params(cfg=_tcfg(jcfg))
    for (_, x), (_, y) in zip(jax.tree_util.tree_leaves_with_path(loaded),
                              jax.tree_util.tree_leaves_with_path(tree)):
        np.testing.assert_array_equal(x, y)


def _jax_only_registry(tmp_path, monkeypatch):
    """A registry whose ResNet34 is only the repository's orbax ``jax/``
    tree (no torch export, no synthetic-data marker)."""
    from manual_whisper_tpu import config as jconfig
    from manual_whisper_tpu_torch import config as tconfig
    monkeypatch.setenv("MWX_WEIGHTS_DIR", str(tmp_path))
    jconfig.clear_env_cache()
    tconfig.clear_env_cache()
    (tmp_path / td.EMBEDDING_NAME).mkdir()
    return tmp_path / td.EMBEDDING_NAME / "jax"


def test_jax_tree_without_export_warns(tmp_path, monkeypatch):
    """A registry holding the JAX package's orbax tree but no torch export:
    the port reads the tree, as the JAX package does, without a warning;
    the tree equals the JAX loader's bit for bit, and the pipeline embeds
    with the ResNet34 (not the 40-mel statistics)."""
    if not (EMBED_DIR / "jax").is_dir():
        pytest.skip("no synthetic speaker embedder in the repository")
    _jax_only_registry(tmp_path, monkeypatch).symlink_to(EMBED_DIR / "jax")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        tree = td.load_embedding_params()
        pipe = td.DiarizationPipeline(device="cpu")
    got, ref = (jax.tree_util.tree_leaves_with_path(t)
                for t in (tree, jd.load_embedding_params()))
    assert [k for k, _ in got] == [k for k, _ in ref] and len(got) == 182
    for (k, x), (_, y) in zip(got, ref):
        assert x.dtype == np.asarray(y).dtype, k
        assert x.tobytes() == np.asarray(y).tobytes(), k
    assert pipe.embedding is not None


def test_empty_jax_tree_fails_as_jax(tmp_path, monkeypatch):
    """An unreadable ``jax/`` tree (here: empty) fails the port's loader as
    it fails the JAX one, with the same error; both pipelines then fall
    back to the statistics embedding."""
    _jax_only_registry(tmp_path, monkeypatch).mkdir()
    with pytest.raises(FileNotFoundError) as jax_err:
        jd.load_embedding_params()
    with pytest.raises(FileNotFoundError) as port_err:
        td.load_embedding_params()
    assert str(port_err.value) == str(jax_err.value)
    assert jd.DiarizationPipeline().embedding_params is None
    assert td.DiarizationPipeline(device="cpu").embedding is None


# ---------------------------------------------------------------------------
# Statistics embeddings (40 mels)
# ---------------------------------------------------------------------------

def test_stats_embeddings_match_jax():
    rng = np.random.default_rng(0)
    audio, _ = render_conversation(n_turns=3, seed=1, n_speakers=3)
    rows = np.zeros((5, 3 * SR), np.float32)
    frames = np.zeros(5, np.int32)
    for i, n in enumerate((3 * SR, 2 * SR, 20000, 400, 7000)):
        lo = int(rng.integers(0, len(audio) - n))
        rows[i, :n] = audio[lo: lo + n]
        frames[i] = max(n, 400) // 160
    ref = np.asarray(jd._stats_emb_jit(rows, frames, 40))
    got = td.stats_embeddings(torch.from_numpy(rows),
                              torch.from_numpy(frames), 40).numpy()
    assert got.shape == ref.shape == (5, 120)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", [300, 7000, 2 * SR])
def test_spectral_stats_embedding_matches_jax(n):
    audio, _ = render_conversation(n_turns=2, seed=3, n_speakers=2)
    clip = audio[SR: SR + n]
    ref = jd.spectral_stats_embedding(clip)
    got = td.spectral_stats_embedding(clip, device="cpu")
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# Clustering and speaker assignment (copies): equal exactly
# ---------------------------------------------------------------------------

def _embs(seed, n, d=16, k=3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d))
    e = centers[rng.integers(0, k, n)] + 0.4 * rng.standard_normal((n, d))
    return (e / np.linalg.norm(e, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_clustering_labels_equal(seed):
    embs = _embs(seed, 24 + 4 * seed)
    groups = np.repeat(np.arange(len(embs) // 2), 2)
    for kw in ({}, {"threshold": 0.5}, {"max_speakers": 2},
               {"min_speakers": 4, "threshold": 0.2}):
        got = td.agglomerative_cluster(embs, **kw)
        assert got.tolist() == jd.agglomerative_cluster(embs, **kw).tolist()
        py = dict(threshold=kw.get("threshold", 0.7),
                  min_speakers=kw.get("min_speakers", 1),
                  max_speakers=kw.get("max_speakers", len(embs)))
        assert td._agglomerative_cluster_py(embs, **py).tolist() == \
            jd._agglomerative_cluster_py(embs, **py).tolist()
    for floor in (0.0, 0.3):
        kw = dict(threshold=0.8, cl_trust_floor=floor)
        got = td.constrained_agglomerative_cluster(embs, groups, **kw)
        ref = jd.constrained_agglomerative_cluster(embs, groups, **kw)
        assert got.tolist() == ref.tolist()
        for min_size in (2, 4):
            assert td._absorb_small_clusters(
                got, embs, min_size=min_size, groups=groups).tolist() == \
                jd._absorb_small_clusters(
                    ref, embs, min_size=min_size, groups=groups).tolist()
    assert td._stable_labels(np.array([3, 3, 1, 0, 1])).tolist() == \
        jd._stable_labels(np.array([3, 3, 1, 0, 1])).tolist()


def test_clustering_degenerate_inputs_equal():
    for embs in (np.zeros((0, 4), np.float32), np.eye(1, 4, dtype=np.float32),
                 np.eye(4, dtype=np.float32)):
        assert td.agglomerative_cluster(embs, 0.5, 1, 2).tolist() == \
            jd.agglomerative_cluster(embs, 0.5, 1, 2).tolist()
        g = np.zeros(len(embs), np.int64)
        assert td.constrained_agglomerative_cluster(
            embs, g, 0.5, 1, 2).tolist() == \
            jd.constrained_agglomerative_cluster(embs, g, 0.5, 1, 2).tolist()


@pytest.mark.parametrize("seed", range(3))
def test_assign_word_speakers_equal(seed):
    rng = np.random.default_rng(seed)
    diar = []
    t = 0.0
    while t < 30:
        d = float(rng.uniform(0.5, 4))
        diar.append({"start": round(t, 3), "end": round(t + d, 3),
                     "speaker": f"SPEAKER_{int(rng.integers(0, 3)):02d}"})
        t += d + float(rng.uniform(-0.5, 1.0))
    segs = []
    t = 0.0
    while t < 34:
        d = float(rng.uniform(0.5, 5))
        words = [{"word": "x", "start": t + 0.3 * i, "end": t + 0.3 * i + 0.25}
                 for i in range(int(d / 0.3))]
        seg = {"text": "x", "start": t, "end": t + d}
        if rng.random() < 0.7:
            seg["words"] = words
        segs.append(seg)
        t += d + float(rng.uniform(0, 2))
    result = {"segments": segs, "language": "zh"}
    for fill in (False, True):
        assert td.assign_word_speakers(diar, result, fill) == \
            jd.assign_word_speakers(diar, result, fill)
