"""PyTorch port: wav2vec2 CTC logits against the JAX package.

Same weights (a JAX param tree, numpy leaves) and the same seeded numpy
audio go through ``manual_whisper_tpu.models.wav2vec2.wav2vec2_logits``
and the port's ``Wav2Vec2`` on the CPU in float32.  Tolerance: log-probs
within 1e-4, at ``tiny_test`` (random weights), at the repository's
synthetic aligner, with ragged ``n_valid`` (bucket padding masked) and
with extractor conv biases.  The port is also held within 1e-4 of HF
``Wav2Vec2ForCTC`` from a random config (skipped without
``transformers``), and its HF converter must give the JAX converter's tree
array for array, from both weight-norm spellings.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from manual_whisper_tpu.convert.from_hf import load_params
from manual_whisper_tpu.models import wav2vec2 as jw2v
from manual_whisper_tpu_torch.convert import (convert_wav2vec2_state_dict,
                                              from_jax_wav2vec2)
from manual_whisper_tpu_torch.models import wav2vec2 as tw2v
from cpu_budget import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
ALIGN_DIR = ROOT / ".weights" / "jonatasgrosman--wav2vec2-large-xlsr-53-english"
CPU = torch.device("cpu")
TOL = 1e-4
SR = 16000

HF_TINY = dict(vocab_size=12, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=128,
               conv_dim=[32] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
               conv_stride=[5, 2, 2, 2, 2, 2, 2],
               num_conv_pos_embeddings=16,
               num_conv_pos_embedding_groups=2,
               do_stable_layer_norm=True, feat_extract_norm="layer",
               hidden_dropout=0.0, attention_dropout=0.0,
               feat_proj_dropout=0.0, final_dropout=0.0,
               layerdrop=0.0, apply_spec_augment=False)


def _tcfg(jcfg):
    return tw2v.Wav2Vec2Config(
        vocab_size=jcfg.vocab_size, hidden=jcfg.hidden,
        n_layers=jcfg.n_layers, n_heads=jcfg.n_heads, ffn=jcfg.ffn,
        conv_dim=jcfg.conv_dim, pos_conv_kernel=jcfg.pos_conv_kernel,
        pos_conv_groups=jcfg.pos_conv_groups)


def _random_tree(jcfg, seed=0, conv_bias=False):
    # the port's seeded init (numpy leaves in the JAX layout): eager
    # jax.random compiles every leaf's draw, seconds of CPU a process
    tree = tw2v.init_wav2vec2_params(torch.Generator().manual_seed(seed),
                                     _tcfg(jcfg))
    rng = np.random.default_rng(seed)
    # non-trivial norms and biases, so a swapped gain or bias shows
    for key in ("fp_ln", "final_ln"):
        tree[f"{key}_g"] = (1 + 0.1 * rng.standard_normal(
            tree[f"{key}_g"].shape)).astype(np.float32)
        tree[f"{key}_b"] = (0.1 * rng.standard_normal(
            tree[f"{key}_b"].shape)).astype(np.float32)
    for k in ("q_b", "k_b", "v_b", "o_b", "fc1_b", "fc2_b"):
        tree["blocks"][k] = (0.05 * rng.standard_normal(
            tree["blocks"][k].shape)).astype(np.float32)
    tree["pos_conv_b"] = (0.05 * rng.standard_normal(
        tree["pos_conv_b"].shape)).astype(np.float32)
    if conv_bias:
        for conv in tree["conv"]:
            conv["b"] = (0.1 * rng.standard_normal(
                conv["ln_g"].shape)).astype(np.float32)
    return tree


def _audio(b, n, seed=0):
    x = np.random.default_rng(seed).standard_normal((b, n)).astype(
        np.float32)
    return (x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)


def _both(tree, jcfg, audio, n_valid=None):
    ref = np.asarray(jw2v.wav2vec2_logits(
        tree, audio, jcfg, None if n_valid is None
        else jax.numpy.asarray(n_valid, jax.numpy.int32)))
    model = from_jax_wav2vec2(tree, _tcfg(jcfg), CPU)
    with torch.inference_mode():
        got = model(torch.from_numpy(audio),
                    None if n_valid is None
                    else torch.as_tensor(n_valid)).numpy()
    return got, ref


@pytest.mark.parametrize("conv_bias", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_logits_match_jax_tiny(conv_bias, ragged):
    jcfg = jw2v.Wav2Vec2Config.tiny_test()
    tree = _random_tree(jcfg, seed=1 + conv_bias, conv_bias=conv_bias)
    audio = _audio(3, 2 * SR, seed=2)
    n_valid = None
    if ragged:
        n_valid = np.array([2 * SR, 23456, 5000], np.int32)
        for r, n in enumerate(n_valid):
            audio[r, n:] = 0.0
    got, ref = _both(tree, jcfg, audio, n_valid)
    assert got.shape == ref.shape == (3, jw2v.frames_for_samples(2 * SR),
                                      jcfg.vocab_size)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_padding_is_masked_like_jax():
    """A row padded to a longer bucket with its n_valid gives the unpadded
    row's logits on its valid frames (the JAX mask's contract)."""
    jcfg = jw2v.Wav2Vec2Config.tiny_test()
    tree = _random_tree(jcfg, seed=3)
    model = from_jax_wav2vec2(tree, _tcfg(jcfg), CPU)
    short = _audio(1, 20000, seed=4)
    padded = np.zeros((1, 2 * SR), np.float32)
    padded[0, :20000] = short[0]
    with torch.inference_mode():
        alone = model(torch.from_numpy(short)).numpy()
        masked = model(torch.from_numpy(padded),
                       torch.tensor([20000])).numpy()
    nf = tw2v.frames_for_samples(20000)
    np.testing.assert_allclose(masked[0, :nf], alone[0], atol=TOL, rtol=0)


@pytest.fixture(scope="module")
def synth_aligner():
    import json
    tree = load_params(ALIGN_DIR / "jax")
    if tree is None:
        pytest.skip("no synthetic aligner in the repository")
    meta = json.loads((ALIGN_DIR / "align_meta.json").read_text())
    return (jax.tree.map(np.asarray, tree),
            jw2v.Wav2Vec2Config(**meta["config"]))


@pytest.mark.parametrize("ragged", [False, True])
def test_logits_match_jax_synthetic_aligner(synth_aligner, ragged):
    from manual_whisper_tpu.eval.synth import (render_file_with_times,
                                               sample_text)
    tree, jcfg = synth_aligner
    rng = np.random.default_rng(5)
    rows = []
    for seed in range(3):
        audio, _ = render_file_with_times(
            [sample_text(rng, 3, 5)], seed=seed)
        rows.append(audio[: 4 * SR])
    n = max(len(r) for r in rows)
    batch = np.zeros((3, n), np.float32)
    n_valid = np.array([len(r) for r in rows], np.int32)
    for i, r in enumerate(rows):
        batch[i, : len(r)] = (r - r.mean()) / np.sqrt(r.var() + 1e-7)
    got, ref = _both(tree, jcfg, batch, n_valid if ragged else None)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_frames_for_samples_and_valid_frames():
    for n in (0, 399, 400, 401, 16000, 23456, 480000):
        assert tw2v.frames_for_samples(n) == jw2v.frames_for_samples(n)
    n_valid = torch.tensor([0, 1, 399, 400, 16000, 23456])
    expect = [max(jw2v.frames_for_samples(int(n)), 1) for n in n_valid]
    assert tw2v.valid_frames(n_valid).tolist() == expect


def test_config_defaults_and_init_match_jax_layout():
    assert tw2v.Wav2Vec2Config() == _tcfg(jw2v.Wav2Vec2Config())
    assert tw2v.Wav2Vec2Config.tiny_test() == _tcfg(
        jw2v.Wav2Vec2Config.tiny_test())
    assert tw2v.CONV_LAYERS == jw2v.CONV_LAYERS
    jcfg = jw2v.Wav2Vec2Config.tiny_test()
    ours = tw2v.init_wav2vec2_params(torch.Generator().manual_seed(0),
                                     _tcfg(jcfg))
    theirs = jw2v.init_wav2vec2_params(jax.random.PRNGKey(0), jcfg)
    a = jax.tree_util.tree_leaves_with_path(ours)
    b = jax.tree_util.tree_leaves_with_path(theirs)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.shape == np.asarray(y).shape and x.dtype == np.float32, k


def _hf_model(seed=0, conv_bias=False):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(seed)
    cfg = transformers.Wav2Vec2Config(**HF_TINY, conv_bias=conv_bias)
    hf = transformers.Wav2Vec2ForCTC(cfg).eval()
    with torch.no_grad():      # non-trivial norms and biases
        for name, p in hf.named_parameters():
            if "layer_norm" in name or name.endswith("bias"):
                p.add_(0.1 * torch.randn(p.shape))
    return hf


@pytest.mark.parametrize("conv_bias", [False, True])
def test_logits_match_hf(conv_bias):
    hf = _hf_model(seed=conv_bias, conv_bias=conv_bias)
    cfg = _tcfg(jw2v.Wav2Vec2Config.tiny_test())
    tree = convert_wav2vec2_state_dict(hf.state_dict(), cfg)
    model = from_jax_wav2vec2(tree, cfg, CPU)
    audio = torch.from_numpy(_audio(2, SR, seed=6))
    with torch.no_grad():
        theirs = torch.log_softmax(hf(audio).logits, dim=-1)
        ours = model(audio)
    assert ours.shape == theirs.shape
    assert float((ours - theirs).abs().max()) <= TOL


@pytest.mark.parametrize("spelling", ["parametrizations", "weight_g"])
def test_hf_converter_equals_jax(spelling):
    hf = _hf_model(seed=2, conv_bias=True)
    sd = dict(hf.state_dict())
    key = "wav2vec2.encoder.pos_conv_embed.conv."
    has_new = f"{key}parametrizations.weight.original0" in sd
    if spelling == "weight_g" and has_new:
        sd[f"{key}weight_g"] = sd.pop(f"{key}parametrizations.weight"
                                      ".original0")
        sd[f"{key}weight_v"] = sd.pop(f"{key}parametrizations.weight"
                                      ".original1")
    elif spelling == "parametrizations" and not has_new:
        sd[f"{key}parametrizations.weight.original0"] = sd.pop(
            f"{key}weight_g")
        sd[f"{key}parametrizations.weight.original1"] = sd.pop(
            f"{key}weight_v")
    jcfg = jw2v.Wav2Vec2Config.tiny_test()
    ours = convert_wav2vec2_state_dict(sd, _tcfg(jcfg))
    theirs = jw2v.convert_wav2vec2_state_dict(sd, jcfg)
    a = jax.tree_util.tree_leaves_with_path(ours)
    b = jax.tree_util.tree_leaves_with_path(theirs)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        y = np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k
