"""PyTorch port: PyanNet VAD and its streamed pipeline vs the JAX package.

Same inputs (seeded numpy) through ``manual_whisper_tpu.models.vad`` and
``manual_whisper_tpu_torch.models.vad``, on the CPU in float32:

- the sinc filters within 1e-5;
- log-probs of random parameters at 2 s windows within 1e-4;
- the repository's trained segmentation weights at 10 s windows on the
  synthetic corpus they were trained on: speech probabilities within 1e-5
  of the same network in float64 and within 3e-4 of the JAX package (its
  own float32 error), and equal ``binarize`` regions;
- the committed ``pytorch_model.bin`` equal to the orbax tree bit for bit,
  read back through the JAX package's own converter; a registry holding
  only the orbax tree read by the port as by the JAX package;
- the port's pipeline with PyanNet in 2-window VAD blocks (so dispatch is
  streamed) gives the JAX pipeline's greedy segments with ``.synth_ckpt``.

``pytorch_model.bin`` is the orbax tree written with pyannote's state-dict
keys; to write it again, run this file:
``JAX_PLATFORMS=cpu python tests/test_torch_vad.py --export``.
"""

import copy
import sys
import warnings
from collections import OrderedDict
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from manual_whisper_tpu.convert.from_hf import load_params
from manual_whisper_tpu.eval.synth import render_file_with_times, sample_text
from manual_whisper_tpu.models import MODEL_CONFIGS as JCONFIGS
from manual_whisper_tpu.models import vad as jvad
from manual_whisper_tpu.pipeline.transcribe import \
    TranscribePipeline as JPipeline
from manual_whisper_tpu.tokenizer import make_test_tokenizer as j_tokenizer
from manual_whisper_tpu_torch.convert import (convert_pyannote_segmentation,
                                              from_jax_pyannet,
                                              load_segmentation_params)
from manual_whisper_tpu_torch.models import vad as tvad
from manual_whisper_tpu_torch.models.whisper import MODEL_CONFIGS
from manual_whisper_tpu_torch.pipeline import load_model

ROOT = Path(__file__).resolve().parent.parent
SEG_DIR = ROOT / ".weights" / "pyannote-segmentation-3.0"
CPU = torch.device("cpu")
OPTS = {"max_new_tokens": 40, "suppress_blank": False}


def pyannote_state_dict(tree) -> "OrderedDict[str, torch.Tensor]":
    """The JAX package's PyanNet tree as a pyannote state dict (the keys
    ``convert_pyannote_segmentation`` reads); every value keeps its bits."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))

    sd = OrderedDict()
    sd["sincnet.wav_norm1d.weight"] = t(tree["in_norm"]["g"])
    sd["sincnet.wav_norm1d.bias"] = t(tree["in_norm"]["b"])
    sd["sincnet.conv1d.0.low_hz_"] = t(tree["sinc_low_hz"])
    sd["sincnet.conv1d.0.band_hz_"] = t(tree["sinc_band_hz"])
    for i in (1, 2):
        sd[f"sincnet.conv1d.{i}.weight"] = t(
            np.asarray(tree[f"conv{i}_w"]).transpose(2, 1, 0))
        sd[f"sincnet.conv1d.{i}.bias"] = t(tree[f"conv{i}_b"])
    for i in range(3):
        sd[f"sincnet.norm1d.{i}.weight"] = t(tree[f"norm{i}"]["g"])
        sd[f"sincnet.norm1d.{i}.bias"] = t(tree[f"norm{i}"]["b"])
    for i, layer in enumerate(tree["lstm"]):
        for rev, suffix in (("", ""), ("_rev", "_reverse")):
            for w in ("ih", "hh"):
                sd[f"lstm.weight_{w}_l{i}{suffix}"] = t(layer[f"w_{w}{rev}"])
                sd[f"lstm.bias_{w}_l{i}{suffix}"] = t(layer[f"b_{w}{rev}"])
    for i in (1, 2):
        sd[f"linear.{i - 1}.weight"] = t(np.asarray(tree[f"fc{i}_w"]).T)
        sd[f"linear.{i - 1}.bias"] = t(tree[f"fc{i}_b"])
    sd["classifier.weight"] = t(np.asarray(tree["cls_w"]).T)
    sd["classifier.bias"] = t(tree["cls_b"])
    return sd


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.fixture(scope="module")
def trained():
    tree = load_params(SEG_DIR / "jax")
    if tree is None:
        pytest.skip("no trained segmentation checkpoint in the repository")
    return jax.tree.map(np.asarray, tree)


def _random_tree(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        jvad.init_pyannet_params(jax.random.PRNGKey(seed),
                                                 cfg))


def _synth_audio(seed, n_utts):
    rng = np.random.default_rng(seed)
    utts = [sample_text(rng, 4, 8) for _ in range(n_utts)]
    audio, words_t = render_file_with_times(utts, seed=seed)
    return audio, words_t


def _rows(audio, window):
    n = max(1, int(np.ceil(len(audio) / window)))
    rows = np.zeros((n, window), np.float32)
    rows.reshape(-1)[: len(audio)] = audio
    return rows


@pytest.mark.parametrize("weights", ["random", "trained"])
def test_sinc_filters_match_jax(weights, trained):
    tree = _random_tree(jvad.PyanNetConfig()) if weights == "random" \
        else trained
    ref = np.asarray(jvad.sinc_filters(tree["sinc_low_hz"],
                                       tree["sinc_band_hz"], 251))
    out = tvad.sinc_filters(torch.from_numpy(tree["sinc_low_hz"]),
                            torch.from_numpy(tree["sinc_band_hz"]), 251)
    assert out.dtype == torch.float32 and out.shape == (80, 1, 251)
    np.testing.assert_allclose(out.numpy(), ref.transpose(2, 1, 0),
                               rtol=0, atol=1e-5)
    model = from_jax_pyannet(tree, CPU)
    assert torch.equal(model.sinc, out)


@pytest.mark.parametrize("rows,seed", [(1, 0), (3, 1)])
def test_random_log_probs_match_jax(rows, seed):
    cfg = jvad.PyanNetConfig(window_sec=2.0)
    tree = _random_tree(cfg, seed)
    audio = (0.1 * np.random.default_rng(seed).standard_normal(
        (rows, 32000))).astype(np.float32)
    ref = np.asarray(jvad.pyannet_forward(tree, audio, cfg))
    model = from_jax_pyannet(tree, CPU, tvad.PyanNetConfig(window_sec=2.0))
    with torch.inference_mode():
        out = model(torch.from_numpy(audio)).numpy()
    assert out.shape == ref.shape == (rows, cfg.frames_per_window, 7)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


# speech probabilities of the trained weights: the port against the same
# network evaluated in float64 (the port in float32 measured <= 3.3e-6 on
# four synthetic files), and against the JAX package, whose float32 forward
# on the CPU is itself up to 1.6e-4 from that float64 evaluation
TRAINED_F64_ATOL = 1e-5
TRAINED_JAX_ATOL = 3e-4


@pytest.mark.parametrize("seed", [5, 9])
def test_trained_speech_probs_and_regions_match_jax(trained, seed):
    """Full 10 s windows of the synthetic corpus through the repository's
    weights: speech probabilities within TRAINED_F64_ATOL of a float64
    evaluation and within TRAINED_JAX_ATOL of the JAX package; regions
    equal."""
    audio, _ = _synth_audio(seed, 8)
    cfg = jvad.PyanNetConfig()
    rows = _rows(audio, 160000)
    ref = jvad.pyannet_forward_chunked(trained, rows, cfg)
    model = from_jax_pyannet(trained, CPU)
    out = tvad.pyannet_forward_chunked(model, rows)
    assert out.shape == ref.shape == (len(rows), 589, 7)
    with torch.inference_mode():
        f64 = copy.deepcopy(model).double()(
            torch.from_numpy(rows).double()).numpy()
    out_p = tvad.powerset_to_speech_prob(out)
    np.testing.assert_allclose(out_p, tvad.powerset_to_speech_prob(f64),
                               rtol=0, atol=TRAINED_F64_ATOL)
    ref_p = jvad.powerset_to_speech_prob(ref)
    np.testing.assert_allclose(out_p, ref_p, rtol=0, atol=TRAINED_JAX_ATOL)
    assert ref_p.max() > 0.9 and ref_p.min() < 0.1   # speech and silence
    jdet = jvad.VoiceActivityDetector(trained)
    tdet = tvad.VoiceActivityDetector(model)
    regions = tdet(audio)
    assert regions == jdet(audio) and len(regions) >= 2


@pytest.mark.parametrize("block_windows", [2, 16])
def test_iter_speech_probs_blocks_equal_all_at_once(block_windows):
    cfg = tvad.PyanNetConfig(window_sec=2.0)
    tree = _random_tree(jvad.PyanNetConfig(window_sec=2.0), 3)
    det = tvad.VoiceActivityDetector(from_jax_pyannet(tree, CPU, cfg))
    audio = (0.1 * np.random.default_rng(3).standard_normal(
        5 * 32000 + 7000)).astype(np.float32)
    whole = tvad.pyannet_forward_chunked(det.model, _rows(audio, 32000))
    whole = tvad.powerset_to_speech_prob(whole).reshape(-1)
    blocks = list(det.iter_speech_probs(audio, block_windows=block_windows))
    assert len(blocks) == -(-6 // block_windows)
    assert [last for _, _, last in blocks] == [False] * (len(blocks) - 1) \
        + [True]
    frame_dur = cfg.window_sec / cfg.frames_per_window
    probs, dur, _ = blocks[-1]
    assert dur == pytest.approx(frame_dur)
    # trimmed to the frames the audio covers
    assert len(probs) == int(np.ceil(len(audio) / 16000 / frame_dur))
    np.testing.assert_array_equal(probs, whole[: len(probs)])
    for p, _, _ in blocks[:-1]:
        np.testing.assert_array_equal(p, whole[: len(p)])


def test_energy_detector_yields_once():
    audio = np.zeros(16000, np.float32)
    audio[4000:9000] = 0.3 * np.sin(np.arange(5000) * 0.2)
    det = tvad.VoiceActivityDetector()
    blocks = list(det.iter_speech_probs(audio))
    assert len(blocks) == 1 and blocks[0][2] is True
    ref = jvad.energy_vad_probs(audio)
    np.testing.assert_array_equal(blocks[0][0], ref[0])
    det.warmup()                        # nothing to warm for energy
    assert det(audio) == jvad.VoiceActivityDetector()(audio)


def test_powerset_helpers_match_jax():
    lp = np.log(np.random.default_rng(0).dirichlet(np.ones(7), (5, 11)))
    assert tvad.POWERSET_CLASSES == jvad.POWERSET_CLASSES
    for name in ("powerset_to_speech_prob", "powerset_to_speaker_activity"):
        np.testing.assert_array_equal(getattr(tvad, name)(lp),
                                      getattr(jvad, name)(lp))


def test_init_pyannet_params_layout_and_seed():
    cfg = tvad.PyanNetConfig(window_sec=2.0)
    a = tvad.init_pyannet_params(torch.Generator().manual_seed(4), cfg)
    b = tvad.init_pyannet_params(torch.Generator().manual_seed(4), cfg)
    ref = _random_tree(jvad.PyanNetConfig(window_sec=2.0))
    pa, pr = _leaves(a), _leaves(ref)
    assert [k for k, _ in pa] == [k for k, _ in pr]
    for (_, x), (_, y), (_, z) in zip(pa, _leaves(b), pr):
        assert x.shape == z.shape and x.dtype == z.dtype
        np.testing.assert_array_equal(x, y)
    out = tvad.pyannet_forward_chunked(from_jax_pyannet(a, CPU, cfg),
                                       np.zeros((2, 32000), np.float32))
    assert out.shape == (2, cfg.frames_per_window, 7)
    np.testing.assert_allclose(np.exp(out).sum(-1), 1.0, atol=1e-5)


def test_exported_checkpoint_equals_orbax_tree(trained):
    """The committed pytorch_model.bin, read by the JAX package's own
    converter, is the orbax tree leaf for leaf and bit for bit; the port's
    converter reads the same tree."""
    path = SEG_DIR / "pytorch_model.bin"
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    expected = pyannote_state_dict(trained)
    assert list(sd) == list(expected)
    for k in sd:
        assert sd[k].dtype == torch.float32
        assert torch.equal(sd[k], expected[k]), k
    for converted in (jvad.convert_pyannote_segmentation(sd),
                      convert_pyannote_segmentation(sd)):
        got, ref = _leaves(converted), _leaves(trained)
        assert [k for k, _ in got] == [k for k, _ in ref]
        for (k, x), (_, y) in zip(got, ref):
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), k


def test_load_segmentation_params_reads_registry(trained, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv("MWX_WEIGHTS_DIR", str(tmp_path))
    assert load_segmentation_params() is None
    seg = tmp_path / "pyannote-segmentation-3.0"
    seg.mkdir()
    torch.save({"state_dict": pyannote_state_dict(trained)},
               seg / "pytorch_model.bin")
    (seg / "SYNTH_TRAINED").write_text("synthetic\n")
    with pytest.warns(RuntimeWarning, match="synthetic"):
        tree = load_segmentation_params()
    for (_, x), (_, y) in zip(_leaves(tree), _leaves(trained)):
        np.testing.assert_array_equal(x, y)


def test_load_model_registry_with_checkpoint_runs_pyannet(trained, tmp_path,
                                                          monkeypatch):
    seg = tmp_path / "pyannote-segmentation-3.0"
    seg.mkdir()
    torch.save(pyannote_state_dict(trained), seg / "pytorch_model.bin")
    monkeypatch.setenv("MWX_WEIGHTS_DIR", str(tmp_path))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        model = load_model("test", device="cpu", compute_type="float32")
    assert isinstance(model.vad.model, tvad.PyanNet)
    assert model.vad.model.sinc.device == CPU
    model.vad.warmup()
    audio, _ = _synth_audio(5, 3)
    assert model.vad(audio) == jvad.VoiceActivityDetector(trained)(audio)


def test_registry_with_only_the_jax_tree(trained, tmp_path, monkeypatch):
    """A registry whose segmentation checkpoint is only the orbax ``jax/``
    tree (no torch export, no synthetic-data marker): the port's loader
    gives the JAX loader's tree bit for bit, and ``load_model`` runs
    PyanNet with it, without a warning."""
    from manual_whisper_tpu import config as jconfig
    seg = tmp_path / "pyannote-segmentation-3.0"
    seg.mkdir()
    (seg / "jax").symlink_to(SEG_DIR / "jax")
    monkeypatch.setenv("MWX_WEIGHTS_DIR", str(tmp_path))
    jconfig.clear_env_cache()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tree = load_segmentation_params()
        model = load_model("test", device="cpu", compute_type="float32")
    got, ref = _leaves(tree), _leaves(jvad.load_segmentation_params())
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (k, x), (_, y) in zip(got, ref):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k
    assert isinstance(model.vad.model, tvad.PyanNet)
    audio, _ = _synth_audio(5, 3)
    assert model.vad(audio) == jvad.VoiceActivityDetector(trained)(audio)


def test_load_model_empty_registry_warns_as_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("MWX_WEIGHTS_DIR", str(tmp_path))
    with pytest.warns(RuntimeWarning,
                      match=r"VAD falling back to energy heuristics \(no "
                            "pyannote segmentation checkpoint"):
        model = load_model("test", device="cpu", compute_type="float32")
    assert model.vad.model is None
    (tmp_path / "pyannote-segmentation-3.0").mkdir()
    (tmp_path / "pyannote-segmentation-3.0" / "pytorch_model.bin") \
        .write_bytes(b"not a checkpoint")
    with pytest.warns(RuntimeWarning, match="failed to load"):
        model = load_model("test", device="cpu", compute_type="float32")
    assert model.vad.model is None


class _JBlocks(jvad.VoiceActivityDetector):
    """VAD blocks of 2 windows, so the pipeline streams."""

    def iter_speech_probs(self, audio, block_windows=2):
        return super().iter_speech_probs(audio, block_windows)


class _TBlocks(tvad.VoiceActivityDetector):
    """VAD blocks of 2 windows, each block's yield recorded."""

    events: list

    def iter_speech_probs(self, audio, block_windows=2):
        for item in super().iter_speech_probs(audio, block_windows):
            self.events.append("vad block")
            yield item


@pytest.mark.parametrize("seed,batch_size", [(21, 4), (8, 2)])
def test_streamed_pipeline_segments_match_jax(trained, seed, batch_size):
    synth = load_params(ROOT / ".synth_ckpt")
    if synth is None:
        pytest.skip("no committed synth checkpoint")
    audio, _ = _synth_audio(seed, 10)
    assert len(audio) > 2 * 160000          # 3 VAD windows: 2 blocks
    jm = JPipeline(synth, JCONFIGS["test"], j_tokenizer(),
                   vad=_JBlocks(trained), asr_options=OPTS, language="en")
    ref = jm.transcribe(audio, batch_size=batch_size, language="en")
    tm = load_model(synth, device="cpu", compute_type="float32",
                    cfg=MODEL_CONFIGS["test"], asr_options=OPTS,
                    language="en")
    tm.vad = _TBlocks(from_jax_pyannet(trained, CPU))
    events = tm.vad.events = []
    out = tm.transcribe(audio, batch_size=batch_size, language="en",
                        progress_callback=lambda p, m: events.append(m))
    keys = [(s["text"], s["start"], s["end"]) for s in out["segments"]]
    assert keys == [(s["text"], s["start"], s["end"])
                    for s in ref["segments"]]
    assert any(text for text, _, _ in keys)
    # a batch went out between the two VAD blocks
    blocks = [i for i, e in enumerate(events) if e == "vad block"]
    first_batch = next(i for i, e in enumerate(events)
                       if e.startswith("transcribed batch"))
    assert len(blocks) == 2 and blocks[0] < first_batch < blocks[1]
    stats = tm.last_stats
    assert stats["batches"] >= 2 and stats["vad_s"] > 0


def _export() -> None:
    tree = load_params(SEG_DIR / "jax")
    torch.save(pyannote_state_dict(jax.tree.map(np.asarray, tree)),
               SEG_DIR / "pytorch_model.bin")


if __name__ == "__main__" and "--export" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    _export()
