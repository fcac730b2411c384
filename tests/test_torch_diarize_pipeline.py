"""PyTorch port: ``DiarizationPipeline`` against the JAX package's, both
flows, on the CPU.

Seeded ``render_conversation`` audio (3 speakers, about 25 s) goes through
both pipelines with the same weights (JAX trees, numpy leaves: the
repository's PyanNet, a seeded ``tiny_test`` ResNet) and the defaults as
they are (threshold 0.8, trust floor 0.3, min cluster 2, onset 0.5 /
offset 0.35, argmax powerset decode).  Held equal, segment for segment (start, end,
speaker): the segmentation flow and the windows flow (no segmentation
weights, the energy VAD's regions), each with the ResNet and with the
40-mel statistics embedding; then DER against the conversation's
reference turns, and ``assign_word_speakers`` on the segments.  With the
repository's registry itself (orbax trees only), both pipelines load the
trained PyanNet and ResNet34 and give the same speakers.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from manual_whisper_tpu.convert.from_hf import load_params
from manual_whisper_tpu.eval.metrics import der
from manual_whisper_tpu.eval.synth import render_conversation, turns_to_rttm
from manual_whisper_tpu.models import diarize as jd
from manual_whisper_tpu_torch.models import diarize as td
from cpu_budget import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
WEIGHTS = ROOT / ".weights"


def _tree(name):
    tree = load_params(WEIGHTS / name / "jax")
    if tree is None:
        pytest.skip(f"no {name} checkpoint in the repository")
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def segmentation():
    return _tree("pyannote-segmentation-3.0")


@pytest.fixture(scope="module")
def conversation():
    audio, turns = render_conversation(n_turns=10, seed=11, n_speakers=3,
                                       overlap_prob=0.2)
    assert 20 < len(audio) / 16000 < 32
    return audio, turns_to_rttm(turns)


def _pipelines(seg, emb, tiny=False):
    """The JAX and the port pipeline over the same trees (None: the
    registry's, which the tests pin to an empty directory); ``tiny``: the
    embedding tree is a ``tiny_test`` ResNet's."""
    jcfg = jd.EmbeddingConfig.tiny_test() if tiny else None
    tcfg = td.EmbeddingConfig.tiny_test() if tiny else None
    jp = jd.DiarizationPipeline(segmentation_params=seg,
                                embedding_params=emb, embedding_cfg=jcfg)
    tp = td.DiarizationPipeline(device="cpu", segmentation_params=seg,
                                embedding_params=emb, embedding_cfg=tcfg)
    return jp, tp


def _tiny_resnet():
    """A seeded ``tiny_test`` ResNet tree (the port's init: numpy leaves
    in the JAX layout).  The flows embed 32-row forwards of clips up to
    10 s and 256-row forwards of 3 s windows, which the full ResNet34
    spends minutes of CPU on under the suite's parallel workers; the full
    network (the repository's weights) is held to JAX on short clips in
    test_torch_diarize.py."""
    return td.init_embedding_params(torch.Generator().manual_seed(7),
                                    td.EmbeddingConfig.tiny_test())


@pytest.mark.parametrize("flow", ["segmentation", "windows"])
@pytest.mark.parametrize("embedding", ["resnet_tiny", "stats"])
def test_pipeline_segments_equal(flow, embedding, segmentation,
                                 conversation):
    audio, ref_turns = conversation
    emb = _tiny_resnet() if embedding == "resnet_tiny" else None
    jp, tp = _pipelines(segmentation if flow == "segmentation" else None,
                        emb, tiny=embedding == "resnet_tiny")
    assert (tp.vad.model is None) == (flow == "windows")
    assert (tp.embedding is None) == (embedding == "stats")
    ref = jp(audio)
    got = tp(audio)
    assert got == ref
    assert len({s["speaker"] for s in got}) >= 2
    assert der(ref_turns, got) == der(ref_turns, ref)
    result = {"segments": [{"text": "x", "start": t["start"],
                            "end": t["end"],
                            "words": [{"word": "x", "start": t["start"],
                                       "end": t["start"] + 0.3}]}
                           for t in ref_turns]}
    assert td.assign_word_speakers(got, result) == \
        jd.assign_word_speakers(ref, result)


def test_pipeline_speaker_bounds_and_silence_equal(segmentation):
    audio, _ = render_conversation(n_turns=6, seed=4, n_speakers=3)
    jp, tp = _pipelines(segmentation, None)
    for kw in ({"max_speakers": 2}, {"min_speakers": 3}):
        assert tp(audio, **kw) == jp(audio, **kw)
    silence = np.zeros(16000, np.float32)
    assert tp(silence) == jp(silence) == []


def test_registry_resnet34_speakers_equal(monkeypatch):
    """The repository's registry as a checkout has it (``.weights``: orbax
    ``jax/`` trees, no ResNet34 torch export): both pipelines load the
    trained PyanNet and ResNet34 themselves and give the same speaker
    turns on a seeded 10 s conversation."""
    from manual_whisper_tpu import config as jconfig
    from manual_whisper_tpu_torch import config as tconfig
    if not (WEIGHTS / td.EMBEDDING_NAME / "jax").is_dir():
        pytest.skip("no trained ResNet34 in the repository")
    monkeypatch.setenv("MWX_WEIGHTS_DIR", str(WEIGHTS))
    monkeypatch.setenv("MWX_ALLOW_SYNTH_WEIGHTS", "1")
    jconfig.clear_env_cache()
    tconfig.clear_env_cache()
    audio, _ = render_conversation(n_turns=4, seed=11, n_speakers=3,
                                   overlap_prob=0.2)
    jp = jd.DiarizationPipeline()
    tp = td.DiarizationPipeline(device="cpu")
    assert tp.vad.model is not None and tp.embedding is not None
    assert jp.embedding_params is not None
    got, ref = tp(audio), jp(audio)
    assert got == ref
    assert len({s["speaker"] for s in got}) == 3


def test_pipeline_defaults_match_jax():
    """The port's settings are module constants at the JAX constructor's
    defaults; the JAX options that select another path (a segmentation
    stride, the marginal powerset decode) default to the one the port
    runs."""
    import inspect
    ours = inspect.signature(td.DiarizationPipeline.__init__).parameters
    theirs = inspect.signature(jd.DiarizationPipeline.__init__).parameters
    constants = {name: getattr(td, name.upper()) for name in (
        "window_sec", "step_sec", "threshold", "cl_trust_floor",
        "min_cluster_size", "activity_onset", "activity_offset")}
    for name, p in theirs.items():
        if name == "self":
            continue
        if name in constants:
            assert constants[name] == p.default, name
        elif name == "seg_step_sec":
            assert p.default is None
        elif name == "powerset_decode":
            assert p.default == "argmax"
        elif name != "device":
            assert ours[name].default == p.default, name
    assert td.DiarizationPipeline._EMBED_LEN_BUCKETS_SEC == \
        jd.DiarizationPipeline._EMBED_LEN_BUCKETS_SEC
    assert td.DiarizationPipeline._EMBED_ROW_CHUNK == \
        jd.DiarizationPipeline._EMBED_ROW_CHUNK == 32
    assert td._EMBED_CHUNK == jd._EMBED_CHUNK == 256


def test_pipeline_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        td.DiarizationPipeline()
