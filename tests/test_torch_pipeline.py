"""PyTorch port: the transcription pipeline and the CLI vs the JAX package.

The port's ``TranscribePipeline`` on ``.synth_ckpt`` with the energy VAD
(the registry is empty here; ``test_torch_vad.py`` runs PyanNet),
fed the audio and options of ``test_synth.py``'s end-to-end tripwire, must
return the JAX pipeline's segments exactly (text, start, end), and the
port's CLI must write the JAX CLI's Markdown for a WAV fixture apart from
the device and timing lines.
"""

import numpy as np
import pytest
import torch

from manual_whisper_tpu.convert.from_hf import load_params
from manual_whisper_tpu.eval.metrics import wer
from manual_whisper_tpu.eval.synth import render_file_with_times, sample_text
from manual_whisper_tpu.models import MODEL_CONFIGS as JCONFIGS
from manual_whisper_tpu.ops.quant import quantize_params as j_quantize_params
from manual_whisper_tpu.pipeline.transcribe import \
    TranscribePipeline as JPipeline
from manual_whisper_tpu.tokenizer import make_test_tokenizer as j_tokenizer
from manual_whisper_tpu_torch.models import MODEL_CONFIGS
from manual_whisper_tpu_torch.pipeline import load_model
from manual_whisper_tpu_torch.text import clean_result_segments

OPTS = {"max_new_tokens": 40, "suppress_blank": False}


@pytest.fixture(scope="module")
def synth():
    params = load_params(".synth_ckpt")
    if params is None:
        pytest.skip("no committed synth checkpoint")
    return params


def _synth_file(seed=123, n_utts=3):
    rng = np.random.default_rng(seed)
    utts = [sample_text(rng, 4, 8) for _ in range(n_utts)]
    audio, words_t = render_file_with_times(utts, seed=seed)
    return audio, " ".join(w for w, _, _ in words_t)


def _port_model(params, **kw):
    return load_model(params, device="cpu", compute_type="float32",
                      cfg=MODEL_CONFIGS["test"], **kw)


def _keys(segments):
    return [(s["text"], s["start"], s["end"]) for s in segments]


@pytest.mark.parametrize("seed,batch_size", [(123, 4), (7, 2)])
def test_pipeline_segments_match_jax(synth, seed, batch_size):
    audio, truth = _synth_file(seed)
    jm = JPipeline(synth, JCONFIGS["test"], j_tokenizer(),
                   asr_options=OPTS, language="en")
    ref = jm.transcribe(audio, batch_size=batch_size, language="en")
    tm = _port_model(synth, asr_options=OPTS, language="en")
    out = tm.transcribe(audio, batch_size=batch_size, language="en")
    assert out["language"] == ref["language"] == "en"
    assert _keys(out["segments"]) == _keys(ref["segments"])
    cleaned, _, _ = clean_result_segments(out["segments"])
    hyp = " ".join(s["text"].strip() for s in cleaned)
    assert wer(truth, hyp) < 0.3, f"ref={truth!r} hyp={hyp!r}"
    stats = tm.last_stats
    assert stats["windows"] >= len(out["segments"]) and stats["batches"] >= 1
    assert stats["rows"] >= stats["windows"]
    assert stats["token_rows"] > 0 and stats["rung_rows"][0] >= 1


@pytest.mark.parametrize("ckv_scale_bf16", [False, True])
def test_int8_pipeline_segments_match_jax(synth, ckv_scale_bf16):
    """int8 weights and int8 cross K/V at float32 activations: the JAX
    pipeline's segments exactly, for f32 and bf16 cross-K/V scales."""
    qparams = j_quantize_params(synth)
    opts = {**OPTS, "int8_cross_kv": True, "ckv_scale_bf16": ckv_scale_bf16}
    audio, _ = _synth_file(123)
    jm = JPipeline(qparams, JCONFIGS["test"], j_tokenizer(),
                   asr_options=opts, language="en")
    ref = jm.transcribe(audio, batch_size=4, language="en")
    tm = _port_model(qparams, asr_options=opts, language="en")
    out = tm.transcribe(audio, batch_size=4, language="en")
    assert _keys(out["segments"]) == _keys(ref["segments"])
    assert any(s["text"] for s in out["segments"])
    stats = tm.last_stats
    assert stats["decode_calls"] >= stats["batches"] >= 1
    assert stats["decode_steps"] * 4 <= stats["token_rows"]


def test_silence_yields_no_segments(synth):
    tm = _port_model(synth, asr_options=OPTS)
    out = tm.transcribe(np.zeros(32000, np.float32), batch_size=2)
    assert out == {"segments": [], "language": "zh"}


def test_detect_language_matches_jax(synth):
    audio, _ = _synth_file(11, n_utts=1)
    jm = JPipeline(synth, JCONFIGS["test"], j_tokenizer(), asr_options=OPTS)
    tm = _port_model(synth, asr_options=OPTS)
    assert tm.detect_language(audio) == jm.detect_language(audio)


def test_load_model_surface(synth, monkeypatch):
    int8 = load_model("test", device="cpu", compute_type="int8")
    assert int8.cfg.dtype == torch.bfloat16
    fc1 = int8.params["encoder"]["blocks"][0]["mlp"]["fc1_w"]
    assert fc1["q"].dtype == torch.int8 and fc1["s"].dtype == torch.float32
    assert int8.params["decoder"]["tok_emb"].dtype == torch.bfloat16
    with pytest.raises(KeyError):
        load_model("test", device="cpu", compute_type="fp32")
    with pytest.raises(KeyError):
        load_model("no-such-model", device="cpu")
    with pytest.raises(ValueError):
        load_model(synth, device="cpu")                 # tree needs cfg
    monkeypatch.delenv("MWX_ALLOW_RANDOM_WEIGHTS", raising=False)
    with pytest.raises(FileNotFoundError):
        load_model("tiny", device="cpu")
    model = load_model("test", device="cpu")
    assert model.cfg.dtype == torch.bfloat16
    assert model.params["decoder"]["tok_emb"].dtype == torch.bfloat16


def test_load_model_warns_when_registry_has_pyannote(tmp_path, monkeypatch):
    """A registry whose pyannote checkpoint is an unreadable orbax tree (an
    empty ``jax/``): both packages fall back to the energy VAD with the
    same warning, which says why."""
    from manual_whisper_tpu.pipeline.transcribe import \
        load_model as j_load_model
    (tmp_path / "pyannote-segmentation-3.0" / "jax").mkdir(parents=True)
    monkeypatch.setenv("MWX_WEIGHTS_DIR", str(tmp_path))
    with pytest.warns(RuntimeWarning, match="energy heuristics") as port:
        model = load_model("test", device="cpu", compute_type="float32")
    assert model.vad.model is None
    with pytest.warns(RuntimeWarning, match="energy heuristics") as jax:
        j_load_model("test", compute_type="float32")
    said = [[str(w.message) for w in ws if "energy" in str(w.message)]
            for ws in (port, jax)]
    assert said[0] == said[1]
    assert "segmentation weights failed to load: Metadata file" in said[0][0]


def _wav_fixture(path):
    from manual_whisper_tpu.audio import write_wav
    audio, _ = _synth_file(21)
    write_wav(path, audio, 16000)


def _markdown_without_run_lines(path):
    lines = path.read_text(encoding="utf-8").splitlines()
    return [ln for ln in lines
            if not ln.startswith(("**模型**", "**转写总耗时**"))]


def test_cli_markdown_matches_jax_cli(synth, tmp_path, monkeypatch, capsys):
    """Both CLIs on the same WAV with the same synth weights.  The quality
    gates are switched off on both sides so no row falls back to sampling
    (whose random numbers differ between JAX and the port)."""
    import manual_whisper_tpu.cli as jcli
    import manual_whisper_tpu_torch.cli as tcli
    from manual_whisper_tpu.pipeline.transcribe import \
        TranscribePipeline as JP
    from manual_whisper_tpu.models.vad import VadOptions as JVadOptions

    gates_off = {"log_prob_threshold": None,
                 "compression_ratio_threshold": None}

    def jax_load(name, device=None, compute_type="bfloat16", language=None,
                 asr_options=None, vad_options=None, **_):
        return JP(synth, JCONFIGS["test"], j_tokenizer(),
                  asr_options={**asr_options, **OPTS, **gates_off},
                  vad_options=JVadOptions(**vad_options), language=language)

    def port_load(name, device=None, compute_type="bfloat16", language=None,
                  asr_options=None, vad_options=None, **_):
        return load_model(synth, device="cpu", compute_type="float32",
                          cfg=MODEL_CONFIGS["test"], language=language,
                          asr_options={**asr_options, **OPTS, **gates_off},
                          vad_options=vad_options)

    monkeypatch.setattr(jcli, "load_model", jax_load)
    monkeypatch.setattr(tcli, "load_model", port_load)
    monkeypatch.setenv("WHISPER_MODEL", "test")
    monkeypatch.setattr(tcli, "resolve_device",
                        lambda device: torch.device("cpu"))
    monkeypatch.delenv("HF_TOKEN", raising=False)
    monkeypatch.delenv("MWX_ALLOW_RANDOM_WEIGHTS", raising=False)

    outs = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        _wav_fixture(d / "meeting.wav")
        assert cli.main(["meeting.wav"]) == 0
        outs[name] = _markdown_without_run_lines(d / "meeting_transcript.md")
        assert (d / "meeting_transcript.json").exists()
    printed = capsys.readouterr().out
    # the registry is empty: both CLIs fall back to segment timestamps with
    # the same lines, and skip diarization without HF_TOKEN
    assert "尚未移植" not in printed
    assert printed.count("⚠️ 对齐失败: alignment checkpoint not found") == 2
    assert printed.count("   保留 VAD 段级时间戳继续。") == 2
    assert printed.count("⚠️ 未设置 HF_TOKEN，跳过说话人分离。") == 2
    assert outs["port"] == outs["jax"]
    assert any(ln.startswith("[00:00:") for ln in outs["port"])


def test_cli_forwards_ckv_scale(tmp_path, monkeypatch):
    """MWX_CKV_SCALE=bf16 reaches asr_options as ckv_scale_bf16, as in the
    JAX CLI."""
    import manual_whisper_tpu_torch.cli as tcli
    seen = []

    class _Model:
        def transcribe(self, audio, batch_size, language):
            return {"segments": [], "language": language}

    def fake_load(name, device, compute_type, language, asr_options,
                  vad_options):
        seen.append(asr_options["ckv_scale_bf16"])
        return _Model()

    monkeypatch.setattr(tcli, "load_model", fake_load)
    monkeypatch.setattr(tcli, "resolve_device",
                        lambda device: torch.device("cpu"))
    _wav_fixture(tmp_path / "a.wav")
    for value in ("bf16", "f32"):
        monkeypatch.setenv("MWX_CKV_SCALE", value)
        tcli.transcribe_audio(str(tmp_path / "a.wav"), model_size="test")
    assert seen == [True, False]


def test_cli_refuses_non_wav_and_missing_file(tmp_path, monkeypatch, capsys):
    """A missing file, and a suffix no decoder of the host takes (no
    ffmpeg CLI, no FFmpeg shim), stop the CLI before the model loads."""
    import manual_whisper_tpu_torch.cli as tcli
    from manual_whisper_tpu_torch.audio import native as tnative
    monkeypatch.setattr(tcli.shutil, "which", lambda name: None)
    monkeypatch.setattr(tnative, "get_ffdec", lambda *a, **k: None)
    monkeypatch.setattr(tcli, "load_model", None)   # never reached
    monkeypatch.chdir(tmp_path)
    assert tcli.main(["nope.wav"]) == 1
    (tmp_path / "a.m4a").write_bytes(b"x")
    assert tcli.main(["a.m4a"]) == 1
    out = capsys.readouterr().out
    assert "❌ 文件不存在" in out and "无法解码 .m4a" in out


def test_decoder_cache_evicts_least_recently_used(synth):
    """The decoder cache keeps 8 decoders and evicts the least recently
    used, as the JAX pipeline does: ``("zh", 0.0)``, seven other prompts,
    ``("zh", 0.0)`` again (a hit moves it to the end), then a ninth key
    evicts the first prompt's decoder and keeps the first decoder."""
    jm = JPipeline(synth, JCONFIGS["test"], j_tokenizer(), asr_options=OPTS,
                   language="en")
    tm = _port_model(synth, asr_options=OPTS, language="en")

    def run(model):
        first = model._decoder("zh", 0.0)
        for i in range(7):
            model._decoder("zh", 0.0, initial_prompt=f"prompt {i}")
        hit = model._decoder("zh", 0.0)
        model._decoder("zh", 0.0, initial_prompt="a ninth key")
        kept = model._decoder("zh", 0.0)
        prompts = [key[2] for key in model._decoders]
        return hit is first, kept is first, prompts

    port, jax_ = run(tm), run(jm)
    assert port == jax_
    assert port[:2] == (True, True)
    assert port[2] == [f"prompt {i}" for i in range(1, 7)] + [
        "a ninth key", None]
