"""CPU tests of the plain references in ``benchmark/reference`` against the
port at a small configuration: they agree in float32, and the comparisons
the benchmark makes see a lower precision.

    python -m pytest benchmark/test_bench_reference.py -q
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

from harness import audio as audio_mod  # noqa: E402
from harness import weights  # noqa: E402
from reference import pyannet_ref, tokens_ref, whisper_ref  # noqa: E402

TINY = {"name": "tiny.test", "d_model": 64, "encoder_layers": 2,
        "decoder_layers": 2, "encoder_attention_heads": 2,
        "decoder_attention_heads": 2, "encoder_ffn_dim": 256,
        "decoder_ffn_dim": 256, "num_mel_bins": 80, "vocab_size": 2000,
        "max_source_positions": 150, "max_target_positions": 64,
        "num_languages": 100, "compute_type": "bfloat16"}
PROMPT = "中文会议讨论记录，保持原意与术语准确。"


def _port_cfg(dtype):
    from harness.main import whisper_config
    return whisper_config(TINY, dtype)


def _windows(n=2, seed=5):
    samples = TINY["max_source_positions"] * 2 * 160
    audio = audio_mod.synthetic_speech(n * samples / 16000, seed, "cpu")
    return torch.from_numpy(audio.reshape(n, samples).copy())


def _port_logits(params, cfg, windows, seq, first):
    """The port's own steps: int16 crossing, K1's plain version, the
    encoder, and a teacher-forced decoder pass."""
    from manual_whisper_tpu_torch.models.whisper import (decoder_forward,
                                                         encode)
    from manual_whisper_tpu_torch.ops.mel import log_mel_spectrogram
    pcm = (np.clip(windows.numpy() * 32768.0, -32768, 32767)
           .astype(np.int16).astype(np.float32) / 32768.0)
    mel = log_mel_spectrogram(torch.from_numpy(pcm), n_mels=cfg.n_mels)
    xa = encode(params, mel, cfg)
    toks = torch.tensor([seq[:-1]] * windows.shape[0])
    logits, _ = decoder_forward(params, toks, xa, cfg)
    return logits[:, first:].float()


def _sequence():
    prefix = tokens_ref.prefix(PROMPT, "zh", 256, 100,
                               TINY["max_target_positions"])
    rng = np.random.default_rng(3)
    served = list(rng.integers(0, 256, 20))
    return prefix, prefix + served


def test_mel_matches_port():
    from manual_whisper_tpu_torch.ops.mel import log_mel_spectrogram
    win = _windows()
    ref = whisper_ref.log_mel(win, 80)
    port = log_mel_spectrogram(win, n_mels=80)
    assert float((ref - port).abs().max()) < 1e-4


@pytest.mark.parametrize("seed", [1, 2])
def test_whisper_float32_matches_port(seed):
    w = weights.make_whisper(TINY, seed, "cpu", torch.float32)
    prefix, seq = _sequence()
    win = _windows(seed=seed)
    port = _port_logits(w, _port_cfg(torch.float32), win, seq,
                        len(prefix) - 1)
    ref = torch.stack(whisper_ref.window_logits(w, TINY, win, [seq, seq],
                                                len(prefix) - 1))
    assert float((port - ref).abs().max()) < 2e-4


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def test_bfloat16_reads_far_off():
    """The port computing in bf16 sits well away from the float32
    reference: the gap the check reads grows by orders of magnitude."""
    w16 = weights.make_whisper(TINY, 4, "cpu", torch.bfloat16)
    prefix, seq = _sequence()
    win = _windows(seed=4)
    ref = torch.stack(whisper_ref.window_logits(w16, TINY, win, [seq, seq],
                                                len(prefix) - 1))
    f32 = _port_logits(_cast(w16, torch.float32), _port_cfg(torch.float32),
                       win, seq, len(prefix) - 1)
    bf16 = _port_logits(w16, _port_cfg(torch.bfloat16), win, seq,
                        len(prefix) - 1)
    gap32 = float((f32 - ref).abs().max())
    gap16 = float((bf16 - ref).abs().max())
    assert gap32 < 2e-4 and gap16 > 20 * gap32


def test_weights_same_seed_same_values():
    a = weights.make_whisper(TINY, 9, "cpu")
    b = weights.make_whisper(TINY, 9, "cpu")
    c = weights.make_whisper(TINY, 10, "cpu")
    for x, y, z in ((a["decoder"]["tok_emb"], b["decoder"]["tok_emb"],
                     c["decoder"]["tok_emb"]),
                    (a["encoder"]["blocks"][1]["mlp"]["fc2_w"],
                     b["encoder"]["blocks"][1]["mlp"]["fc2_w"],
                     c["encoder"]["blocks"][1]["mlp"]["fc2_w"])):
        assert torch.equal(x, y) and not torch.equal(x, z)
    assert weights.n_params(TINY) > 0


def _port_vad():
    from manual_whisper_tpu_torch.convert import from_jax_pyannet
    from manual_whisper_tpu_torch.from_hf import load_params
    tree = load_params(ROOT / ".weights" / "pyannote-segmentation-3.0" / "jax")
    return from_jax_pyannet(tree, torch.device("cpu"))


def test_pyannet_matches_port():
    from manual_whisper_tpu_torch.models.vad import VoiceActivityDetector
    audio = audio_mod.synthetic_speech(35.0, 8, "cpu")
    ref = pyannet_ref.load(str(ROOT / ".weights" / "pyannote-segmentation-3.0"
                               / "pytorch_model.bin"), "cpu")
    probs, frame = pyannet_ref.speech_probs(ref, audio, "cpu")
    port_probs, port_frame = VoiceActivityDetector(
        _port_vad()).speech_probs(audio)
    assert frame == port_frame and len(probs) == len(port_probs)
    assert float(np.abs(probs - port_probs).max()) < 2e-3
    # a network in bf16 reads far off
    bf = pyannet_ref.PyanNetRef({k: v.to(torch.bfloat16).float()
                                 for k, v in ref.sd.items()})
    bf.lstm = ref.lstm
    bf_probs, _ = pyannet_ref.speech_probs(bf, audio, "cpu")
    assert float(np.abs(bf_probs - port_probs).max()) > 2e-2


def test_windows_follow_port_chunking():
    from manual_whisper_tpu_torch.models.vad import binarize
    from manual_whisper_tpu_torch.pipeline.chunking import merge_chunks
    rng = np.random.default_rng(0)
    probs = np.clip(np.convolve(rng.random(6000), np.ones(40) / 40, "same")
                    * 1.6 - 0.3, 0, 1).astype(np.float32)
    frame = 10.0 / 589
    dur = len(probs) * frame
    port = [(c.start, c.end) for c in merge_chunks(
        [(max(0.0, s), min(dur, e)) for s, e in binarize(probs, frame)],
        30.0)]
    assert pyannet_ref.windows_of(probs, frame, dur, 30.0) == port
    assert len(port) > 2


def test_token_rules_match_port():
    from manual_whisper_tpu_torch.models.decode import (
        DecodingOptions, build_blank_mask, build_suppress_mask)
    from manual_whisper_tpu_torch.tokenizer import make_test_tokenizer
    cfg = _port_cfg(torch.bfloat16)
    tk = make_test_tokenizer(100)
    opts = DecodingOptions(language="zh", initial_prompt=PROMPT)
    steps = np.isfinite(build_suppress_mask(tk, cfg, opts))
    first = steps & np.isfinite(build_blank_mask(tk, cfg))
    assert (tokens_ref.allowed(2000, 256, False) == steps).all()
    assert (tokens_ref.allowed(2000, 256, True) == first).all()
    sp = tokens_ref.specials(256, 100)
    assert all(sp[k] == getattr(tk.special, k) for k in sp)
    prompt = tk.prompt_sequence(PROMPT, max_len=TINY["max_target_positions"]
                                // 2 - 1)
    assert tokens_ref.prefix(PROMPT, "zh", 256, 100, 64) == (
        prompt + tk.sot_sequence("zh", "transcribe", True))


def test_speech_generator_is_seeded():
    a = audio_mod.synthetic_speech(12.0, 21, "cpu")
    b = audio_mod.synthetic_speech(12.0, 21, "cpu")
    c = audio_mod.synthetic_speech(12.0, 22, "cpu")
    assert a.shape == (12 * 16000,) and np.array_equal(a, b)
    assert not np.array_equal(a, c)


if os.environ.get("MWX_WEIGHTS_DIR") is None:
    os.environ["MWX_WEIGHTS_DIR"] = str(ROOT / ".weights")
