"""PyTorch port: greedy decoding and the fallback ladder vs the JAX package.

At temperature 0 the port must give JAX's tokens exactly, and the same
lengths and avg_logprob to 1e-4 (float32 on both sides).  At T > 0 the two
draw different random numbers, so the port is held to determinism per
seed instead.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from manual_whisper_tpu.convert.from_hf import load_params
from manual_whisper_tpu.models import decode as jd
from manual_whisper_tpu.models import whisper as jw
from manual_whisper_tpu.ops.quant import quantize_params
from manual_whisper_tpu.tokenizer import make_test_tokenizer as j_tokenizer
from manual_whisper_tpu_torch.convert import from_jax_tree
from manual_whisper_tpu_torch.models import decode as td
from manual_whisper_tpu_torch.models import whisper as tw
from manual_whisper_tpu_torch.tokenizer import make_test_tokenizer

CPU = torch.device("cpu")
JCFG = jw.MODEL_CONFIGS["test"]
TCFG = tw.MODEL_CONFIGS["test"]


@pytest.fixture(scope="module")
def synth():
    params = load_params(".synth_ckpt")
    if params is None:
        pytest.skip("no committed synth checkpoint")
    return params, from_jax_tree(params, TCFG, CPU)


def _xa(jparams, seed=0, batch=3):
    """Encoder states of seeded synthetic speech, computed once by JAX and
    fed to both decoders."""
    from manual_whisper_tpu.eval.synth import render_utterance
    from manual_whisper_tpu.ops.mel import log_mel_spectrogram
    window = JCFG.n_audio_ctx * 2 * 160
    rows = np.zeros((batch, window), np.float32)
    for i, words in enumerate((["bo", "ta", "ki"], ["sa", "la"],
                               ["mi", "ke", "ho", "pe"])[:batch]):
        wav = render_utterance(words, seed=seed + i)[:window - 1600]
        rows[i, 1600:1600 + len(wav)] = wav
    mel = log_mel_spectrogram(rows, n_mels=JCFG.n_mels)
    return np.array(jw.encode(jparams, mel, JCFG))


def _opts(**kw):
    base = dict(language="en", max_new_tokens=40, suppress_blank=False)
    base.update(kw)
    return base


def test_masks_match_jax():
    tk, jtk = make_test_tokenizer(), j_tokenizer()
    for kw in ({}, {"suppress_non_speech": False}, {"suppress_tokens": (5,)}):
        np.testing.assert_array_equal(
            td.build_suppress_mask(tk, TCFG, td.DecodingOptions(**kw)),
            jd.build_suppress_mask(jtk, JCFG, jd.DecodingOptions(**kw)))
    np.testing.assert_array_equal(td.build_blank_mask(tk, TCFG),
                                  jd.build_blank_mask(jtk, JCFG))


def test_greedy_tokens_lengths_logprob_match_jax(synth):
    jparams, tparams = synth
    xa = _xa(jparams)
    jdec = jd.BatchDecoder(jparams, JCFG, j_tokenizer(),
                           jd.DecodingOptions(**_opts()))
    tdec = td.BatchDecoder(tparams, TCFG, make_test_tokenizer(),
                           td.DecodingOptions(**_opts()), CPU)
    jout = jax.device_get(jdec.decode_submit(jnp.asarray(xa), 0.0))
    tout = tdec.decode_submit(torch.from_numpy(xa), 0.0)
    np.testing.assert_array_equal(tout.tokens.numpy(), jout[0])
    np.testing.assert_array_equal(tout.lengths.numpy(), jout[2])
    np.testing.assert_allclose(tout.sum_logprob.numpy(), jout[1], atol=1e-4)
    np.testing.assert_allclose(tout.no_speech.numpy(), jout[3], atol=1e-5)

    jres = jdec.decode(jnp.asarray(xa))
    tres = tdec.decode(torch.from_numpy(xa))
    assert [r.text for r in tres] == [r.text for r in jres]
    assert any(r.text for r in tres)
    for a, b in zip(tres, jres):
        assert a.tokens == b.tokens
        assert abs(a.avg_logprob - b.avg_logprob) < 1e-4


def test_prompted_greedy_matches_jax(synth):
    """With an initial prompt (the CLI's case): the prefix and SOT index."""
    jparams, tparams = synth
    xa = _xa(jparams, seed=5, batch=2)
    o = _opts(initial_prompt="bo ta")
    jres = jd.BatchDecoder(jparams, JCFG, j_tokenizer(),
                           jd.DecodingOptions(**o)).decode(jnp.asarray(xa))
    tres = td.BatchDecoder(tparams, TCFG, make_test_tokenizer(),
                           td.DecodingOptions(**o), CPU).decode(
        torch.from_numpy(xa))
    for a, b in zip(tres, jres):
        assert a.tokens == b.tokens
        assert abs(a.avg_logprob - b.avg_logprob) < 1e-4
        assert abs(a.no_speech_prob - b.no_speech_prob) < 1e-5


def test_sampling_is_deterministic_per_seed():
    params = tw.init_params(TCFG, CPU, seed=3)
    xa = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, TCFG.n_audio_ctx, 64)).astype(np.float32))

    def run(seed, tag):
        dec = td.BatchDecoder(params, TCFG, make_test_tokenizer(),
                              td.DecodingOptions(**_opts(seed=seed)), CPU)
        return dec.decode_submit(xa, 1.0, rng_tag=tag).tokens

    a, b = run(0, 1), run(0, 1)
    assert torch.equal(a, b)
    assert not torch.equal(a, run(1, 1))
    assert not torch.equal(a, run(0, 2))


class _Scripted(td.BatchDecoder):
    """Decoder whose results are scripted per row id (xa[i, 0, 0]) and
    temperature, recording every dispatch."""

    def __init__(self, fail):
        super().__init__(None, TCFG, make_test_tokenizer(),
                         td.DecodingOptions(**_opts()), CPU)
        self.fail = fail
        self.calls = []

    def decode_submit(self, xa, temperature=0.0, rng_tag=0):
        self.calls.append(([int(r) for r in xa[:, 0, 0]], temperature,
                           rng_tag))
        return xa

    def decode_finalize(self, out, b, temperature=0.0):
        return [td.SegmentResult(
            tokens=[], text=f"row{int(out[i, 0, 0])}",
            avg_logprob=-5.0 if int(out[i, 0, 0]) in self.fail.get(
                temperature, ()) else -0.1,
            no_speech_prob=0.0, compression_ratio=1.0,
            temperature=temperature) for i in range(b)]


def test_fallback_retries_only_failing_rows_in_buckets():
    dec = _Scripted({0.0: {1, 4, 6, 7}, 0.2: {4}})
    xa = torch.zeros(8, 3, 4)
    xa[:, 0, 0] = torch.arange(8)
    res = dec.decode_with_fallback(xa, n_valid=7, rng_tag=2)
    # row 7 is padding (n_valid=7): never retried
    assert dec.calls == [(list(range(8)), 0.0, 32),
                         ([1, 4, 6, 1], 0.2, 33),   # 3 rows -> bucket 4
                         ([4], 0.4, 34)]            # 1 row -> bucket 1
    temps = [r.temperature for r in res]
    assert temps == [0.0, 0.2, 0.0, 0.0, 0.4, 0.0, 0.2, 0.0]
    assert [r.text for r in res][:7] == [f"row{i}" for i in range(7)]
    assert dec.stats["rung_rows"] == {0: 8, 1: 4, 2: 1}


def test_fallback_stops_when_all_pass():
    dec = _Scripted({})
    xa = torch.zeros(4, 3, 4)
    dec.decode_with_fallback(xa)
    assert len(dec.calls) == 1


@pytest.mark.parametrize("kw", [{"beam_size": 5},
                                {"without_timestamps": False},
                                {"int8_cross_kv": True}])
def test_unported_modes_raise(kw):
    """Beam, timestamp and int8-cross-K/V decoding are ported: each builds
    a decoder that carries its option (the name predates their port)."""
    dec = td.BatchDecoder(None, TCFG, make_test_tokenizer(),
                          td.DecodingOptions(**kw), CPU)
    for name, value in kw.items():
        assert getattr(dec.opts, name) == value
    assert not dec.opts.ckv_scale_bf16 and dec.opts.length_penalty == 1.0
    assert not dec._loops and not dec._beam_loops and not dec._ts_loops


@pytest.mark.parametrize("ckv_scale_bf16", [False, True])
def test_int8_greedy_matches_jax(synth, ckv_scale_bf16):
    """int8 weights (quantize_params of .synth_ckpt) and int8 cross K/V at
    float32 activations: JAX's greedy tokens and lengths exactly, summed
    logprobs within 1e-4, for f32 and bf16 cross-K/V scales."""
    jparams = quantize_params(synth[0])
    tparams = from_jax_tree(jparams, TCFG, CPU)
    xa = _xa(jparams, seed=2)
    o = _opts(int8_cross_kv=True, ckv_scale_bf16=ckv_scale_bf16)
    jdec = jd.BatchDecoder(jparams, JCFG, j_tokenizer(),
                           jd.DecodingOptions(**o))
    tdec = td.BatchDecoder(tparams, TCFG, make_test_tokenizer(),
                           td.DecodingOptions(**o), CPU)
    jout = jax.device_get(jdec.decode_submit(jnp.asarray(xa), 0.0))
    tout = tdec.decode_submit(torch.from_numpy(xa), 0.0)
    np.testing.assert_array_equal(tout.tokens.numpy(), jout[0])
    np.testing.assert_array_equal(tout.lengths.numpy(), jout[2])
    np.testing.assert_allclose(tout.sum_logprob.numpy(), jout[1], atol=1e-4)
    np.testing.assert_allclose(tout.no_speech.numpy(), jout[3], atol=1e-5)
    assert tdec.stats["decode_calls"] == 1
    assert tdec.stats["decode_steps"] == tout.steps - 1
