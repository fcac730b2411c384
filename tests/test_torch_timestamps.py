"""PyTorch port: timestamp-token decoding vs the JAX package's
``greedy_timestamps_jit`` and ``split_segments_by_timestamps``.

At float32 on the ``test`` config the port's timestamp loop (a
``DecodeLoop`` with ``TimestampRules``, run eagerly here: the chunks a CUDA
graph captures on the card) must give JAX's tokens and lengths exactly
and its summed logprobs within 1e-4, with .synth_ckpt and seeded random
weights, float and int8 cross K/V (f32 and bf16 scales) and int8
weights.  Scripted logits hold the port's own step to JAX's outcome where
only the rules move a closing timestamp forward.  The segment split must
equal JAX's on cases and on Hypothesis token lists, and the pipeline in
timestamp mode JAX's segments.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

import chip_smoke
from manual_whisper_tpu.convert.from_hf import load_params
from manual_whisper_tpu.models import decode as jd
from manual_whisper_tpu.models import timestamps as jts
from manual_whisper_tpu.models import whisper as jw
from manual_whisper_tpu.ops.quant import quantize_params
from manual_whisper_tpu.pipeline.transcribe import \
    TranscribePipeline as JPipeline
from manual_whisper_tpu.tokenizer import make_test_tokenizer as j_tokenizer
from manual_whisper_tpu_torch.convert import from_jax_tree
from manual_whisper_tpu_torch.models import decode as td
from manual_whisper_tpu_torch.models import timestamps as tts
from manual_whisper_tpu_torch.models import whisper as tw
from manual_whisper_tpu_torch.tokenizer import make_test_tokenizer

from test_torch_decode import _xa
from test_torch_pipeline import _keys, _port_model, _synth_file

CPU = torch.device("cpu")
JCFG = jw.MODEL_CONFIGS["test"]
TCFG = tw.MODEL_CONFIGS["test"]
TK = make_test_tokenizer()
SP = TK.special
OPTS = {"max_new_tokens": 40, "suppress_blank": False,
        "without_timestamps": False}


@pytest.fixture(scope="module")
def synth():
    params = load_params(".synth_ckpt")
    if params is None:
        pytest.skip("no committed synth checkpoint")
    return params


KINDS = {"float_ckv": {}, "int8_ckv_f32": {"int8_cross_kv": True},
         "int8_ckv_bf16": {"int8_cross_kv": True, "ckv_scale_bf16": True},
         "int8_weights": {"int8_cross_kv": True}}


@pytest.mark.parametrize("weights,batch,kind", [
    ("synth", 1, "float_ckv"), ("synth", 2, "int8_ckv_f32"),
    ("synth", 3, "int8_ckv_bf16"), ("synth", 2, "int8_weights"),
    ("seeded", 2, "float_ckv"), ("seeded", 1, "int8_ckv_f32"),
    ("seeded", 2, "int8_weights")])
def test_timestamp_loop_matches_jax(synth, weights, batch, kind):
    """Tokens and lengths exact, summed logprobs within 1e-4; each row
    keeps the four rules (the host checker of ``chip_smoke.py``); the
    segments of ``decode_with_timestamps`` equal JAX's."""
    jparams = (synth if weights == "synth"
               else jw.init_params(jax.random.PRNGKey(5), JCFG))
    if kind == "int8_weights":
        jparams = quantize_params(jparams)
    o = dict(language="en", suppress_blank=False,
             max_new_tokens=40 if weights == "synth" else 14, **KINDS[kind])
    jdec = jd.BatchDecoder(jparams, JCFG, j_tokenizer(),
                           jd.DecodingOptions(**o))
    tdec = td.BatchDecoder(from_jax_tree(jparams, TCFG, CPU), TCFG, TK,
                           td.DecodingOptions(**o), CPU)
    xa = _xa(jparams, seed=7, batch=batch)
    jout = jax.device_get(jdec.timestamps_submit(jnp.asarray(xa)))
    tout = tdec.timestamps_submit(torch.from_numpy(xa))
    np.testing.assert_array_equal(tout.tokens.numpy(), jout[0])
    np.testing.assert_array_equal(tout.lengths.numpy(), jout[2])
    np.testing.assert_allclose(tout.sum_logprob.numpy(), jout[1], atol=1e-4)
    for row in tout.tokens.numpy():
        assert chip_smoke.timestamp_rule_violations(
            row, SP.timestamp_begin, SP.eot) == []
    assert tdec.stats["decode_calls"] == 1
    assert tdec.stats["decode_steps"] == tout.steps - 1
    assert list(tdec._ts_loops) == [(batch, xa.shape[1], 3, 40 if
                                     weights == "synth" else 14)]
    starts, durs = [2.0 * i for i in range(batch)], [3.0] * batch
    assert tdec.decode_with_timestamps(torch.from_numpy(xa), starts, durs) \
        == jdec.decode_with_timestamps(jnp.asarray(xa), starts, durs)


def test_closing_timestamp_strictly_increases(synth, monkeypatch):
    """JAX ``test_closing_timestamp_strictly_increases`` on the port's own
    step: scripted logits favour re-emitting the same timestamp; only the
    rules force each closing timestamp past its opener.  The port gives
    JAX's tokens."""
    V = JCFG.n_vocab
    txt = 7
    row = np.full(V, -20.0, np.float32)
    row[SP.timestamp_begin:] = 5.0 - 0.01 * np.arange(V - SP.timestamp_begin)
    row[txt] = 4.0
    row[SP.eot] = -30.0

    def j_forward(params_, tokens, xa_, cfg_, pos_offset=0, kv_cache=None,
                  cross_kv=None):
        return jnp.broadcast_to(jnp.asarray(row), tokens.shape + (V,)), \
            kv_cache

    def j_step(params_, last, pos, cache, cross_kv, cfg_, use_fused=False,
               cross_len=None):
        return jnp.broadcast_to(jnp.asarray(row), (last.shape[0], V)), cache

    def t_forward(params_, tokens, xa_, cfg_, pos_offset=0, kv_cache=None,
                  cross_kv=None, group=None):
        return torch.from_numpy(row).expand(*tokens.shape, V), kv_cache

    def t_step(params_, token, lengths, cache, cross_kv, cfg_, tok_emb_f32,
               group=None):
        return torch.from_numpy(row).expand(token.shape[0], V)

    monkeypatch.setattr(jts, "decoder_forward", j_forward)
    monkeypatch.setattr(jts, "decode_step", j_step)
    monkeypatch.setattr(td, "decoder_forward", t_forward)
    monkeypatch.setattr(td, "decode_step", t_step)
    prefix = TK.sot_sequence("zh", "transcribe", False)
    xa = _xa(synth, seed=0, batch=2)
    max_new = 11            # unique to this test: JAX traces the stubs
    zero = np.zeros(V, np.float32)
    jtok = jax.device_get(jts.greedy_timestamps_jit(
        synth, jnp.asarray(xa), jnp.asarray(np.int32(prefix)),
        jnp.asarray(zero), SP.eot, SP.timestamp_begin, JCFG, max_new))[0]
    rules = tts.TimestampRules(torch.from_numpy(zero), SP.eot,
                               SP.timestamp_begin, 2, CPU)
    loop = td.DecodeLoop(from_jax_tree(synth, TCFG, CPU), TCFG, 2,
                         xa.shape[1], len(prefix), max_new, False,
                         torch.float32, rules, SP.eot, CPU)
    tout = loop.run(torch.from_numpy(xa), prefix, 0.0)
    np.testing.assert_array_equal(tout.tokens.numpy(), jtok)
    for seq in tout.tokens.tolist():
        opens, closes = seq[0::3], seq[2::3]
        assert len(closes) >= 3
        for o, c in zip(opens, closes):
            assert SP.timestamp_begin <= o < c, seq
        assert chip_smoke.timestamp_rule_violations(
            seq, SP.timestamp_begin, SP.eot) == []


def test_rule_checker_finds_each_broken_rule():
    """The host checker names each rule a token row breaks."""
    t = TK.timestamp_token
    txt = TK.encode("hi")
    ok = [t(0.0)] + txt + [t(1.0), t(1.0)] + txt + [t(2.0), SP.eot]
    check = chip_smoke.timestamp_rule_violations

    def rules(seq):
        return {v.split(":")[0] for v in check(seq, SP.timestamp_begin,
                                               SP.eot)}
    assert check(ok, SP.timestamp_begin, SP.eot) == []
    assert rules(txt + [t(1.0), SP.eot]) == {"first"}
    assert rules([t(1.5)] + txt + [SP.eot]) == {"first"}
    assert rules([t(0.0)] + txt + [t(1.0), t(1.0), t(1.2)] + txt) == {"pairs"}
    assert rules([t(0.5)] + txt + [t(1.0), t(0.8)] + txt
                 + [t(0.9)]) == {"monotonic"}
    assert rules([t(0.5)] + txt + [t(0.5)]) == {"closing"}


@pytest.mark.parametrize("case", ["pairs", "unterminated", "empty"])
def test_split_segments_cases_match_jax(case):
    """The JAX package's cases: two pairs, an unterminated span, EOT only."""
    jtk = j_tokenizer()
    t = TK.timestamp_token
    tokens = {"pairs": [t(0.0)] + TK.encode("hi") + [t(1.0), t(1.5)]
              + TK.encode("yo") + [t(2.0), SP.eot],
              "unterminated": [t(0.5)] + TK.encode("end"),
              "empty": [SP.eot]}[case]
    got = tts.split_segments_by_timestamps(np.asarray(tokens), TK, 100.0,
                                           30.0)
    assert got == jts.split_segments_by_timestamps(np.asarray(tokens), jtk,
                                                   100.0, 30.0)
    if case == "pairs":
        assert got == [{"text": "hi", "start": 100.0, "end": 101.0},
                       {"text": "yo", "start": 101.5, "end": 102.0}]


@settings(max_examples=150, deadline=None)
@given(st.lists(st.one_of(st.integers(0, SP.eot - 1),
                          st.sampled_from([SP.eot]),
                          st.integers(SP.eot + 1, SP.timestamp_begin - 1),
                          st.integers(SP.timestamp_begin,
                                      SP.timestamp_begin + 1600)),
                max_size=40),
       st.floats(0.0, 600.0), st.floats(0.0, 30.0))
def test_split_segments_matches_jax_on_any_tokens(tokens, start, duration):
    """Any token list (text, EOT, specials, timestamps past the window),
    any start and duration: JAX's segments."""
    assert tts.split_segments_by_timestamps(
        np.asarray(tokens, np.int64), TK, start, duration) == \
        jts.split_segments_by_timestamps(np.asarray(tokens, np.int64),
                                         j_tokenizer(), start, duration)


@pytest.mark.parametrize("seed,batch_size", [(123, 4), (7, 2)])
def test_pipeline_timestamp_segments_match_jax(synth, seed, batch_size):
    """The pipeline in timestamp mode (``asr_options={"without_timestamps":
    False}``) on .synth_ckpt: JAX's segments exactly (sub-chunk times from
    the decoded pairs, padding rows dropped), also after ``warmup``, which
    builds one timestamp loop per bucket and no greedy loop."""
    audio, _ = _synth_file(seed)
    jm = JPipeline(synth, JCFG, j_tokenizer(), asr_options=OPTS,
                   language="en")
    ref = jm.transcribe(audio, batch_size=batch_size, language="en")
    tm = _port_model(synth, asr_options=OPTS, language="en")
    got = tm.transcribe(audio, batch_size=batch_size, language="en")
    assert _keys(got["segments"]) == _keys(ref["segments"])
    assert got["segments"]
    stats = tm.last_stats
    assert stats["decode_calls"] == stats["batches"]
    tm.warmup(batch_size=batch_size, language="en")
    dec = tm._decoder("en", 0.0)
    assert not dec._loops and not dec._beam_loops and dec._ts_loops
    again = tm.transcribe(audio, batch_size=batch_size, language="en")
    assert _keys(again["segments"]) == _keys(ref["segments"])
