"""PyTorch port: beam search vs the JAX package's ``beam_decode_jit``.

At float32 on the ``test`` config, the port's ``BeamLoop`` (run eagerly
here: the chunks a CUDA graph captures on the card) must give JAX's
tokens and lengths exactly and its summed logprobs within 1e-4, with
.synth_ckpt and with seeded random weights, at beam 3 and 5, batch 1 and
2, with float cross K/V, int8 cross K/V (f32 and bf16 scales) and int8
weights.  Scripted logits hold the port's own step to the JAX outcome
where a finished hypothesis is evicted from the beam and where top-k
candidates tie.  ``length_penalty`` reaches the port's ``norm_score``
through ``asr_options``; ``decode_with_fallback`` and the pipeline give
JAX's results with beam at the first rung.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from manual_whisper_tpu.convert.from_hf import load_params
from manual_whisper_tpu.models import beam as jbeam
from manual_whisper_tpu.models import decode as jd
from manual_whisper_tpu.models import whisper as jw
from manual_whisper_tpu.ops.quant import quantize_params
from manual_whisper_tpu.pipeline.transcribe import \
    TranscribePipeline as JPipeline
from manual_whisper_tpu.tokenizer import make_test_tokenizer as j_tokenizer
from manual_whisper_tpu_torch.convert import from_jax_tree
from manual_whisper_tpu_torch.models import beam as tbeam
from manual_whisper_tpu_torch.models import decode as td
from manual_whisper_tpu_torch.models import whisper as tw
from manual_whisper_tpu_torch.tokenizer import make_test_tokenizer

from test_torch_decode import _xa
from test_torch_pipeline import _keys, _port_model, _synth_file

CPU = torch.device("cpu")
JCFG = jw.MODEL_CONFIGS["test"]
TCFG = tw.MODEL_CONFIGS["test"]
EOT = make_test_tokenizer().special.eot
OPTS = {"max_new_tokens": 40, "suppress_blank": False}


@pytest.fixture(scope="module")
def synth():
    params = load_params(".synth_ckpt")
    if params is None:
        pytest.skip("no committed synth checkpoint")
    return params


def _weights(synth, which: str, int8: bool):
    params = (synth if which == "synth"
              else jw.init_params(jax.random.PRNGKey(3), JCFG))
    return quantize_params(params) if int8 else params


def _decoders(jparams, **kw):
    o = dict(language="en", suppress_blank=False, **kw)
    return (jd.BatchDecoder(jparams, JCFG, j_tokenizer(),
                            jd.DecodingOptions(**o)),
            td.BatchDecoder(from_jax_tree(jparams, TCFG, CPU), TCFG,
                            make_test_tokenizer(), td.DecodingOptions(**o),
                            CPU))


CROSS = {"float_ckv": {}, "int8_ckv_f32": {"int8_cross_kv": True},
         "int8_ckv_bf16": {"int8_cross_kv": True, "ckv_scale_bf16": True},
         "int8_weights": {"int8_cross_kv": True}}


@pytest.mark.parametrize("weights,beam,batch,kind", [
    ("synth", 3, 2, "float_ckv"), ("synth", 5, 1, "float_ckv"),
    ("synth", 5, 2, "int8_ckv_f32"), ("synth", 3, 1, "int8_ckv_bf16"),
    ("synth", 5, 2, "int8_weights"), ("seeded", 3, 2, "float_ckv"),
    ("seeded", 5, 1, "int8_ckv_bf16"), ("seeded", 3, 2, "int8_weights")])
def test_beam_matches_jax(synth, weights, beam, batch, kind):
    """Tokens and lengths exact, summed logprobs within 1e-4, no-speech
    probability within 1e-5.  The synth model ends its rows early; random
    weights run every hypothesis to the token budget."""
    jparams = _weights(synth, weights, kind == "int8_weights")
    jdec, tdec = _decoders(jparams, beam_size=beam,
                           max_new_tokens=40 if weights == "synth" else 14,
                           **CROSS[kind])
    xa = _xa(jparams, seed=4, batch=batch)
    jout = jax.device_get(jdec.decode_submit(jnp.asarray(xa), 0.0))
    tout = tdec.decode_submit(torch.from_numpy(xa), 0.0)
    np.testing.assert_array_equal(tout.tokens.numpy(), jout[0])
    np.testing.assert_array_equal(tout.lengths.numpy(), jout[2])
    np.testing.assert_allclose(tout.sum_logprob.numpy(), jout[1], atol=1e-4)
    np.testing.assert_allclose(tout.no_speech.numpy(), jout[3], atol=1e-5)
    assert tdec.stats["beam_calls"] == tdec.stats["decode_calls"] == 1
    assert tdec.stats["beam_steps"] == tout.steps - 1
    assert tdec.stats["decode_steps"] == 0 and not tdec._loops
    assert tdec.stats["token_rows"] == batch * beam * tout.steps


def test_top_k_breaks_ties_as_jax():
    """``top_k`` against ``jax.lax.top_k`` on rows full of ties: equal
    values, -0.0 and 0.0 (which JAX orders as a total order does), -inf,
    NEG_INF and tiny gaps."""
    rng = np.random.default_rng(0)
    x = rng.choice(np.float32([-np.inf, -1e30, -20.0, -3.5, -0.0, 0.0,
                               np.nextafter(np.float32(-3.5), 0)]),
                   size=(6, 257)).astype(np.float32)
    x[0] = -20.0
    for k in (1, 3, 5, 9):
        vals, idx = tbeam.top_k(torch.from_numpy(x), k)
        jvals, jidx = jax.device_get(jax.lax.top_k(jnp.asarray(x), k))
        np.testing.assert_array_equal(idx.numpy(), jidx)
        np.testing.assert_array_equal(vals.numpy(), jvals)


def _scripted(monkeypatch, first_row, step_rows):
    """Replace the decoder of both packages' beam searches by scripted
    logits: ``first_row`` [V] after the prompt; ``step_rows(token, pos)``
    per beam step in numpy, the same for both."""
    V = first_row.shape[0]

    def j_forward(params_, tokens, xa_, cfg_, pos_offset=0, kv_cache=None,
                  cross_kv=None):
        logits = jnp.full((tokens.shape[0], tokens.shape[1], V), -20.0)
        return logits.at[:, -1, :].set(jnp.asarray(first_row)), kv_cache

    def j_step(params_, cfg_, token, pos, cache, cross_kv, oh):
        return step_rows(token, pos, jnp), cache

    def t_forward(params_, tokens, xa_, cfg_, pos_offset=0, kv_cache=None,
                  cross_kv=None, group=None):
        logits = torch.full((tokens.shape[0], tokens.shape[1], V), -20.0)
        logits[:, -1, :] = torch.from_numpy(first_row)
        return logits, kv_cache

    def t_step(params_, cfg_, token, pos, cache, cross_kv, oh, valid,
               tok_emb_f32, group=None):
        return step_rows(token, pos, torch)

    monkeypatch.setattr(jbeam, "decoder_forward", j_forward)
    monkeypatch.setattr(jbeam, "_beam_step", j_step)
    monkeypatch.setattr(tbeam, "decoder_forward", t_forward)
    monkeypatch.setattr(tbeam, "beam_step", t_step)


def _run_both(synth, beams, max_new):
    """Both searches over zero masks; ``max_new`` is unique to the
    scripted tests, so JAX traces the stubs afresh."""
    tk = make_test_tokenizer()
    prefix = np.asarray(tk.sot_sequence("zh", "transcribe"), np.int32)
    V = JCFG.n_vocab
    xa = _xa(synth, seed=0, batch=2)
    zero = jnp.zeros(V, jnp.float32)
    jout = jax.device_get(jbeam.beam_decode_jit(
        synth, jnp.asarray(xa), jnp.asarray(prefix), zero, zero, EOT, JCFG,
        max_new, beams, sot_index=0, no_speech_token=tk.special.no_speech))
    loop = tbeam.BeamLoop(from_jax_tree(synth, TCFG, CPU), TCFG, 2, beams,
                          xa.shape[1], len(prefix), max_new, False,
                          torch.float32, torch.zeros(V), EOT, 1.0, CPU)
    tout = loop.run(torch.from_numpy(xa), prefix.tolist(), torch.zeros(V))
    return jout, tout


def _logsm(row):
    m = row.max()
    return row - (m + np.log(np.exp(row - m).sum()))


def test_finished_hypothesis_survives_eviction(synth, monkeypatch):
    """JAX ``test_finished_hypothesis_survives_eviction`` on the port's own
    step: beam 3 (worst first token) takes EOT at step 1, beams 1-2 spawn
    higher raw continuations that push it out of the top-k, then every
    continuation collapses; the set-aside finished hypothesis must win,
    as in JAX."""
    V = JCFG.n_vocab
    A, B, C, NXT = 5, 6, 7, 8
    first_row = np.full(V, -20.0, np.float32)
    first_row[[A, B, C]] = 10.0, 9.5, 6.0
    good = np.full(V, -20.0, np.float32)
    good[[NXT, NXT + 1, EOT]] = 10.0, 9.0, -40.0
    end = np.full(V, -20.0, np.float32)
    end[EOT] = 10.0
    flat = np.full(V, -20.0, np.float32)
    flat[EOT] = -40.0
    p_holder = {}

    def step_rows(token, pos, xp):
        asarr = (xp.asarray if xp is jnp else torch.from_numpy)
        step1 = xp.where((token == C)[:, :, None], asarr(end)[None, None],
                         asarr(good)[None, None])
        later = xp.broadcast_to(asarr(flat), tuple(step1.shape))
        return xp.where(pos == p_holder["p"], step1, later)

    tk = make_test_tokenizer()
    p_holder["p"] = len(tk.sot_sequence("zh", "transcribe"))
    _scripted(monkeypatch, first_row, step_rows)
    jout, tout = _run_both(synth, beams=3, max_new=13)
    np.testing.assert_array_equal(tout.tokens.numpy(), jout[0])
    np.testing.assert_array_equal(tout.lengths.numpy(), jout[2])
    np.testing.assert_allclose(tout.sum_logprob.numpy(), jout[1], atol=1e-4)
    expected_lp = _logsm(first_row)[C] + _logsm(end)[EOT]
    for r in range(2):
        assert tout.tokens[r].tolist() == [C] + [EOT] * 12
        assert int(tout.lengths[r]) == 2
        assert abs(float(tout.sum_logprob[r]) - expected_lp) < 1e-3


def test_scripted_tie_matches_jax(synth, monkeypatch):
    """Every candidate ties: the first step's logits are flat but for two
    tokens, every later step's are flat but for EOT (never taken).  The
    top-k then decides by index alone, which JAX does lower index first
    (``torch.topk`` promises no order); the port must pick JAX's tokens."""
    V = JCFG.n_vocab
    first_row = np.full(V, -20.0, np.float32)
    first_row[[9, 300]] = -5.0
    flat = np.full(V, -7.0, np.float32)
    flat[EOT] = -60.0

    def step_rows(token, pos, xp):
        asarr = (xp.asarray if xp is jnp else torch.from_numpy)
        return xp.broadcast_to(asarr(flat), tuple(token.shape) + (V,))

    _scripted(monkeypatch, first_row, step_rows)
    jout, tout = _run_both(synth, beams=5, max_new=15)
    np.testing.assert_array_equal(tout.tokens.numpy(), jout[0])
    np.testing.assert_array_equal(tout.lengths.numpy(), jout[2])
    np.testing.assert_allclose(tout.sum_logprob.numpy(), jout[1], atol=1e-4)
    assert tout.tokens[0, :3].tolist() == [9, 0, 0]


def test_length_penalty_reaches_norm_score(synth, monkeypatch):
    """``asr_options={"length_penalty": ...}`` reaches the beam's
    ``norm_score`` in the port as in JAX (``DecodingOptions`` of both
    pipelines' decoders), and the beam at that penalty gives JAX's
    tokens."""
    opts = {**OPTS, "beam_size": 3, "length_penalty": 0.5}
    jm = JPipeline(synth, JCFG, j_tokenizer(), asr_options=opts,
                   language="en")
    tm = _port_model(synth, asr_options=opts, language="en")
    jdec, tdec = jm._decoder("en", 0.0), tm._decoder("en", 0.0)
    assert jdec.opts.length_penalty == tdec.opts.length_penalty == 0.5
    seen, norm_score = [], tbeam.norm_score

    def recording(cum, length, length_penalty):
        seen.append(length_penalty)
        return norm_score(cum, length, length_penalty)
    monkeypatch.setattr(tbeam, "norm_score", recording)
    xa = _xa(synth, seed=6, batch=2)
    tout = tdec.decode_submit(torch.from_numpy(xa), 0.0)
    jout = jax.device_get(jdec.decode_submit(jnp.asarray(xa), 0.0))
    assert seen and set(seen) == {0.5}
    np.testing.assert_array_equal(tout.tokens.numpy(), jout[0])
    np.testing.assert_array_equal(tout.lengths.numpy(), jout[2])


def test_fallback_with_beam_first_rung_matches_jax(synth):
    """``decode_with_fallback`` with beam 3 at the first rung: the rows
    that pass the gates keep the beam's tokens at T = 0, as in JAX; each
    row's temperature is JAX's.  A log-prob threshold between the rows'
    beam scores sends one row down the ladder (sampled rungs draw other
    random numbers than JAX, so only its temperature is compared)."""
    xa = _xa(synth, seed=0, batch=3)
    jdec, tdec = _decoders(synth, beam_size=3, max_new_tokens=40)
    first = tdec.decode(torch.from_numpy(xa))
    lps = sorted(r.avg_logprob for r in first)
    threshold = (lps[0] + lps[1]) / 2
    jdec, tdec = _decoders(synth, beam_size=3, max_new_tokens=40,
                           log_prob_threshold=threshold,
                           temperatures=(0.0, 0.2, 0.4))
    jres = jdec.decode_with_fallback(jnp.asarray(xa))
    tres = tdec.decode_with_fallback(torch.from_numpy(xa))
    assert [r.temperature for r in tres] == [r.temperature for r in jres]
    assert sum(r.temperature == 0.0 for r in tres) == 2
    for a, b in zip(tres, jres):
        if a.temperature == 0.0:
            assert a.tokens == b.tokens
            assert abs(a.avg_logprob - b.avg_logprob) < 1e-4
    assert tdec.stats["beam_calls"] == 1
    assert tdec.stats["decode_calls"] == 3     # the beam, then two rungs
    assert tdec.stats["rung_rows"] == {0: 3, 1: 1, 2: 1}


@pytest.mark.parametrize("seed,batch_size", [(123, 4), (7, 2)])
def test_pipeline_beam_segments_match_jax(synth, seed, batch_size):
    """The pipeline in beam mode (``asr_options={"beam_size": 5}``) on
    .synth_ckpt: JAX's segments exactly, and the same after ``warmup``
    (which builds each bucket's beam loop and greedy loop)."""
    audio, _ = _synth_file(seed)
    opts = {**OPTS, "beam_size": 5}
    jm = JPipeline(synth, JCFG, j_tokenizer(), asr_options=opts,
                   language="en")
    ref = jm.transcribe(audio, batch_size=batch_size, language="en")
    tm = _port_model(synth, asr_options=opts, language="en")
    got = tm.transcribe(audio, batch_size=batch_size, language="en")
    assert _keys(got["segments"]) == _keys(ref["segments"])
    assert got["segments"]
    stats = tm.last_stats
    assert stats["beam_calls"] == stats["batches"]
    tm.warmup(batch_size=batch_size, language="en")
    dec = tm._decoder("en", 0.0)
    assert sorted(k[0] for k in dec._beam_loops) == sorted(
        k[0] for k in dec._loops)
    again = tm.transcribe(audio, batch_size=batch_size, language="en")
    assert _keys(again["segments"]) == _keys(ref["segments"])
