"""PyTorch port: the decode loop as chunks of steps over static buffers.

On the CPU the chunks (``decode_chunk``) run eagerly: the same code that a
CUDA graph captures on the card.  The chunked loop must give JAX
``greedy_decode_jit``'s tokens and lengths exactly and its summed
logprobs within 1e-4 (float32 on both sides), stop at the checks the
eager loop made (steps 1, 17, 33, ...), and leave nothing of one decode
in the static buffers that the next could read.  ``warmup`` must change
no segment.
"""

import math
import sys
import threading

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
from manual_whisper_tpu_torch.pipeline import load_model
from manual_whisper_tpu_torch.tokenizer import make_test_tokenizer

from test_torch_decode import _xa
from test_torch_pipeline import _keys, _synth_file

CPU = torch.device("cpu")
JCFG = jw.MODEL_CONFIGS["test"]
TCFG = tw.MODEL_CONFIGS["test"]
EOT = make_test_tokenizer().special.eot


@pytest.fixture(scope="module")
def synth():
    params = load_params(".synth_ckpt")
    if params is None:
        pytest.skip("no committed synth checkpoint")
    return params


def _opts(**kw):
    base = dict(language="en", max_new_tokens=40, suppress_blank=False)
    base.update(kw)
    return base


def _checked_steps(lengths: np.ndarray, max_new: int) -> int:
    """Steps the eager loop runs: it checks before steps 1, 17, 33, ...
    whether every row has finished, which happens after the step that
    writes the last row's EOT (slot ``lengths - 1``)."""
    every = td.FINISH_CHECK_EVERY
    done = int(lengths.max()) if lengths.max() < max_new else max_new
    return min(max_new, 1 + every * math.ceil((done - 1) / every)) - 1


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("to_the_end", [False, True],
                         ids=["early_eot", "eot_suppressed"])
@pytest.mark.parametrize("max_new_tokens", [33, 40])
def test_chunked_loop_matches_jax(synth, max_new_tokens, to_the_end, int8):
    """33 tokens: 32 steps, two whole chunks; 40: 39 steps, a 7-step last
    chunk.  The synth model ends every row early; with EOT suppressed
    every row runs to the token budget."""
    jparams = quantize_params(synth) if int8 else synth
    tparams = from_jax_tree(jparams, TCFG, CPU)
    xa = _xa(jparams, seed=3)
    o = _opts(max_new_tokens=max_new_tokens, int8_cross_kv=int8,
              suppress_tokens=(EOT,) if to_the_end else None)
    jdec = jd.BatchDecoder(jparams, JCFG, j_tokenizer(),
                           jd.DecodingOptions(**o))
    tdec = td.BatchDecoder(tparams, TCFG, make_test_tokenizer(),
                           td.DecodingOptions(**o), CPU)
    jout = jax.device_get(jdec.decode_submit(jnp.asarray(xa), 0.0))
    tout = tdec.decode_submit(torch.from_numpy(xa), 0.0)
    np.testing.assert_array_equal(tout.tokens.numpy(), jout[0])
    np.testing.assert_array_equal(tout.lengths.numpy(), jout[2])
    np.testing.assert_allclose(tout.sum_logprob.numpy(), jout[1], atol=1e-4)
    max_new = tout.tokens.shape[1]
    steps = _checked_steps(np.asarray(jout[2]), max_new)
    assert tdec.stats["decode_steps"] == tout.steps - 1 == steps
    assert tdec.stats["token_rows"] == xa.shape[0] * tout.steps
    if to_the_end:
        assert steps == max_new - 1
    else:
        assert steps < max_new - 1         # the early stop is exercised


@pytest.mark.parametrize("temperature", [0.0, 0.6])
def test_static_buffers_leak_nothing(synth, temperature):
    """Batch A (speech), then batch B (noise, which runs more steps and
    writes slots A never reaches; same shape, so the same static cache,
    tokens and finished buffers), then A again on one decoder: A's
    results are identical both times."""
    tparams = from_jax_tree(synth, TCFG, CPU)
    dec = td.BatchDecoder(tparams, TCFG, make_test_tokenizer(),
                          td.DecodingOptions(**_opts()), CPU)
    xa_a = torch.from_numpy(_xa(synth, seed=0, batch=2))
    xa_b = torch.from_numpy(np.random.default_rng(0).standard_normal(
        xa_a.shape).astype(np.float32))
    first = dec.decode_submit(xa_a, temperature, rng_tag=4)
    other = dec.decode_submit(xa_b, temperature, rng_tag=4)
    again = dec.decode_submit(xa_a, temperature, rng_tag=4)
    assert len(dec._loops) == 1
    assert other.steps > first.steps
    for name in ("tokens", "sum_logprob", "lengths", "no_speech"):
        assert torch.equal(getattr(first, name), getattr(again, name)), name
    assert first.steps == again.steps


def test_device_temperature_shares_one_loop(synth):
    """The temperature is a device scalar: every rung runs the one loop of
    its bucket, and one seed gives the same tokens twice."""
    tparams = from_jax_tree(synth, TCFG, CPU)
    dec = td.BatchDecoder(tparams, TCFG, make_test_tokenizer(),
                          td.DecodingOptions(**_opts()), CPU)
    xa = torch.from_numpy(_xa(synth, batch=2))
    runs = {t: [dec.decode_submit(xa, t, rng_tag=5).tokens for _ in range(2)]
            for t in (0.0, 0.2, 1.0)}
    assert len(dec._loops) == 1
    for t, (a, b) in runs.items():
        assert torch.equal(a, b), t
    assert not torch.equal(runs[0.0][0], runs[1.0][0])
    greedy = td.BatchDecoder(tparams, TCFG, make_test_tokenizer(),
                             td.DecodingOptions(**_opts()), CPU)
    assert torch.equal(greedy.decode_submit(xa, 0.0, rng_tag=99).tokens,
                       runs[0.0][0])


def test_warmup_changes_no_segment(synth):
    """``warmup`` on the CPU builds one decode loop per batch bucket (1, 2
    and 4 rows for batch 4); ``transcribe`` after it returns the segments
    of a model that was never warmed up."""
    opts = {"max_new_tokens": 40, "suppress_blank": False}
    audio, _ = _synth_file(123)

    def model():
        return load_model(synth, device="cpu", compute_type="float32",
                          cfg=tw.MODEL_CONFIGS["test"], asr_options=opts,
                          language="en")
    cold = model().transcribe(audio, batch_size=4, language="en")
    warm = model()
    progress = []
    warm.warmup(batch_size=4, language="en",
                progress_callback=lambda pct, msg: progress.append(pct))
    dec = warm._decoder("en", 0.0)
    assert sorted(key[0] for key in dec._loops) == [1, 2, 4]
    assert dec.stats["decode_calls"] == 3 and progress[-1] == 100.0
    out = warm.transcribe(audio, batch_size=4, language="en")
    assert _keys(out["segments"]) == _keys(cold["segments"])
    assert any(s["text"] for s in out["segments"])


def test_decode_step_reads_position_on_device(synth):
    """``decode_step`` takes its position only from ``StepLengths.pos``:
    two steps at positions held in one tensor, changed in place between
    them, write the cache slots they name and no other."""
    tparams = from_jax_tree(synth, TCFG, CPU)
    xa = torch.from_numpy(_xa(synth, batch=1))
    cross = tw.precompute_cross_kv(tparams, xa, TCFG)
    cache = tw.init_kv_cache(TCFG, 1, 8, CPU)
    pos = torch.tensor([3], dtype=torch.int32)
    step = tw.StepLengths(pos, torch.tensor([xa.shape[1]],
                                            dtype=torch.int32))
    emb32 = tparams["decoder"]["tok_emb"].float()
    for p in (3, 5):
        pos.fill_(p)
        tw.decode_step(tparams, torch.tensor([70]), step, cache, cross, TCFG,
                       emb32)
    written = cache[0][0].abs().sum(dim=(0, 1, 3)) > 0
    assert written.tolist() == [i in (3, 5) for i in range(8)]


def test_one_decode_at_a_time_on_the_static_buffers(synth):
    """Six threads decode on one decoder at once, with a short switch
    interval: each gets what it gets alone, so the lock keeps one decode
    at a time on the static buffers."""
    tparams = from_jax_tree(synth, TCFG, CPU)
    dec = td.BatchDecoder(tparams, TCFG, make_test_tokenizer(),
                          td.DecodingOptions(**_opts(max_new_tokens=20)),
                          CPU)
    xas = [torch.from_numpy(_xa(synth, seed=s, batch=3)[i:i + 2])
           for s, i in ((0, 0), (0, 1), (9, 0))]
    alone = [dec.decode_submit(xa, 0.6, rng_tag=k).tokens
             for k, xa in enumerate(xas)]
    got = {}

    def work(j):
        k = j % len(xas)
        got[j] = dec.decode_submit(xas[k], 0.6, rng_tag=k).tokens

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(j,)) for j in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for j in range(6):
        assert torch.equal(got[j], alone[j % len(xas)]), j
    assert dec.stats["decode_calls"] == 9
