"""PyTorch port: ``compute_type="float32"``, on the CPU.

On the card float32 runs through float32 builds of K2 (encoder flash
attention), K3 and K4 (decode attention), each with its own entry point and
kernel name (``flash_attention_f32``, ``decode_self_attention_f32``,
``decode_cross_attention_f32``); bf16 runs the bf16 builds.  Here:

- the wrappers' dtype rule (``_build.attention_dtype``: bf16 or float32, one
  dtype for q, k and v), and that a wrapper given tensors off the CPU calls
  the entry point of their dtype, counts that launch under its name and
  shape into the bound launch sink (``spans.count``; K1, K5 and K6 too),
  and raises, with no fallback, when the build or the launch fails
  (``meta`` tensors and a stand-in library take the card's place);
- ``load_model("test", device="cpu", compute_type="float32")`` on the
  synthetic test file: every tensor that reaches the K2-K4 wrappers is
  float32 (q, the self cache, the cross K/V and the output), and bf16 for
  ``bfloat16``;
- the port's float32 pipeline against the JAX package's
  ``load_model("test", compute_type="float32")`` on the same weights and
  file: each decoded row's greedy tokens and the segments equal.
"""

import collections

import jax
import numpy as np
import pytest
import torch

from manual_whisper_tpu.models import decode as jdecode
from manual_whisper_tpu.pipeline.transcribe import load_model as j_load_model
from manual_whisper_tpu_torch import spans
from manual_whisper_tpu_torch.eval.synth import (render_file_with_times,
                                                 sample_text)
from manual_whisper_tpu_torch.models import MODEL_CONFIGS
from manual_whisper_tpu_torch.models import decode as tdecode
from manual_whisper_tpu_torch.models import whisper as tw
from manual_whisper_tpu_torch.ops import _build, mel
from manual_whisper_tpu_torch.ops.attention import flash_attention
from manual_whisper_tpu_torch.ops.decode_attention import (
    decode_cross_attention, decode_cross_attention_int8,
    decode_self_attention)
from manual_whisper_tpu_torch.ops.quant import int8_matmul
from manual_whisper_tpu_torch.pipeline import load_model

# greedy with the ladder's gates off: no row climbs to a sampled rung,
# whose random numbers differ between the two packages
OPTS = {"max_new_tokens": 40, "suppress_blank": False,
        "log_prob_threshold": None, "compression_ratio_threshold": None}

BF16, F32 = torch.bfloat16, torch.float32


# -- the dtype rule ----------------------------------------------------------

@pytest.mark.parametrize("dtypes,suffix", [((BF16, BF16, BF16), ""),
                                           ((F32, F32, F32), "_f32")])
def test_attention_dtype_picks_the_build(dtypes, suffix):
    tensors = [torch.zeros(2, dtype=d) for d in dtypes]
    assert _build.attention_dtype("k", *tensors) == suffix


@pytest.mark.parametrize("dtypes,match", [
    ((torch.float16,) * 3, "bfloat16 or float32"),
    ((torch.float64,) * 3, "bfloat16 or float32"),
    ((F32, BF16, F32), "one dtype"),
    ((BF16, BF16, F32), "one dtype"),
    ((torch.float16, F32, F32), "one dtype")])
def test_attention_dtype_refuses_other_dtypes_and_mixes(dtypes, match):
    tensors = [torch.zeros(2, dtype=d) for d in dtypes]
    with pytest.raises(ValueError, match=match):
        _build.attention_dtype("k", *tensors)


# -- dispatch off the CPU: meta tensors and a stand-in library ---------------

class _Library:
    """Stands in for a built library: records each entry point called and
    returns ``err`` (a cudaError_t) from it; ``launches`` is the launch
    sink bound while a test runs."""

    def __init__(self, err=0):
        self.err = err
        self.called = []
        self.launches = collections.Counter()

    def __getattr__(self, symbol):
        if not symbol.startswith("mwx_"):
            raise AttributeError(symbol)

        def entry(*args):
            self.called.append(symbol)
            return self.err
        return entry


def _meta_call(wrapper, dtype):
    """One call of ``wrapper`` on meta tensors: the attention wrappers at
    the test config's head_dim 32, K1 on two rows of 1600 samples at 80
    mels, K6 at (M, K, N) = (3, 64, 32), K5 with float32 scales."""
    meta = torch.device("meta")
    length = torch.zeros(1, dtype=torch.int32, device=meta)
    if wrapper == "flash_attention":
        q = torch.empty((1, 2, 10, 32), dtype=dtype, device=meta)
        return flash_attention(q, q, q)
    if wrapper == "mel":
        audio = torch.empty((2, 1600), dtype=dtype, device=meta)
        return mel.unnormalized_log_mel(audio, 80)
    if wrapper == "int8_matmul":
        return int8_matmul(
            torch.empty((3, 64), dtype=dtype, device=meta),
            torch.empty((64, 32), dtype=torch.int8, device=meta),
            torch.empty((32,), dtype=F32, device=meta))
    q = torch.empty((1, 2, 1, 32), dtype=dtype, device=meta)
    if wrapper == "decode_cross_attention_int8":
        codes = torch.empty((1, 2, 24, 32), dtype=torch.int8, device=meta)
        scales = torch.empty((1, 2, 24), dtype=F32, device=meta)
        return decode_cross_attention_int8(q, codes, scales, codes, scales,
                                           length)
    kv = torch.empty((1, 2, 24, 32), dtype=dtype, device=meta)
    fn = {"decode_self_attention": decode_self_attention,
          "decode_cross_attention": decode_cross_attention}[wrapper]
    return fn(q, kv, kv, length)


ENTRY = {"flash_attention": "mwx_flash_attention",
         "decode_self_attention": "mwx_decode_attention",
         "decode_cross_attention": "mwx_decode_cross_attention"}

# each wrapper's launch: (wrapper, dtype, entry point, counted (kernel,
# shape)); K2-K4 in both builds, K1, K5 and K6 in the dtype they take
LAUNCHES = [
    *(pytest.param(wrapper, dtype, ENTRY[wrapper] + suffix,
                   (wrapper + suffix, shape), id=f"{wrapper}-{tag}")
      for wrapper, shape in (("flash_attention", (2, 10, 10, 32)),
                             ("decode_self_attention", (2, 24, 32)),
                             ("decode_cross_attention", (2, 24, 32)))
      for dtype, suffix, tag in ((BF16, "", "bf16"), (F32, "_f32", "f32"))),
    pytest.param("mel", F32, "mwx_log_mel", ("mel", (2, 1600, 80)),
                 id="mel-f32"),
    pytest.param("int8_matmul", BF16, "mwx_int8_matmul",
                 ("int8_matmul", (3, 64, 32)), id="int8_matmul-bf16"),
    pytest.param("decode_cross_attention_int8", BF16,
                 "mwx_decode_attention_int8",
                 ("decode_cross_attention_int8", (1, 2, 24, 32, "float32")),
                 id="decode_cross_attention_int8-bf16")]


@pytest.fixture
def stand_in(monkeypatch):
    """``_build.library`` returns one ``_Library`` (its ``err`` settable);
    the stream is 0; K1's packed DFT is two meta tensors; the library's
    ``launches`` is bound as the launch sink."""
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda name: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    folds = torch.empty(1, device="meta")
    monkeypatch.setattr(mel, "_kernel_folds", lambda device: (folds, folds))
    with spans.bind({}, "test", lib.launches):
        yield lib


@pytest.mark.parametrize("wrapper,dtype,symbol,row", LAUNCHES)
def test_wrapper_launches_the_build_of_its_dtype(stand_in, wrapper, dtype,
                                                 symbol, row):
    out = _meta_call(wrapper, dtype)
    assert out.dtype == dtype
    assert stand_in.called == [symbol]
    assert stand_in.launches == {row: 1}


@pytest.mark.parametrize("wrapper", list(ENTRY))
def test_wrapper_refuses_float16_before_any_launch(stand_in, wrapper):
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        _meta_call(wrapper, torch.float16)
    assert stand_in.called == [] and not stand_in.launches


@pytest.mark.parametrize("wrapper", list(ENTRY))
def test_failed_f32_launch_raises_and_is_not_counted(stand_in, wrapper):
    stand_in.err = 1
    with pytest.raises(RuntimeError, match="_f32 kernel"):
        _meta_call(wrapper, F32)
    assert stand_in.called == [ENTRY[wrapper] + "_f32"]
    assert not stand_in.launches


@pytest.mark.parametrize("wrapper", list(ENTRY))
def test_failed_f32_build_raises(monkeypatch, wrapper):
    """No nvcc here: the build's error reaches the caller; nothing falls
    back to the plain version or to the bf16 build."""
    def no_build(name):
        raise RuntimeError("CUDA kernel build failed")
    monkeypatch.setattr(_build, "library", no_build)
    with pytest.raises(RuntimeError, match="build failed"):
        _meta_call(wrapper, F32)


# -- the pipeline at float32 ---------------------------------------------------

def _synth_file(seed=123, n_utts=3):
    """The synthetic-speech file of ``test_torch_pipeline.py`` (3
    utterances, seed 123)."""
    rng = np.random.default_rng(seed)
    utts = [sample_text(rng, 4, 8) for _ in range(n_utts)]
    audio, _ = render_file_with_times(utts, seed=seed)
    return audio


def _recording(monkeypatch):
    """Wrap the K2-K4 wrappers where ``models.whisper`` calls them: each
    call's (wrapper, role, dtype) of q, k, v and the output."""
    seen = []

    def wrap(name, fn, k_role):
        def spy(q, k, v, *rest):
            out = fn(q, k, v, *rest)
            seen.extend([(name, "q", q.dtype), (name, k_role, k.dtype),
                         (name, k_role, v.dtype), (name, "out", out.dtype)])
            return out
        monkeypatch.setattr(tw, name, spy)
    wrap("flash_attention", tw.flash_attention, "k/v")
    wrap("decode_self_attention", tw.decode_self_attention, "self cache")
    wrap("decode_cross_attention", tw.decode_cross_attention, "cross K/V")
    return seen


@pytest.mark.parametrize("compute_type,dtype", [("float32", F32),
                                                ("bfloat16", BF16)])
def test_pipeline_hands_the_kernels_its_dtype(monkeypatch, compute_type,
                                              dtype):
    seen = _recording(monkeypatch)
    model = load_model("test", device="cpu", compute_type=compute_type,
                       asr_options=OPTS, language="en")
    assert model.cfg.dtype == dtype
    out = model.transcribe(_synth_file(), batch_size=4, language="en")
    assert isinstance(out["segments"], list)
    roles = {(name, role) for name, role, _ in seen}
    assert roles == {
        ("flash_attention", r) for r in ("q", "k/v", "out")} | {
        ("decode_self_attention", r) for r in ("q", "self cache", "out")} | {
        ("decode_cross_attention", r) for r in ("q", "cross K/V", "out")}
    wrong = {(name, role, d) for name, role, d in seen if d != dtype}
    assert not wrong
    stats = model.last_stats
    assert stats["decode_steps"] > 0 and stats["batches"] >= 1


def _decoded_rows(monkeypatch, module):
    """Every row ``module.BatchDecoder.decode_finalize`` builds: its tokens
    (EOT dropped)."""
    rows = []
    real = module.BatchDecoder.decode_finalize

    def spy(self, out, b, temperature=0.0):
        res = real(self, out, b, temperature)
        rows.extend(list(r.tokens) for r in res)
        return res
    monkeypatch.setattr(module.BatchDecoder, "decode_finalize", spy)
    return rows


def _keys(segments):
    return [(s["text"], s["start"], s["end"]) for s in segments]


@pytest.mark.parametrize("batch_size", [4, 2])
def test_f32_pipeline_equals_jax_load_model(monkeypatch, batch_size):
    """The JAX ``load_model("test", compute_type="float32")`` (its seeded
    weights) and the port's ``load_model`` of the same tree at float32 on
    the synthetic file: each decoded row's greedy tokens and the
    segments."""
    audio = _synth_file()
    jm = j_load_model("test", compute_type="float32", asr_options=OPTS,
                      language="en")
    assert jm.cfg.dtype == np.float32
    j_rows = _decoded_rows(monkeypatch, jdecode)
    ref = jm.transcribe(audio, batch_size=batch_size, language="en")
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    tm = load_model(tree, device="cpu", compute_type="float32",
                    cfg=MODEL_CONFIGS["test"], asr_options=OPTS,
                    language="en")
    assert tm.cfg.dtype == F32
    t_rows = _decoded_rows(monkeypatch, tdecode)
    out = tm.transcribe(audio, batch_size=batch_size, language="en")
    assert j_rows and t_rows == j_rows
    assert _keys(out["segments"]) == _keys(ref["segments"])
    assert out["segments"], "the file decodes to no segment"
