"""PyTorch port: the decode step's fused bias + residual add + LayerNorm
(``ops/norm.py``, ``csrc/add_layer_norm.cu``), on the CPU.

- ``add_layer_norm_plain`` is the unfused sequence the decode step ran
  before the kernel (a bias add, a residual add, LayerNorm in float32 and
  the cast back), bit for bit, in bf16 and float32, with and without a
  delta and a bias;
- ``decode_step`` over several steps gives the same bits as a copy of that
  formula kept here, in bf16 and float32, with plain and int8 weights and
  with int8 cross K/V;
- off the CPU the wrapper calls the entry point of its dtype, counts the
  launch under its name and raises, with no fallback, on what the kernel
  does not take or when the launch fails (``meta`` tensors and a stand-in
  library take the card's place).

The kernel against this plain version on the card:
``tests/test_torch_cuda.py``.
"""

import collections

import pytest
import torch
import torch.nn.functional as F

from manual_whisper_tpu_torch.models import whisper as tw
from manual_whisper_tpu_torch.ops import _build
from manual_whisper_tpu_torch.ops.decode_attention import (
    decode_cross_attention, decode_cross_attention_int8,
    decode_self_attention)
from manual_whisper_tpu_torch.ops.norm import (add_layer_norm,
                                               add_layer_norm_plain)
from manual_whisper_tpu_torch.ops.quant import mm, quantize_params

BF16, F32 = torch.bfloat16, torch.float32
DTYPES = {"bf16": BF16, "f32": F32}


def _randn(shape, seed, dtype, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(shape, generator=g)).to(dtype)


def _unfused_layer_norm(x, g, b):
    """The decode step's LayerNorm before the kernel: x, gamma and beta
    cast to float32, ATen's LayerNorm, the cast back."""
    return F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(),
                        eps=1e-5).to(x.dtype)


# -- the plain version against the unfused sequence ---------------------------

@pytest.mark.parametrize("rows", [1, 5, 16])
@pytest.mark.parametrize("d", [64, 384, 1280])
@pytest.mark.parametrize("inputs", ["ln_only", "delta", "delta_bias"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_equals_the_unfused_sequence(dtype, inputs, d, rows):
    dt = DTYPES[dtype]
    h = _randn((rows, 1, d), 1, dt, 4.0)
    delta = _randn((rows, 1, d), 2, dt, 3.0) if inputs != "ln_only" else None
    bias = _randn((d,), 3, dt) if inputs == "delta_bias" else None
    g, b = _randn((d,), 4, dt) + 1, _randn((d,), 5, dt)
    h_new, y = add_layer_norm_plain(h, delta, bias, g, b)
    want = h
    if delta is not None:
        want = h + (delta + bias) if bias is not None else h + delta
    assert h_new.dtype == y.dtype == dt
    assert torch.equal(h_new, want)
    assert torch.equal(y, _unfused_layer_norm(want, g, b))
    if delta is None:
        assert h_new is h


def test_bf16_sums_round_where_two_adds_round():
    """delta + bias is rounded to bf16 before h is added: with h = bias =
    0.75 * 2^-8 and delta = 1 both bf16 adds round to 1, where one float32
    sum of the three would round to 1 + 2^-7."""
    h = torch.full((1, 8), 0.75 * 2.0 ** -8, dtype=BF16)
    delta = torch.ones((1, 8), dtype=BF16)
    bias = torch.full((8,), 0.75 * 2.0 ** -8, dtype=BF16)
    g, b = torch.ones(8, dtype=BF16), torch.zeros(8, dtype=BF16)
    h_new, _ = add_layer_norm_plain(h, delta, bias, g, b)
    assert torch.equal(h_new, torch.ones((1, 8), dtype=BF16))
    one_sum = (h.float() + delta.float() + bias.float()).to(BF16)
    assert torch.equal(one_sum, torch.full((1, 8), 1 + 2.0 ** -7, dtype=BF16))


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    h, delta = _randn((3, 1, 64), 6, BF16), _randn((3, 1, 64), 7, BF16)
    bias, g, b = (_randn((64,), s, BF16) for s in (8, 9, 10))
    before = collections.Counter(_build.launches)
    got = add_layer_norm(h, delta, bias, g, b)
    want = add_layer_norm_plain(h, delta, bias, g, b)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert _build.launches == before


# -- decode_step against the formula it had before the kernel ----------------

def _old_block(h, blk, n_head, self_k, self_v, xkv, step):
    """The decode step's block before ``add_layer_norm`` (no model group):
    separate bias and residual adds and LayerNorms."""
    def attn_out(heads, att):
        b, hh, t, dh = heads.shape
        merged = heads.transpose(1, 2).reshape(b, t, hh * dh)
        return mm(merged, att["o_w"]) + att["o_b"]

    def split(x):
        b, t, d = x.shape
        return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)

    def ln(x, p):
        return _unfused_layer_norm(x, p["g"], p["b"])

    att, xat, mlp = blk["attn"], blk["xattn"], blk["mlp"]
    q = split(mm(ln(h, blk["ln1"]), att["q_w"]) + att["q_b"])
    h = h + attn_out(decode_self_attention(q, self_k, self_v, step.pos), att)
    xq = split(mm(ln(h, blk["lnx"]), xat["q_w"]) + xat["q_b"])
    if len(xkv) == 2:
        xout = decode_cross_attention(xq, *xkv, step.cross_len)
    else:
        xout = decode_cross_attention_int8(xq, *xkv, step.cross_len)
    h = h + attn_out(xout, xat)
    f = F.gelu(mm(ln(h, blk["ln2"]), mlp["fc1_w"]) + mlp["fc1_b"])
    return h + (mm(f, mlp["fc2_w"]) + mlp["fc2_b"])


def _old_decode_step(params, token, lengths, kv_cache, cross_kv, cfg,
                     tok_emb_f32):
    dec = params["decoder"]
    n_head = kv_cache[0][0].shape[1]
    slot = lengths.pos.long()
    x = dec["tok_emb"][token] + dec["pos_emb"].index_select(0, lengths.pos)
    h = x[:, None, :].to(cfg.dtype)
    for blk, ck, cv, xkv in zip(dec["blocks"], kv_cache[0], kv_cache[1],
                                cross_kv):
        a_in = _unfused_layer_norm(h, blk["ln1"]["g"], blk["ln1"]["b"])
        att = blk["attn"]
        b = ck.shape[0]
        ck.index_copy_(2, slot, mm(a_in[:, 0], att["k_w"]).reshape(
            b, n_head, 1, -1))
        cv.index_copy_(2, slot, (mm(a_in[:, 0], att["v_w"])
                                 + att["v_b"]).reshape(b, n_head, 1, -1))
        h = _old_block(h, blk, n_head, ck, cv, xkv, lengths)
    x = _unfused_layer_norm(h, dec["ln"]["g"], dec["ln"]["b"])[:, 0, :]
    return tw.logits_f32(x, tok_emb_f32)


def _randomized(params, seed):
    """``params`` with every decoder LayerNorm's gamma and beta and every
    bias drawn at random (``init_params`` makes them ones and zeros, under
    which a fault in their handling would not show)."""
    gen = torch.Generator().manual_seed(seed)

    def draw(t, centre):
        x = centre + 0.5 * torch.randn(t.shape, generator=gen)
        return x.to(t.dtype)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, key) for v in node]
        if key == "g":
            return draw(node, 1.0)
        if key == "b" or key.endswith("_b"):
            return draw(node, 0.0)
        return node
    return {**params, "decoder": walk(params["decoder"])}


# (activation dtype, int8 weights, int8 cross K/V)
STEP_MODES = {"bf16": (BF16, False, False), "f32": (F32, False, False),
              "int8_weights": (BF16, True, False),
              "int8_cross_kv": (BF16, False, True),
              "int8_both": (BF16, True, True)}


@pytest.mark.parametrize("mode", STEP_MODES)
def test_decode_step_equals_the_unfused_formula(mode):
    dtype, int8_w, int8_kv = STEP_MODES[mode]
    cfg = tw.MODEL_CONFIGS["test"].with_dtype(dtype)
    cpu = torch.device("cpu")
    params = _randomized(tw.init_params(cfg, cpu, seed=3), 4)
    if int8_w:
        params = quantize_params(params)
    rows, prefix, steps = 3, 5, 6
    xa = _randn((rows, cfg.n_audio_ctx, cfg.n_text_state), 11, dtype)
    cross = tw.precompute_cross_kv(params, xa, cfg, quantize=int8_kv)
    tok_emb_f32 = params["decoder"]["tok_emb"].float()
    caches = {}
    for name in ("fused", "old"):
        k, v = tw.init_kv_cache(cfg, rows, prefix + steps, cpu)
        for i, t in enumerate(k + v):
            t[:, :, :prefix] = _randn(t[:, :, :prefix].shape, 20 + i, dtype)
        caches[name] = (k, v)
    token = torch.tensor([7, 300, 1999])
    for s in range(steps):
        pos = torch.tensor([prefix + s], dtype=torch.int32)
        lengths = tw.StepLengths(pos, torch.tensor([cfg.n_audio_ctx - 7],
                                                   dtype=torch.int32))
        got = tw.decode_step(params, token, lengths, caches["fused"], cross,
                             cfg, tok_emb_f32)
        want = _old_decode_step(params, token, lengths, caches["old"], cross,
                                cfg, tok_emb_f32)
        assert got.dtype == torch.float32
        assert torch.equal(got, want), f"step {s}"
        token = want.argmax(-1)
    for a, b in zip(caches["fused"][0] + caches["fused"][1],
                    caches["old"][0] + caches["old"][1]):
        assert torch.equal(a, b)


# -- dispatch off the CPU: meta tensors and a stand-in library ---------------

class _Library:
    """Stands in for the built library: records each entry point called
    with its pointer arguments and returns ``err`` (a cudaError_t)."""

    def __init__(self, err=0):
        self.err = err
        self.called = []

    def __getattr__(self, symbol):
        if not symbol.startswith("mwx_"):
            raise AttributeError(symbol)

        def entry(*args):
            self.called.append((symbol, args))
            return self.err
        return entry


@pytest.fixture
def stand_in(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda name: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    saved = collections.Counter(_build.launches)
    _build.launches.clear()
    yield lib
    _build.launches.clear()
    _build.launches.update(saved)


def _meta(shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("inputs", ["ln_only", "delta", "delta_bias"])
@pytest.mark.parametrize("dtype,suffix", [(BF16, ""), (F32, "_f32")],
                         ids=["bf16", "f32"])
def test_wrapper_launches_the_build_of_its_dtype(stand_in, dtype, suffix,
                                                 inputs):
    h = _meta((16, 1, 1280), dtype)
    delta = _meta((16, 1, 1280), dtype) if inputs != "ln_only" else None
    bias = _meta((1280,), dtype) if inputs == "delta_bias" else None
    h_new, y = add_layer_norm(h, delta, bias, _meta((1280,), dtype),
                              _meta((1280,), dtype))
    assert y.shape == h.shape and y.dtype == dtype
    assert (h_new is h) == (delta is None)
    ((symbol, args),) = stand_in.called
    assert symbol == "mwx_add_layer_norm" + suffix
    assert args[1:3] == (None if delta is None else 0,
                         None if bias is None else 0)
    assert args[7:9] == (16, 1280)
    assert dict(_build.launches) == {"add_layer_norm" + suffix: 1}


@pytest.mark.parametrize("case,match", [
    ("float16", "all bfloat16 or all float32"),
    ("mixed", "all bfloat16 or all float32"),
    ("d_not_multiple_of_8", "multiple of 8"),
    ("d_too_wide", "multiple of 8 up to"),
    ("bias_without_delta", "bias needs a delta"),
    ("delta_shape", "shape"),
    ("gamma_shape", "shape"),
    ("strided_h", "contiguous")])
def test_wrapper_refuses_before_any_launch(stand_in, case, match):
    d = {"d_not_multiple_of_8": 60, "d_too_wide": 8200}.get(case, 64)
    dt = torch.float16 if case == "float16" else BF16
    h = _meta((4, 1, d), dt)
    delta = _meta((4, 1, d), F32 if case == "mixed" else dt)
    bias = _meta((d,), dt)
    g = _meta((d + 8,) if case == "gamma_shape" else (d,), dt)
    if case == "bias_without_delta":
        delta = None
    if case == "delta_shape":
        delta = _meta((2, 1, d), dt)
    if case == "strided_h":
        h = _meta((4, 1, 2 * d), dt)[..., :d]
    with pytest.raises(ValueError, match=match):
        add_layer_norm(h, delta, bias, g, _meta((d,), dt))
    assert stand_in.called == [] and not _build.launches


@pytest.mark.parametrize("dtype,suffix", [(BF16, ""), (F32, "_f32")],
                         ids=["bf16", "f32"])
def test_failed_launch_raises_and_is_not_counted(stand_in, dtype, suffix):
    stand_in.err = 1
    with pytest.raises(RuntimeError, match=f"add_layer_norm{suffix} kernel"):
        add_layer_norm(_meta((2, 1, 64), dtype), None, None,
                       _meta((64,), dtype), _meta((64,), dtype))
    assert not _build.launches


def test_failed_build_raises(monkeypatch):
    """No nvcc here: the build's error reaches the caller; nothing falls
    back to the plain version."""
    def no_build(name):
        raise RuntimeError("CUDA kernel build failed")
    monkeypatch.setattr(_build, "library", no_build)
    with pytest.raises(RuntimeError, match="build failed"):
        add_layer_norm(_meta((2, 1, 64)), None, None, _meta((64,)),
                       _meta((64,)))


def test_decode_step_goes_through_it_three_times_a_layer_and_once(
        monkeypatch):
    """The step calls ``add_layer_norm`` at each block's three residual
    points and at the final LayerNorm: 3L + 1 calls (launches on the card),
    the first (block 0's ln1) with no delta and no bias, every other with
    both."""
    seen = []

    def spy(h, delta, bias, g, b):
        seen.append((delta is not None, bias is not None))
        return add_layer_norm_plain(h, delta, bias, g, b)
    monkeypatch.setattr(tw, "add_layer_norm", spy)
    cfg = tw.MODEL_CONFIGS["test"]
    cpu = torch.device("cpu")
    params = tw.init_params(cfg, cpu, seed=5)
    rows = 2
    cache = tw.init_kv_cache(cfg, rows, 8, cpu)
    cross = tw.precompute_cross_kv(
        params, _randn((rows, cfg.n_audio_ctx, cfg.n_text_state), 12,
                       cfg.dtype), cfg)
    pos = torch.tensor([3], dtype=torch.int32)
    logits = tw.decode_step(
        params, torch.tensor([5, 6]),
        tw.StepLengths(pos, torch.tensor([cfg.n_audio_ctx],
                                         dtype=torch.int32)),
        cache, cross, cfg, params["decoder"]["tok_emb"].float())
    assert logits.shape == (rows, cfg.n_vocab)
    assert seen == [(False, False)] + [(True, True)] * (3 * cfg.n_text_layer)
