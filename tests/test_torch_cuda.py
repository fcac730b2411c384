"""PyTorch port: the CUDA kernels against their plain versions on the card.

Marked ``cuda``; each test skips without a CUDA device (decided inside the
test, never at import).  On the card ``python3 chip_smoke.py`` runs the
same comparisons at large-v3 shapes; these run small shapes, including
the tiny ``test`` config's head_dim 32, ragged lengths and edge lengths.
"""

import collections

import pytest
import torch

from manual_whisper_tpu_torch.ops import _build
from manual_whisper_tpu_torch.ops.attention import (attention_plain,
                                                    flash_attention)
from manual_whisper_tpu_torch.models.whisper import quantize_cross_kv
from manual_whisper_tpu_torch.ops.decode_attention import (
    attend_int8_plain, attend_plain, decode_cross_attention,
    decode_cross_attention_int8, decode_self_attention)
from manual_whisper_tpu_torch.ops.quant import (int8_matmul,
                                                int8_matmul_plain,
                                                quantize_weight)
from manual_whisper_tpu_torch.ops.mel import (normalize_log_mel,
                                              unnormalized_log_mel,
                                              unnormalized_log_mel_f64,
                                              unnormalized_log_mel_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(shape, dev, seed, dtype=torch.bfloat16):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


# K1 takes 96 frames a block: 10 frames (one short block), 96 and 97, 300
# (three blocks and 12 frames) and the 3000 of a 30 s window
MEL_SIZES = [(1601, 80), (15360, 80), (15520, 128), (48000, 80),
             (480000, 128)]


@pytest.mark.parametrize("n_samples,n_mels", MEL_SIZES)
def test_mel_kernel(dev, n_samples, n_mels):
    audio = 0.1 * _randn((2, n_samples), dev, 0, torch.float32)
    before = _build.launches["mel"]
    out = unnormalized_log_mel(audio, n_mels)
    assert _build.launches["mel"] == before + 1
    ref = unnormalized_log_mel_plain(audio, n_mels)
    torch.testing.assert_close(out, ref, atol=2e-3, rtol=0)


@pytest.mark.parametrize("n_samples,n_mels", MEL_SIZES)
def test_mel_kernel_hard_rows(dev, n_samples, n_mels):
    """Rows of exact zeros (a batch's padding row), quiet noise (1e-4) and
    DC 0.5 plus a 1e-3 tone at 7 kHz, after the normalisation, which
    clamps bins more than 8 decades below the row's max."""
    t = torch.arange(n_samples, device=dev) / 16000.0
    audio = torch.stack([
        torch.zeros(n_samples, device=dev),
        1e-4 * _randn((n_samples,), dev, 30, torch.float32),
        0.5 + 1e-3 * torch.sin(2 * torch.pi * 7000.0 * t)]).contiguous()
    out = normalize_log_mel(unnormalized_log_mel(audio, n_mels))
    ref = normalize_log_mel(unnormalized_log_mel_plain(audio, n_mels))
    assert torch.equal(out[0], ref[0])              # the floor, everywhere
    torch.testing.assert_close(out, ref, atol=1e-3, rtol=0)


def _f64_error_kept(out, ref):
    """Max abs error against the float64 reference where the normalisation
    keeps the reference (within 8 decades of its row's max)."""
    kept = ref >= ref.amax(dim=(-2, -1), keepdim=True) - 8.0
    return float((out.double() - ref).abs()[kept].max())


def test_mel_kernel_against_float64(dev):
    """A steep spectral tilt, where K1's bins 101..200 are small differences
    of two large sums (P - Q): a 0.5 tone at 200 Hz with a 1e-4 tone at
    7.8 kHz (its mirror bin), and a 0.5 tone at 100 Hz over 1e-5
    high-passed noise.  Against the plain version run in float64, the
    kernel's error where the normalisation keeps the values is no worse
    than 4x the plain float32 version's."""
    n = 32000
    t = torch.arange(n, device=dev, dtype=torch.float64) / 16000.0
    noise = _randn((n + 1,), dev, 40, torch.float64)
    audio = torch.stack([
        0.5 * torch.sin(2 * torch.pi * 200.0 * t)
        + 1e-4 * torch.sin(2 * torch.pi * 7800.0 * t),
        0.5 * torch.sin(2 * torch.pi * 100.0 * t)
        + 1e-5 * (noise[1:] - noise[:-1])]).float().contiguous()
    ref = unnormalized_log_mel_f64(audio, 128)
    kernel = _f64_error_kept(unnormalized_log_mel(audio, 128), ref)
    plain = _f64_error_kept(unnormalized_log_mel_plain(audio, 128), ref)
    assert kernel <= 4 * plain, (kernel, plain)


@pytest.mark.parametrize("t_q,t_k,dh", [(150, 150, 32), (1500, 1500, 64),
                                        (1, 70, 64), (127, 129, 64),
                                        (129, 1, 32), (1500, 1500, 32)])
def test_flash_kernel(dev, t_q, t_k, dh):
    """K2 takes 128 queries a block and 128 keys a step: a query tile of
    one row, a last key tile of one key, a single key, both head widths."""
    q = _randn((2, 3, t_q, dh), dev, 1)
    k = _randn((2, 3, t_k, dh), dev, 2)
    v = _randn((2, 3, t_k, dh), dev, 3)
    before = _build.launches["flash_attention"]
    out = flash_attention(q, k, v)
    assert _build.launches["flash_attention"] == before + 1
    torch.testing.assert_close(out.float(), attention_plain(q, k, v).float(),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("dh", [32, 64])
def test_decode_kernels(dev, dh):
    q = _randn((3, 4, 1, dh), dev, 4)
    k = _randn((3, 4, 200, dh), dev, 5)
    v = _randn((3, 4, 200, dh), dev, 6)
    for n in (1, 77, 200):
        pos = torch.tensor([n - 1], dtype=torch.int32, device=dev)
        torch.testing.assert_close(
            decode_self_attention(q, k, v, pos).float(),
            attend_plain(q, k, v, n).float(), atol=1e-2, rtol=1e-2)
        kv_len = torch.tensor([n], dtype=torch.int32, device=dev)
        torch.testing.assert_close(
            decode_cross_attention(q, k, v, kv_len).float(),
            attend_plain(q, k, v, n).float(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("n", [1, 7, 8, 1499, 1500])
def test_decode_cross_kernel_slices(dev, dh, n):
    """K4 splits the key axis over 8 blocks: lengths that leave blocks
    without keys, and a ragged last slice, at the encoder's 1500 positions."""
    q = _randn((2, 3, 1, dh), dev, 19)
    k = _randn((2, 3, 1500, dh), dev, 20)
    v = _randn((2, 3, 1500, dh), dev, 21)
    kv_len = torch.tensor([n], dtype=torch.int32, device=dev)
    before = _build.launches["decode_cross_attention"]
    out = decode_cross_attention(q, k, v, kv_len)
    assert _build.launches["decode_cross_attention"] == before + 1
    torch.testing.assert_close(out.float(), attend_plain(q, k, v, n).float(),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 194, 416, 417])
def test_decode_self_kernel_slices(dev, dh, n):
    """K3 splits the key axis over the blocks of a cluster: lengths n =
    pos + 1 that leave blocks without keys, a ragged last slice, and the
    main path's first, last and full self cache of 417 slots."""
    q = _randn((2, 3, 1, dh), dev, 25)
    k = _randn((2, 3, 417, dh), dev, 26)
    v = _randn((2, 3, 417, dh), dev, 27)
    pos = torch.tensor([n - 1], dtype=torch.int32, device=dev)
    before = _build.launches["decode_self_attention"]
    out = decode_self_attention(q, k, v, pos)
    assert _build.launches["decode_self_attention"] == before + 1
    torch.testing.assert_close(out.float(), attend_plain(q, k, v, n).float(),
                               atol=1e-2, rtol=1e-2)


def test_kernels_reject_wrong_inputs(dev):
    q = _randn((1, 2, 8, 64), dev, 7, torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q, q, q)
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError, match="int32"):
        decode_cross_attention(qb[:, :, :1].contiguous(), qb, qb,
                               torch.tensor([3], device=dev))


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_decode_int8_kernel(dev, dh, scale_dtype):
    q = _randn((3, 4, 1, dh), dev, 8)
    kv4 = quantize_cross_kv(_randn((3, 4, 300, dh), dev, 9),
                            _randn((3, 4, 300, dh), dev, 10), scale_dtype)
    before = _build.launches["decode_cross_attention_int8"]
    for n in (1, 77, 300):
        kv_len = torch.tensor([n], dtype=torch.int32, device=dev)
        torch.testing.assert_close(
            decode_cross_attention_int8(q, *kv4, kv_len).float(),
            attend_int8_plain(q, *kv4, n).float(), atol=1e-2, rtol=1e-2)
    assert _build.launches["decode_cross_attention_int8"] == before + 3


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 7, 8, 1499, 1500])
def test_decode_int8_kernel_slices(dev, dh, scale_dtype, n):
    """K5 splits the key axis over 8 blocks: lengths that leave blocks
    without keys, and a ragged last slice, at the encoder's 1500 positions."""
    q = _randn((2, 3, 1, dh), dev, 22)
    kv4 = quantize_cross_kv(_randn((2, 3, 1500, dh), dev, 23),
                            _randn((2, 3, 1500, dh), dev, 24), scale_dtype)
    kv_len = torch.tensor([n], dtype=torch.int32, device=dev)
    before = _build.launches["decode_cross_attention_int8"]
    out = decode_cross_attention_int8(q, *kv4, kv_len)
    assert _build.launches["decode_cross_attention_int8"] == before + 1
    torch.testing.assert_close(out.float(),
                               attend_int8_plain(q, *kv4, n).float(),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 8, 9, 17, 129, 300, 772])
@pytest.mark.parametrize("k,n", [(64, 256), (1280, 5120), (1288, 1296),
                                 (5120, 1280)])
def test_int8_matmul_kernel(dev, m, k, n):
    x = _randn((m, k), dev, 11)
    w = quantize_weight(_randn((k, n), dev, 12, torch.float32) / k ** 0.5)
    before = _build.launches["int8_matmul"]
    out = int8_matmul(x, w["q"], w["s"])
    assert _build.launches["int8_matmul"] == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    torch.testing.assert_close(out.float(),
                               int8_matmul_plain(x, w["q"], w["s"]).float(),
                               atol=1e-2, rtol=1e-2)


def test_int8_kernels_reject_wrong_inputs(dev):
    x = _randn((4, 64), dev, 13)
    w = quantize_weight(_randn((64, 256), dev, 14, torch.float32))
    with pytest.raises(ValueError, match="dtype"):
        int8_matmul(x.float(), w["q"], w["s"])
    with pytest.raises(ValueError, match="shape"):
        int8_matmul(x, w["q"][:32], w["s"])
    with pytest.raises(ValueError, match="multiple"):
        int8_matmul(x[:, :60].contiguous(), w["q"][:60].contiguous(),
                    w["s"])
    shifted = _randn((3 * 64 + 1,), dev, 18)[1:].view(3, 64)  # 2-byte offset
    with pytest.raises(ValueError, match="aligned"):
        int8_matmul(shifted, w["q"], w["s"])
    q = _randn((1, 2, 1, 64), dev, 15)
    kv4 = quantize_cross_kv(_randn((1, 2, 50, 64), dev, 16),
                            _randn((1, 2, 50, 64), dev, 17))
    kv_len = torch.tensor([50], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        decode_cross_attention_int8(q, kv4[0].float(), *kv4[1:], kv_len)
    with pytest.raises(ValueError, match="shape"):
        decode_cross_attention_int8(q, kv4[0], kv4[1][:, :, :40], *kv4[2:],
                                    kv_len)
    with pytest.raises(ValueError, match="int32"):
        decode_cross_attention_int8(q, *kv4, kv_len.long())


# -- the decode loop as replays of captured chunks ---------------------------

def _tiny_decoders(dev, int8):
    """A captured and an eager ``BatchDecoder`` over the ``test`` config in
    bf16 with seeded random weights (``int8``: int8 weights and int8 cross
    K/V); 40 new tokens, so a loop runs 16 + 16 + 7 steps."""
    from manual_whisper_tpu_torch.models.decode import (BatchDecoder,
                                                        DecodingOptions)
    from manual_whisper_tpu_torch.models.whisper import (MODEL_CONFIGS,
                                                         init_params)
    from manual_whisper_tpu_torch.ops.quant import quantize_params
    from manual_whisper_tpu_torch.tokenizer import make_test_tokenizer
    cfg = MODEL_CONFIGS["test"].with_dtype(torch.bfloat16)
    params = init_params(cfg, dev, seed=7)
    if int8:
        params = quantize_params(params)
    opts = DecodingOptions(language="en", max_new_tokens=40,
                           suppress_blank=False, int8_cross_kv=int8)
    tk = make_test_tokenizer()
    return (cfg, BatchDecoder(params, cfg, tk, opts, dev),
            BatchDecoder(params, cfg, tk, opts, dev, eager=True))


def _tiny_xa(cfg, dev, rows, seed):
    return _randn((rows, cfg.n_audio_ctx, cfg.n_text_state), dev, seed)


@pytest.mark.parametrize("temperature", [0.0, 0.6])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("rows", [1, 2, 4])
def test_captured_loop_equals_eager(dev, rows, int8, temperature):
    """The replayed chunks give the eager chunks' tokens, lengths and
    summed logprobs (same kernels in the same order, same random numbers
    from the same seed), and their launches are counted as launched."""
    cfg, graph, eager = _tiny_decoders(dev, int8)
    xa = _tiny_xa(cfg, dev, rows, 40)
    graph.decode_submit(xa, 0.0)        # captures (its warm-up launches)
    out = {}
    for name, dec in (("graph", graph), ("eager", eager)):
        before = collections.Counter(_build.launches)
        out[name] = dec.decode_submit(xa, temperature, rng_tag=3)
        torch.cuda.synchronize()
        out[name + "_launches"] = _build.launches - before
    g, e = out["graph"], out["eager"]
    assert graph.captured and not eager.captured
    assert torch.equal(g.tokens, e.tokens)
    assert torch.equal(g.lengths, e.lengths) and g.steps == e.steps
    torch.testing.assert_close(g.sum_logprob, e.sum_logprob, atol=1e-4,
                               rtol=0)
    assert out["graph_launches"] == out["eager_launches"]


def _step_launches(cfg, int8):
    layers = cfg.n_text_layer
    if int8:
        return {"decode_self_attention": layers,
                "decode_cross_attention_int8": layers,
                "int8_matmul": 8 * layers}
    return {"decode_self_attention": layers,
            "decode_cross_attention": layers}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_capture_records_each_chunks_launches(dev, int8):
    """Each captured chunk's launch delta is its steps times one step's
    launches; the capture itself leaves the counters as they were."""
    cfg, graph, _ = _tiny_decoders(dev, int8)
    xa = _tiny_xa(cfg, dev, 2, 41)
    before = collections.Counter(_build.launches)
    out = graph.decode_submit(xa, 0.0)
    (loop,) = graph._loops.values()
    assert sorted(loop.graphs.graphs) == [7, 16]
    per_step = _step_launches(cfg, int8)
    for n, delta in loop.graphs.launch_delta.items():
        assert delta == {k: n * v for k, v in per_step.items()}
    # this decode: the warm-up runs before each capture (16 + 7 steps),
    # the loop's replays (out.steps - 1 steps), and with int8 weights the
    # cross K/V's 2 and the prefill's 8 matmuls a layer
    ran = _build.launches - before
    for k, v in per_step.items():
        assert ran[k] - v * (16 + 7 + out.steps - 1) == (
            10 * cfg.n_text_layer if k == "int8_matmul" else 0)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_new_capture_leaves_earlier_loops_alone(dev, int8):
    """Decode at 2 rows, capture 1 and 4 rows, decode at 2 rows again: the
    same results, so graphs sharing one memory pool keep their buffers."""
    cfg, graph, _ = _tiny_decoders(dev, int8)
    xa = _tiny_xa(cfg, dev, 2, 42)
    first = graph.decode_submit(xa, 0.6, rng_tag=1)
    for rows in (1, 4):
        graph.decode_submit(_tiny_xa(cfg, dev, rows, 43 + rows), 0.0)
    again = graph.decode_submit(xa, 0.6, rng_tag=1)
    assert len(graph._loops) == 3
    for name in ("tokens", "sum_logprob", "lengths", "no_speech"):
        assert torch.equal(getattr(first, name), getattr(again, name)), name
