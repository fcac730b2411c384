"""PyTorch port: the CUDA kernels against their plain versions on the card.

Marked ``cuda``; each test skips without a CUDA device (decided inside the
test, never at import).  On the card ``python3 chip_smoke.py`` runs the
same comparisons at large-v3 shapes; these run small shapes, including
the tiny ``test`` config's head_dim 32, ragged lengths and edge lengths.
"""

import collections
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from manual_whisper_tpu_torch import spans
from manual_whisper_tpu_torch.ops import _build
from manual_whisper_tpu_torch.ops.attention import (attention_plain,
                                                    flash_attention)
from manual_whisper_tpu_torch.models.whisper import quantize_cross_kv
from manual_whisper_tpu_torch.ops.decode_attention import (
    attend_int8_plain, attend_plain, decode_cross_attention,
    decode_cross_attention_int8, decode_self_attention)
from manual_whisper_tpu_torch.ops.norm import (add_layer_norm,
                                               add_layer_norm_plain)
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


@contextlib.contextmanager
def _counting():
    """A fresh launch sink (``Counter`` of (kernel, shape)), bound on this
    thread while the block runs."""
    launches = collections.Counter()
    with spans.bind({}, "test", launches):
        yield launches


def _by_kernel(launches):
    """Launches of (kernel, shape) summed by kernel."""
    out = collections.Counter()
    for (kernel, _), n in launches.items():
        out[kernel] += n
    return out


# K2-K4 in each build: the kernel name's suffix and (atol, rtol) against
# the plain version.  bf16: the plain versions round P to bf16 (one ulp is
# 2^-8 relative); float32: both sum in float32 in other orders
# (chip_smoke.py's TOL holds the same limits)
ATTENTION_BUILDS = {"bf16": (torch.bfloat16, "", 1e-2),
                    "f32": (torch.float32, "_f32", 1e-4)}


# K1 takes 96 frames a block: 10 frames (one short block), 96 and 97, 300
# (three blocks and 12 frames) and the 3000 of a 30 s window
MEL_SIZES = [(1601, 80), (15360, 80), (15520, 128), (48000, 80),
             (480000, 128)]


@pytest.mark.parametrize("n_samples,n_mels", MEL_SIZES)
def test_mel_kernel(dev, n_samples, n_mels):
    audio = 0.1 * _randn((2, n_samples), dev, 0, torch.float32)
    with _counting() as launches:
        out = unnormalized_log_mel(audio, n_mels)
    assert launches == {("mel", (2, n_samples, n_mels)): 1}
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


# diarization's shapes: the ResNet34's 80-mel clips and the statistics
# embedding's 40-mel clips in their length buckets (0.5 to 10 s), the
# 40-mel 3 s windows; K1 takes 40 mels with its 32-wide band table
DIARIZE_MEL_SIZES = [(8000, 80), (160000, 80), (8000, 40), (16000, 40),
                     (64000, 40), (160000, 40), (48000, 40)]


@pytest.mark.parametrize("n_samples,n_mels", DIARIZE_MEL_SIZES)
def test_mel_kernel_diarization_shapes(dev, n_samples, n_mels):
    """Raw log-mel of rows zero-padded past ragged lengths, as the
    embedding buckets hold clips: the kernel against its plain version
    within 2e-3, the padded frames at the 1e-10 floor in both."""
    rows = 0.1 * _randn((8, n_samples), dev, n_mels, torch.float32)
    lengths = torch.linspace(n_samples // 3, n_samples, 8).long()
    for r, n in enumerate(lengths.tolist()):
        rows[r, n:] = 0.0
    with _counting() as launches:
        out = unnormalized_log_mel(rows, n_mels)
    assert launches == {("mel", (8, n_samples, n_mels)): 1}
    ref = unnormalized_log_mel_plain(rows, n_mels)
    torch.testing.assert_close(out, ref, atol=2e-3, rtol=0)
    assert torch.equal(out[0, -1], ref[0, -1])
    assert float(out[0, -1].max()) == -10.0


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


@pytest.mark.parametrize("build", ATTENTION_BUILDS)
@pytest.mark.parametrize("t_q,t_k,dh", [(150, 150, 32), (1500, 1500, 64),
                                        (1, 70, 64), (127, 129, 64),
                                        (129, 1, 32), (1500, 1500, 32)])
def test_flash_kernel(dev, t_q, t_k, dh, build):
    """K2 takes 128 queries a block and 128 keys a step in bf16, 64 and 64
    in float32: a query tile of one row, a last key tile of one key, a
    single key, both head widths; the output in the inputs' dtype."""
    dtype, suffix, tol = ATTENTION_BUILDS[build]
    q = _randn((2, 3, t_q, dh), dev, 1, dtype)
    k = _randn((2, 3, t_k, dh), dev, 2, dtype)
    v = _randn((2, 3, t_k, dh), dev, 3, dtype)
    with _counting() as launches:
        out = flash_attention(q, k, v)
    assert launches == {("flash_attention" + suffix, (6, t_q, t_k, dh)): 1}
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), attention_plain(q, k, v).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("t_q,t_k,dh,key_scale",
                         [(130, t_k, dh, 1.0) for dh in (32, 64)
                          for t_k in (63, 64, 65)]
                         + [(1500, 1500, 64, 3.0)])
def test_flash_f32_kernel_key_steps(dev, t_q, t_k, dh, key_scale):
    """K2 in float32 (3xTF32) takes 64 keys a step: key lengths one short
    of, at and one past a step at both head widths, and a sharp softmax
    (keys scaled 3x), where one TF32 product a score would miss the
    tolerance."""
    dtype, suffix, tol = ATTENTION_BUILDS["f32"]
    q = _randn((2, 3, t_q, dh), dev, 41, dtype)
    k = key_scale * _randn((2, 3, t_k, dh), dev, 42, dtype)
    v = _randn((2, 3, t_k, dh), dev, 43, dtype)
    with _counting() as launches:
        out = flash_attention(q, k, v)
    assert launches == {("flash_attention" + suffix, (6, t_q, t_k, dh)): 1}
    torch.testing.assert_close(out, attention_plain(q, k, v), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("build", ATTENTION_BUILDS)
@pytest.mark.parametrize("dh", [32, 64])
def test_decode_kernels(dev, dh, build):
    dtype, suffix, tol = ATTENTION_BUILDS[build]
    q = _randn((3, 4, 1, dh), dev, 4, dtype)
    k = _randn((3, 4, 200, dh), dev, 5, dtype)
    v = _randn((3, 4, 200, dh), dev, 6, dtype)
    with _counting() as launches:
        for n in (1, 77, 200):
            pos = torch.tensor([n - 1], dtype=torch.int32, device=dev)
            out = decode_self_attention(q, k, v, pos)
            assert out.dtype == dtype
            torch.testing.assert_close(out.float(),
                                       attend_plain(q, k, v, n).float(),
                                       atol=tol, rtol=tol)
            kv_len = torch.tensor([n], dtype=torch.int32, device=dev)
            torch.testing.assert_close(
                decode_cross_attention(q, k, v, kv_len).float(),
                attend_plain(q, k, v, n).float(), atol=tol, rtol=tol)
    assert launches == {
        ("decode_self_attention" + suffix, (12, 200, dh)): 3,
        ("decode_cross_attention" + suffix, (12, 200, dh)): 3}


@pytest.mark.parametrize("build", ATTENTION_BUILDS)
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("n", [1, 7, 8, 1499, 1500])
def test_decode_cross_kernel_slices(dev, dh, n, build):
    """K4 splits the key axis over 8 blocks: lengths that leave blocks
    without keys, and a ragged last slice, at the encoder's 1500 positions."""
    dtype, suffix, tol = ATTENTION_BUILDS[build]
    q = _randn((2, 3, 1, dh), dev, 19, dtype)
    k = _randn((2, 3, 1500, dh), dev, 20, dtype)
    v = _randn((2, 3, 1500, dh), dev, 21, dtype)
    kv_len = torch.tensor([n], dtype=torch.int32, device=dev)
    with _counting() as launches:
        out = decode_cross_attention(q, k, v, kv_len)
    assert launches == {("decode_cross_attention" + suffix, (6, 1500, dh)): 1}
    torch.testing.assert_close(out.float(), attend_plain(q, k, v, n).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("n,build",
                         [(n, build) for build in ATTENTION_BUILDS
                          for n in (1, 7, 8, 9, 194, 416, 417)]
                         + [(n, "f32") for n in (63, 64, 65, 104, 105, 256,
                                                 257)])
def test_decode_self_kernel_slices(dev, dh, n, build):
    """K3 splits the key axis over the blocks of a cluster: lengths n =
    pos + 1 that leave blocks without keys, a ragged last slice, and the
    main path's first, last and full self cache of 417 slots; in float32
    also the edges of its blocks' passes and slices (64 keys a pass)."""
    dtype, suffix, tol = ATTENTION_BUILDS[build]
    q = _randn((2, 3, 1, dh), dev, 25, dtype)
    k = _randn((2, 3, 417, dh), dev, 26, dtype)
    v = _randn((2, 3, 417, dh), dev, 27, dtype)
    pos = torch.tensor([n - 1], dtype=torch.int32, device=dev)
    with _counting() as launches:
        out = decode_self_attention(q, k, v, pos)
    assert launches == {("decode_self_attention" + suffix, (6, 417, dh)): 1}
    torch.testing.assert_close(out.float(), attend_plain(q, k, v, n).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("build", ATTENTION_BUILDS)
@pytest.mark.parametrize("n", [1, 9, 128, 129, 256, 257, 448])
def test_decode_self_kernel_wide(dev, n, build):
    """Past one (batch, head) per SM K3 takes its wide launch shape (2
    blocks a pair): batch 16 x 20 heads over the server's 448 slots, slices
    that fill one pass of 128 keys or spill into a second, and the full
    cache."""
    dtype, suffix, tol = ATTENTION_BUILDS[build]
    q = _randn((16, 20, 1, 64), dev, 28, dtype)
    k = _randn((16, 20, 448, 64), dev, 29, dtype)
    v = _randn((16, 20, 448, 64), dev, 30, dtype)
    pos = torch.tensor([n - 1], dtype=torch.int32, device=dev)
    out = decode_self_attention(q, k, v, pos)
    torch.testing.assert_close(out.float(), attend_plain(q, k, v, n).float(),
                               atol=tol, rtol=tol)


def test_kernels_reject_wrong_inputs(dev):
    """K2-K4 take bf16 or float32, q, k and v of one dtype: float16 and a
    mix raise before any launch; so does a length that is not int32."""
    q = _randn((1, 2, 8, 64), dev, 7, torch.float32)
    q16, qb = q.half(), q.to(torch.bfloat16)
    one = torch.tensor([3], dtype=torch.int32, device=dev)
    with _counting() as launches:
        with pytest.raises(ValueError, match="dtype"):
            flash_attention(q16, q16, q16)
        with pytest.raises(ValueError, match="one dtype"):
            flash_attention(q, qb, q)
        for fn in (decode_self_attention, decode_cross_attention):
            with pytest.raises(ValueError, match="dtype"):
                fn(q16[:, :, :1].contiguous(), q16, q16, one)
            with pytest.raises(ValueError, match="one dtype"):
                fn(qb[:, :, :1].contiguous(), q, q, one)
    assert not launches
    with pytest.raises(ValueError, match="int32"):
        decode_cross_attention(qb[:, :, :1].contiguous(), qb, qb,
                               torch.tensor([3], device=dev))


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_decode_int8_kernel(dev, dh, scale_dtype):
    q = _randn((3, 4, 1, dh), dev, 8)
    kv4 = quantize_cross_kv(_randn((3, 4, 300, dh), dev, 9),
                            _randn((3, 4, 300, dh), dev, 10), scale_dtype)
    with _counting() as launches:
        for n in (1, 77, 300):
            kv_len = torch.tensor([n], dtype=torch.int32, device=dev)
            torch.testing.assert_close(
                decode_cross_attention_int8(q, *kv4, kv_len).float(),
                attend_int8_plain(q, *kv4, n).float(), atol=1e-2, rtol=1e-2)
    scales = str(scale_dtype).split(".")[-1]
    assert launches == {("decode_cross_attention_int8",
                         (3, 4, 300, dh, scales)): 3}


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 7, 8, 15, 16, 17, 63, 64, 65, 188, 189,
                               192, 193, 1499, 1500])
def test_decode_int8_kernel_slices(dev, dh, scale_dtype, n):
    """K5 splits the key axis over a cluster of 8 blocks at these 6 pairs,
    in slices on 16-key boundaries, each streamed in stages of 64 keys:
    lengths that leave blocks without keys (1 to 17), end a stage or a
    slice on its edge or one key past it (63 to 65; 188 and 189, 1500 / 8
    and one past; 192 and 193, that on 16 keys: the 8-block slice of
    1500), and a ragged last slice, at the encoder's 1500 positions.  The bf16 scales' rows start off a 16-byte line at odd
    (batch, head), so their edges go through the plain loads."""
    q = _randn((2, 3, 1, dh), dev, 22)
    kv4 = quantize_cross_kv(_randn((2, 3, 1500, dh), dev, 23),
                            _randn((2, 3, 1500, dh), dev, 24), scale_dtype)
    kv_len = torch.tensor([n], dtype=torch.int32, device=dev)
    with _counting() as launches:
        out = decode_cross_attention_int8(q, *kv4, kv_len)
    scales = str(scale_dtype).split(".")[-1]
    assert launches == {("decode_cross_attention_int8",
                         (2, 3, 1500, dh, scales)): 1}
    torch.testing.assert_close(out.float(),
                               attend_int8_plain(q, *kv4, n).float(),
                               atol=1e-2, rtol=1e-2)


# (batch, heads) on both sides of each of K5's launch-shape boundaries:
# B x H = 5 SMs // (2 split) pairs keep ``split`` blocks a pair, one more
# halves it (``int8_split`` in decode_attention.cu); then the int8 loops'
# 16 and 2 rows of 20 heads
INT8_PAIRS = ["split8", "split8+1", "split4", "split4+1", "split2",
              "split2+1", "16x20", "2x20"]


def _int8_pairs(name: str, sms: int):
    if name.startswith("split"):
        split, _, more = name[5:].partition("+")
        return 1, 5 * sms // (2 * int(split)) + int(more or 0)
    return tuple(int(x) for x in name.split("x"))


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 65, 1499, 1500])
@pytest.mark.parametrize("pairs", INT8_PAIRS)
def test_decode_int8_kernel_launch_shapes(dev, pairs, n, scale_dtype, dh):
    """K5 on both sides of each launch-shape boundary the host picks by
    B x H (one row of that many heads), and at the int8 loops' 16 and 2
    rows of 20 heads."""
    b, h = _int8_pairs(pairs,
                       torch.cuda.get_device_properties(dev)
                       .multi_processor_count)
    q = _randn((b, h, 1, dh), dev, 25)
    kv4 = quantize_cross_kv(_randn((b, h, 1500, dh), dev, 26),
                            _randn((b, h, 1500, dh), dev, 27), scale_dtype)
    kv_len = torch.tensor([n], dtype=torch.int32, device=dev)
    with _counting() as launches:
        out = decode_cross_attention_int8(q, *kv4, kv_len)
    scales = str(scale_dtype).split(".")[-1]
    assert launches == {("decode_cross_attention_int8",
                         (b, h, 1500, dh, scales)): 1}
    torch.testing.assert_close(out.float(),
                               attend_int8_plain(q, *kv4, n).float(),
                               atol=1e-2, rtol=1e-2)


# the matvec takes M <= 16 (one group of 8 rows of x, or two from M = 9),
# the tile product M >= 17
@pytest.mark.parametrize("m", [1, 2, 3, 4, 8, 9, 10, 12, 15, 16, 17, 129, 300,
                               772])
@pytest.mark.parametrize("k,n", [(64, 256), (1280, 5120), (1288, 1296),
                                 (5120, 1280)])
def test_int8_matmul_kernel(dev, m, k, n):
    x = _randn((m, k), dev, 11)
    w = quantize_weight(_randn((k, n), dev, 12, torch.float32) / k ** 0.5)
    with _counting() as launches:
        out = int8_matmul(x, w["q"], w["s"])
    assert launches == {("int8_matmul", (m, k, n)): 1}
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
    codes = torch.empty(kv4[0].numel() + 8, dtype=torch.int8, device=dev)
    shifted = codes[8:].view(kv4[0].shape)                # 8-byte offset
    shifted.copy_(kv4[0])
    with pytest.raises(ValueError, match="aligned"):
        decode_cross_attention_int8(q, shifted, *kv4[1:], kv_len)


# -- the decode step's bias + residual add + LayerNorm -----------------------

def _bf16_ulps(out, ref):
    """|out - ref| in units of one bf16 ulp of ref (2^(e - 7) for |ref|
    in [2^e, 2^(e + 1)))."""
    ref = ref.float()
    e = torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -126)))
    return (out.float() - ref).abs() / torch.exp2(e - 7)


def _norm_inputs(dev, rows, d, dtype, inputs):
    h = 4 * _randn((rows, 1, d), dev, 50, dtype)
    delta = 3 * _randn((rows, 1, d), dev, 51, dtype) \
        if inputs != "ln_only" else None
    bias = _randn((d,), dev, 52, dtype) if inputs == "delta_bias" else None
    return h, delta, bias, _randn((d,), dev, 53, dtype) + 1, \
        _randn((d,), dev, 54, dtype)


@pytest.mark.parametrize("inputs", ["ln_only", "delta", "delta_bias"])
@pytest.mark.parametrize("build", ATTENTION_BUILDS)
@pytest.mark.parametrize("d", [64, 384, 1280])
@pytest.mark.parametrize("rows", [1, 5, 16, 80])
def test_add_layer_norm_kernel(dev, rows, d, build, inputs):
    """h_new the plain version's bits (the same two rounded adds); y within
    one bf16 ulp in bf16 (the statistics summed in another order), 1e-6 in
    float32."""
    dtype, suffix, _ = ATTENTION_BUILDS[build]
    args = _norm_inputs(dev, rows, d, dtype, inputs)
    with _counting() as launches:
        h_new, y = add_layer_norm(*args)
    assert launches == {("add_layer_norm" + suffix, (rows, d)): 1}
    ref_h, ref_y = add_layer_norm_plain(*args)
    assert torch.equal(h_new, ref_h)
    if dtype == torch.bfloat16:
        assert float(_bf16_ulps(y, ref_y).max()) <= 1.0
    else:
        torch.testing.assert_close(y, ref_y, rtol=1e-6, atol=1e-6)


def test_add_layer_norm_rejects_wrong_inputs(dev):
    h, delta, bias, g, b = _norm_inputs(dev, 4, 64, torch.bfloat16,
                                        "delta_bias")
    shifted = _randn((4 * 64 + 1,), dev, 55)[1:].view(4, 1, 64)
    with _counting() as launches:
        with pytest.raises(ValueError, match="bfloat16 or all float32"):
            add_layer_norm(h.half(), delta.half(), bias.half(), g.half(),
                           b.half())
        with pytest.raises(ValueError, match="bfloat16 or all float32"):
            add_layer_norm(h, delta, bias.float(), g, b)
        with pytest.raises(ValueError, match="multiple of 8"):
            add_layer_norm(h[..., :60].contiguous(), None, None, g[:60],
                           b[:60])
        with pytest.raises(ValueError, match="contiguous"):
            add_layer_norm(torch.cat([h, h], -1)[..., :64], delta, bias, g,
                           b)
        with pytest.raises(ValueError, match="aligned"):
            add_layer_norm(shifted, delta, bias, g, b)
    assert not launches


# -- the decode loop as replays of captured chunks ---------------------------

def _tiny_decoders(dev, int8, dtype=torch.bfloat16):
    """A captured and an eager ``BatchDecoder`` over the ``test`` config in
    ``dtype`` (bf16 or float32) with seeded random weights (``int8``: int8
    weights and int8 cross K/V on bf16); 40 new tokens, so a loop runs 16 +
    16 + 7 steps."""
    from manual_whisper_tpu_torch.models.decode import (BatchDecoder,
                                                        DecodingOptions)
    from manual_whisper_tpu_torch.models.whisper import (MODEL_CONFIGS,
                                                         init_params)
    from manual_whisper_tpu_torch.ops.quant import quantize_params
    from manual_whisper_tpu_torch.tokenizer import make_test_tokenizer
    cfg = MODEL_CONFIGS["test"].with_dtype(dtype)
    params = init_params(cfg, dev, seed=7)
    if int8:
        params = quantize_params(params)
    opts = DecodingOptions(language="en", max_new_tokens=40,
                           suppress_blank=False, int8_cross_kv=int8)
    tk = make_test_tokenizer()
    return (cfg, BatchDecoder(params, cfg, tk, opts, dev),
            BatchDecoder(params, cfg, tk, opts, dev, eager=True))


def _tiny_xa(cfg, dev, rows, seed):
    return _randn((rows, cfg.n_audio_ctx, cfg.n_text_state), dev, seed,
                  cfg.dtype)


# the decode loop's modes: bf16, int8 (int8 weights and cross K/V on bf16)
# and float32, as (int8, activation dtype)
MODES = {"bf16": (False, torch.bfloat16), "int8": (True, torch.bfloat16),
         "f32": (False, torch.float32)}


@pytest.mark.parametrize("mode", MODES)
def test_captured_decode_steps_equal_eager(dev, mode):
    """16 decode steps, each fed the last one's argmax, captured in one
    CUDA graph and replayed from the state the eager steps start from: the
    same logits and self caches, bit for bit; the capture records each
    step's launches by shape: K3 and the cross kernel a layer, 3L + 1
    fused launches, and with int8 8 K6 a layer."""
    from manual_whisper_tpu_torch.models.whisper import (
        MODEL_CONFIGS, StepLengths, decode_step, init_kv_cache, init_params,
        precompute_cross_kv)
    from manual_whisper_tpu_torch.ops.quant import quantize_params
    int8, dtype = MODES[mode]
    cfg = MODEL_CONFIGS["test"].with_dtype(dtype)
    params = init_params(cfg, dev, seed=9)
    if int8:
        params = quantize_params(params)
    rows, prefix, steps = 4, 6, 16
    cross = precompute_cross_kv(params, _tiny_xa(cfg, dev, rows, 46), cfg,
                                quantize=int8)
    cross_len = torch.tensor([cfg.n_audio_ctx - 5], dtype=torch.int32,
                             device=dev)
    tok_emb_f32 = params["decoder"]["tok_emb"].float()

    def state():
        cache = init_kv_cache(cfg, rows, prefix + steps, dev)
        for i, t in enumerate(cache[0] + cache[1]):
            t[:, :, :prefix] = _randn(t[:, :, :prefix].shape, dev, 60 + i,
                                      dtype)
        return (cache, torch.tensor([3, 70, 700, 1999], device=dev),
                torch.tensor([prefix], dtype=torch.int32, device=dev))

    def run(cache, tok, pos):
        out = []
        for _ in range(steps):
            logits = decode_step(params, tok, StepLengths(pos, cross_len),
                                 cache, cross, cfg, tok_emb_f32)
            tok.copy_(logits.argmax(-1))
            pos += 1
            out.append(logits)
        return torch.stack(out)

    eager_state = state()
    eager = run(*eager_state)
    graph_state = state()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(*state())
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with spans.recording() as record, torch.cuda.graph(graph):
        replayed = run(*graph_state)
    fresh = state()
    for dst, src in zip(graph_state[0][0] + graph_state[0][1]
                        + list(graph_state[1:]),
                        fresh[0][0] + fresh[0][1] + list(fresh[1:])):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, eager)
    for a, b in zip(graph_state[0][0] + graph_state[0][1],
                    eager_state[0][0] + eager_state[0][1]):
        assert torch.equal(a, b)
    suffix = _build.ATTENTION_DTYPES[dtype]
    d, layers, heads = cfg.n_text_state, cfg.n_text_layer, cfg.n_text_head
    dh, ta = d // heads, cfg.n_audio_ctx
    want = {("add_layer_norm" + suffix, (rows, d)): (3 * layers + 1) * steps,
            ("decode_self_attention" + suffix,
             (rows * heads, prefix + steps, dh)): layers * steps}
    if int8:
        want.update({
            ("int8_matmul", (rows, d, d)): 6 * layers * steps,
            ("int8_matmul", (rows, d, 4 * d)): layers * steps,
            ("int8_matmul", (rows, 4 * d, d)): layers * steps,
            ("decode_cross_attention_int8",
             (rows, heads, ta, dh, "float32")): layers * steps})
    else:
        want[("decode_cross_attention" + suffix, (rows * heads, ta, dh))] = \
            layers * steps
    assert dict(record) == want


@pytest.mark.parametrize("temperature", [0.0, 0.6])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rows", [1, 2, 4])
def test_captured_loop_equals_eager(dev, rows, mode, temperature):
    """The replayed chunks give the eager chunks' tokens, lengths and
    summed logprobs (same kernels in the same order, same random numbers
    from the same seed), and their launches are counted as launched: a
    step's K3 and K4 of the mode's build."""
    int8, dtype = MODES[mode]
    cfg, graph, eager = _tiny_decoders(dev, int8, dtype)
    xa = _tiny_xa(cfg, dev, rows, 40)
    graph.decode_submit(xa, 0.0)        # captures (its warm-up launches)
    out = {}
    for name, dec in (("graph", graph), ("eager", eager)):
        with _counting() as launches:
            out[name] = dec.decode_submit(xa, temperature, rng_tag=3)
        torch.cuda.synchronize()
        out[name + "_launches"] = launches
    g, e = out["graph"], out["eager"]
    assert graph.captured and not eager.captured
    assert torch.equal(g.tokens, e.tokens)
    assert torch.equal(g.lengths, e.lengths) and g.steps == e.steps
    torch.testing.assert_close(g.sum_logprob, e.sum_logprob, atol=1e-4,
                               rtol=0)
    assert out["graph_launches"] == out["eager_launches"]
    per_step = _step_launches(cfg, int8, dtype)
    extra = 10 * cfg.n_text_layer if int8 else 0
    assert dict(_by_kernel(out["graph_launches"])) == {
        k: v * (g.steps - 1) + (extra if k == "int8_matmul" else 0)
        for k, v in per_step.items()}


@pytest.mark.parametrize("kind", ["greedy", "beam", "timestamps"])
def test_results_leave_as_pinned_copies(dev, kind):
    """A decode's results are pinned host copies filled by copies enqueued
    on the stream before the decoder's lock is released: reading one waits
    for their event, and the next decode on the same buffers leaves them
    as they were."""
    kw = {"beam": {"beam_size": 3},
          "timestamps": {"without_timestamps": False}}.get(kind, {})
    cfg, graph, _ = _mode_decoders(dev, False, **kw)
    submit = (graph.timestamps_submit if kind == "timestamps"
              else lambda xa: graph.decode_submit(xa, 0.0))
    xa, other = _tiny_xa(cfg, dev, 2, 60), _tiny_xa(cfg, dev, 2, 61)
    first = submit(xa)
    second = submit(other)
    assert first._ready is not None
    for name in ("tokens", "sum_logprob", "lengths", "no_speech"):
        t = getattr(first, name)
        assert t.device.type == "cpu" and t.is_pinned(), name
    assert first._ready is None
    again = submit(xa)
    assert torch.equal(first.tokens, again.tokens)
    assert torch.equal(first.lengths, again.lengths)
    assert second.tokens.shape == first.tokens.shape


def _step_launches(cfg, int8, dtype=torch.bfloat16):
    """One decode step's launches: K3 and the cross kernel a layer, the
    fused bias + residual add + LayerNorm 3 a layer and once at the end,
    and with int8 weights 8 K6 a layer."""
    layers = cfg.n_text_layer
    if int8:
        return {"decode_self_attention": layers,
                "decode_cross_attention_int8": layers,
                "int8_matmul": 8 * layers,
                "add_layer_norm": 3 * layers + 1}
    suffix = "_f32" if dtype == torch.float32 else ""
    return {"decode_self_attention" + suffix: layers,
            "decode_cross_attention" + suffix: layers,
            "add_layer_norm" + suffix: 3 * layers + 1}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_capture_records_each_chunks_launches(dev, int8):
    """Each captured chunk's launch delta is its steps times one step's
    launches; the capture itself adds nothing to the bound sink."""
    cfg, graph, _ = _tiny_decoders(dev, int8)
    xa = _tiny_xa(cfg, dev, 2, 41)
    with _counting() as launches:
        out = graph.decode_submit(xa, 0.0)
    (loop,) = graph._loops.values()
    assert sorted(loop.graphs.graphs) == [7, 16]
    per_step = _step_launches(cfg, int8)
    for n, delta in loop.graphs.launch_delta.items():
        assert _by_kernel(delta) == {k: n * v for k, v in per_step.items()}
    # this decode: the warm-up runs before each capture (16 + 7 steps),
    # the loop's replays (out.steps - 1 steps), and with int8 weights the
    # cross K/V's 2 and the prefill's 8 matmuls a layer
    ran = _by_kernel(launches)
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


def _mode_decoders(dev, int8, dtype=torch.bfloat16, **kw):
    """A captured and an eager ``BatchDecoder`` as ``_tiny_decoders``, with
    the options ``kw`` (beam size, timestamp mode)."""
    from manual_whisper_tpu_torch.models.decode import BatchDecoder
    cfg, graph, _ = _tiny_decoders(dev, int8, dtype)
    opts = dataclasses.replace(graph.opts, **kw)
    return (cfg, BatchDecoder(graph.params, cfg, graph.tokenizer, opts, dev),
            BatchDecoder(graph.params, cfg, graph.tokenizer, opts, dev,
                         eager=True))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("rows,beams", [(1, 5), (2, 3)])
def test_captured_beam_loop_equals_eager(dev, rows, beams, int8):
    """The replayed beam chunks give the eager chunks' tokens, lengths and
    summed logprobs; every step ran in a replay; a beam step launches no
    K3/K4/K5, and with int8 weights 8 K6 a layer (at M = rows x beams)."""
    cfg, graph, eager = _mode_decoders(dev, int8, beam_size=beams)
    xa = _tiny_xa(cfg, dev, rows, 44)
    graph.decode_submit(xa, 0.0)        # captures (its warm-up launches)
    out = {}
    for name, dec in (("graph", graph), ("eager", eager)):
        with _counting() as launches:
            out[name] = dec.decode_submit(xa, 0.0)
        torch.cuda.synchronize()
        out[name + "_launches"] = launches
    g, e = out["graph"], out["eager"]
    (loop,) = graph._beam_loops.values()
    assert not graph._loops and loop.graphs is not None
    assert torch.equal(g.tokens, e.tokens)
    assert torch.equal(g.lengths, e.lengths) and g.steps == e.steps
    torch.testing.assert_close(g.sum_logprob, e.sum_logprob, atol=1e-4,
                               rtol=0)
    assert out["graph_launches"] == out["eager_launches"]
    assert sum(n * c for n, c in loop.graphs.replays.items()) == \
        2 * (g.steps - 1)
    layers = cfg.n_text_layer
    expected = ({"int8_matmul": 10 * layers + 8 * layers * (g.steps - 1)}
                if int8 else {})
    assert dict(_by_kernel(out["graph_launches"])) == expected


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rows", [1, 4])
def test_captured_timestamp_loop_equals_eager(dev, rows, mode):
    """The replayed timestamp chunks give the eager chunks' tokens,
    lengths and summed logprobs with the decode step's launches (K3 and K4
    of the mode's build); every step ran in a replay."""
    int8, dtype = MODES[mode]
    cfg, graph, eager = _mode_decoders(dev, int8, dtype,
                                       without_timestamps=False)
    xa = _tiny_xa(cfg, dev, rows, 45)
    graph.timestamps_submit(xa)         # captures
    out = {}
    for name, dec in (("graph", graph), ("eager", eager)):
        with _counting() as launches:
            out[name] = dec.timestamps_submit(xa)
        torch.cuda.synchronize()
        out[name + "_launches"] = launches
    g, e = out["graph"], out["eager"]
    (loop,) = graph._ts_loops.values()
    assert torch.equal(g.tokens, e.tokens)
    assert torch.equal(g.lengths, e.lengths) and g.steps == e.steps
    torch.testing.assert_close(g.sum_logprob, e.sum_logprob, atol=1e-4,
                               rtol=0)
    assert out["graph_launches"] == out["eager_launches"]
    assert sum(n * c for n, c in loop.graphs.replays.items()) == \
        2 * (g.steps - 1)
    per_step = _step_launches(cfg, int8, dtype)
    extra = 10 * cfg.n_text_layer if int8 else 0
    ran = _by_kernel(out["graph_launches"])
    for k, v in per_step.items():
        assert ran[k] == v * (g.steps - 1) + (
            extra if k == "int8_matmul" else 0)


def _bursts(seconds, seed):
    """Seeded harmonic bursts with pauses over a low noise floor."""
    rng = np.random.default_rng(seed)
    sr = 16000
    out = 0.003 * rng.standard_normal(int(seconds * sr)).astype(np.float32)
    for start in np.arange(0.5, seconds - 2.0, 2.5):
        tt = np.arange(int(1.5 * sr)) / sr
        f0 = rng.uniform(110, 260)
        s = int(start * sr)
        out[s:s + len(tt)] += (0.2 * np.sin(2 * np.pi * f0 * tt)
                               * np.sin(np.pi * tt / 1.5)).astype(np.float32)
    return out


@pytest.mark.parametrize("weights", ["random", "repository"])
def test_vad_on_card_equals_cpu(dev, weights):
    """PyanNet on the card against the same weights on the CPU: speech
    probabilities within chip_smoke's TOL["vad"] (1e-3) and equal regions,
    with cuDNN's TF32 switched on globally beforehand (the forward turns it
    off for itself and puts it back)."""
    from pathlib import Path
    from manual_whisper_tpu_torch.convert import (
        convert_pyannote_segmentation, from_jax_pyannet)
    from manual_whisper_tpu_torch.models.vad import (VoiceActivityDetector,
                                                     init_pyannet_params)
    if weights == "random":
        tree = init_pyannet_params(torch.Generator().manual_seed(0))
    else:
        path = (Path(__file__).resolve().parent.parent / ".weights"
                / "pyannote-segmentation-3.0" / "pytorch_model.bin")
        tree = convert_pyannote_segmentation(
            torch.load(str(path), map_location="cpu", weights_only=True))
    audio = _bursts(35.0, 1)
    cpu = VoiceActivityDetector(from_jax_pyannet(tree, torch.device("cpu")))
    card = VoiceActivityDetector(from_jax_pyannet(tree, dev))
    ref, _ = cpu.speech_probs(audio)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        probs, _ = card.speech_probs(audio)
        assert torch.backends.cudnn.allow_tf32
        regions = card(audio)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert probs.shape == ref.shape
    np.testing.assert_allclose(probs, ref, rtol=0, atol=1e-3)
    assert regions == cpu(audio)


# -- two threads: the server's second pass beside a job ----------------------

def test_two_decoders_on_two_threads_equal_one_after_the_other(dev):
    """Two captured decoders (another prompt each, so other loop shapes)
    decoding at once from two threads, each capturing its loops while the
    other replays: the tokens of the same decodes run one after the other,
    and the launches counted into one sink bound on both threads are
    those of the sequential run."""
    from manual_whisper_tpu_torch.models.decode import (BatchDecoder,
                                                        DecodingOptions)
    from manual_whisper_tpu_torch.models.whisper import (MODEL_CONFIGS,
                                                         init_params)
    from manual_whisper_tpu_torch.tokenizer import make_test_tokenizer
    import threading
    cfg = MODEL_CONFIGS["test"].with_dtype(torch.bfloat16)
    params = init_params(cfg, dev, seed=7)
    tk = make_test_tokenizer()

    def decoders():
        return [BatchDecoder(params, cfg, tk, DecodingOptions(
            language="en", max_new_tokens=40, suppress_blank=False,
            initial_prompt=prompt), dev) for prompt in (None, "hello")]
    work = [(_tiny_xa(cfg, dev, rows, 50 + rows), 0.6 * (rows % 2), rows)
            for rows in (1, 2, 4, 2, 1)]

    def run(dec, out, launches):
        with spans.bind({}, "test", launches):
            for xa, temp, tag in work:
                o = dec.decode_submit(xa, temp, rng_tag=tag)
                out.append((o.tokens, o.lengths))

    seq, seq_launches = {}, collections.Counter()
    for i, dec in enumerate(decoders()):
        seq[i] = []
        run(dec, seq[i], seq_launches)
    torch.cuda.synchronize()

    par, par_launches = {0: [], 1: []}, collections.Counter()
    threads = [threading.Thread(target=run,
                                args=(dec, par[i], par_launches))
               for i, dec in enumerate(decoders())]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert par_launches == seq_launches
    for i in (0, 1):
        assert len(par[i]) == len(work)
        for (tok_a, len_a), (tok_b, len_b) in zip(par[i], seq[i]):
            assert torch.equal(tok_a, tok_b) and torch.equal(len_a, len_b)


def test_server_answers_a_wav_request_on_the_card(dev, tmp_path, monkeypatch):
    """The port's job server over the port's ``PipelineBackend`` on the
    card (the ``test`` config, seeded weights, batch 16): upload, create,
    poll to ``succeeded``; the JSON carries segments, cleanup stats and
    the Markdown."""
    import json
    import threading
    import urllib.request
    from manual_whisper_tpu_torch.audio import write_wav
    from manual_whisper_tpu_torch.serving import (PipelineBackend,
                                                  create_server)
    monkeypatch.setenv("WHISPER_MODEL", "test")
    monkeypatch.setenv("ENABLE_SECOND_PASS", "false")
    monkeypatch.delenv("HF_TOKEN", raising=False)
    backend = PipelineBackend()
    assert backend.model.device.type == "cuda" and backend.batch_size == 16
    backend.warmup()
    stats = []
    real_transcribe = backend.model.transcribe

    def transcribe(*a, **k):
        out = real_transcribe(*a, **k)
        stats.append(backend.model.last_stats)
        return out
    monkeypatch.setattr(backend.model, "transcribe", transcribe)
    srv = create_server(backend, host="127.0.0.1", port=0,
                        upload_dir=str(tmp_path / "up"))
    threading.Thread(target=srv.serve_forever, args=(0.05,),
                     daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def req(method, path, body=None, headers=None):
        r = urllib.request.Request(base + path, data=body, method=method,
                                   headers=headers or {})
        with urllib.request.urlopen(r, timeout=60) as resp:
            return json.loads(resp.read().decode())
    try:
        wav = tmp_path / "a.wav"
        write_wav(wav, _bursts(12.0, 3), 16000)
        url = req("POST", "/api/upload", wav.read_bytes(),
                  {"x-file-name": "a.wav"})["fileUrl"]
        job = req("POST", "/api/transcribe",
                  json.dumps({"fileUrl": url, "language": "zh"}).encode())
        import time
        deadline = time.time() + 120
        while True:
            out = req("GET", f"/api/transcribe?id={job['id']}")
            if out["status"] in ("succeeded", "failed"):
                break
            assert time.time() < deadline
            time.sleep(0.1)
    finally:
        srv.shutdown()
        srv.server_close()
    assert out["status"] == "succeeded", out
    body = out["output"]["json"]
    assert isinstance(body["segments"], list)
    assert body["cleanup_stats"]["input_segments"] >= 0
    assert out["output"]["markdown"].startswith("# 录音转写")
    assert len(stats) == 1 and stats[0]["batches"] >= 1
