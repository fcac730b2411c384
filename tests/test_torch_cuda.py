"""PyTorch port: the CUDA kernels against their plain versions on the card.

Marked ``cuda``; each test skips without a CUDA device (decided inside the
test, never at import).  On the card ``python3 chip_smoke.py`` runs the
same comparisons at large-v3 shapes; these run small shapes, including
the tiny ``test`` config's head_dim 32, ragged lengths and edge lengths.
"""

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
from manual_whisper_tpu_torch.ops.mel import (unnormalized_log_mel,
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


@pytest.mark.parametrize("n_samples,n_mels", [(1601, 80), (48000, 80),
                                              (480000, 128)])
def test_mel_kernel(dev, n_samples, n_mels):
    audio = 0.1 * _randn((2, n_samples), dev, 0, torch.float32)
    before = _build.launches["mel"]
    out = unnormalized_log_mel(audio, n_mels)
    assert _build.launches["mel"] == before + 1
    ref = unnormalized_log_mel_plain(audio, n_mels)
    torch.testing.assert_close(out, ref, atol=2e-3, rtol=0)


@pytest.mark.parametrize("t_q,t_k,dh", [(150, 150, 32), (1500, 1500, 64),
                                        (1, 70, 64)])
def test_flash_kernel(dev, t_q, t_k, dh):
    q = _randn((2, 3, t_q, dh), dev, 1)
    k = _randn((2, 3, t_k, dh), dev, 2)
    v = _randn((2, 3, t_k, dh), dev, 3)
    torch.testing.assert_close(flash_attention(q, k, v).float(),
                               attention_plain(q, k, v).float(),
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


@pytest.mark.parametrize("m", [1, 4, 17, 300])
@pytest.mark.parametrize("k,n", [(64, 256), (1280, 5120)])
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
