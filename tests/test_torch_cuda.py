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
from manual_whisper_tpu_torch.ops.decode_attention import (
    attend_plain, decode_cross_attention, decode_self_attention)
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
