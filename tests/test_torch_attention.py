"""PyTorch port: attention kernels' plain versions vs the JAX kernels.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do.  Layouts: the JAX decode kernels take K/V as [B, H, dh, T]; the port
takes [B, H, T, dh], so the tests transpose.  Float32 inputs, atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manual_whisper_tpu.ops import attention as jatt
from manual_whisper_tpu.ops import decode_attention as jdec
from manual_whisper_tpu_torch.ops import _build
from manual_whisper_tpu_torch.ops import attention as tatt
from manual_whisper_tpu_torch.ops import decode_attention as tdec

ATOL = 1e-5


def _mk(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("t_q,t_k", [(150, 150), (128, 300)])
def test_flash_matches_jax_interpret(t_q, t_k):
    q, k, v = (_mk((1, 2, t, 64), s) for s, t in ((0, t_q), (1, t_k),
                                                   (2, t_k)))
    ref = np.asarray(jatt.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), interpret=True))
    out = tatt.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert out.shape == ref.shape == (1, 2, t_q, 64)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_flash_plain_keeps_bf16_dtype():
    q, k, v = (torch.from_numpy(_mk((1, 2, 40, 32), s)).to(torch.bfloat16)
               for s in range(3))
    out = tatt.flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(jatt.reference_attention(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v))),
        np.float32)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2)


@pytest.mark.parametrize("pos", [0, 3, 31, 47])
def test_decode_self_matches_jax_interpret(pos):
    b, h, dh, t_max = 2, 2, 64, 48
    q = _mk((b, h, 1, dh), 9)
    k = _mk((b, h, t_max, dh), 10, 3.0)       # garbage beyond pos
    v = _mk((b, h, t_max, dh), 11, 3.0)
    ref = np.asarray(jdec.decode_self_attention(
        jnp.asarray(q), jnp.asarray(k.transpose(0, 1, 3, 2)),
        jnp.asarray(v.transpose(0, 1, 3, 2)), jnp.int32(pos),
        interpret=True))
    out = tdec.decode_self_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor([pos], dtype=torch.int32))
    assert out.shape == ref.shape == (b, h, 1, dh)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("kv_len", [150, 100, 1])
def test_decode_cross_matches_jax_interpret(kv_len):
    b, h, dh, ta = 2, 3, 64, 150
    q = _mk((b, h, 1, dh), 0)
    k = _mk((b, h, ta, dh), 1)
    v = _mk((b, h, ta, dh), 2)
    ref = np.asarray(jdec.decode_cross_attention(
        jnp.asarray(q), jnp.asarray(k.transpose(0, 1, 3, 2)),
        jnp.asarray(v.transpose(0, 1, 3, 2)), kv_len=kv_len, interpret=True))
    out = tdec.decode_cross_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor([kv_len], dtype=torch.int32))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_cpu_tensors_launch_no_kernel():
    before = dict(_build.launches)
    x = torch.zeros(1, 1, 4, 32)
    tatt.flash_attention(x, x, x)
    tdec.decode_self_attention(x[:, :, :1], x, x,
                               torch.tensor([2], dtype=torch.int32))
    tdec.decode_cross_attention(x[:, :, :1], x, x,
                                torch.tensor([4], dtype=torch.int32))
    assert dict(_build.launches) == before
