"""PyTorch port: int8 weights (K6's plain version) and int8 cross K/V (K5's
plain version) vs the JAX package.

Inputs come from a numpy seed or ``init_params_host``; both sides get the
same arrays.  Quantization must be bit-equal (codes and scales).  The
matmul and attention plain versions are held to the JAX functions in
float32: atol 1e-4 for the matmul (as ``tests/test_quant.py``), 1e-5 for
the attention (as the other decode kernels).  The JAX decode kernels take
K/V as [B, H, dh, T] and scales as [B, H, 1, T]; the port takes
[B, H, T, dh] and [B, H, T], so the tests transpose.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manual_whisper_tpu.models import whisper as jw
from manual_whisper_tpu.ops import decode_attention as jdec
from manual_whisper_tpu.ops import quant as jq
from manual_whisper_tpu_torch.convert import from_jax_tree
from manual_whisper_tpu_torch.models import whisper as tw
from manual_whisper_tpu_torch.ops import _build
from manual_whisper_tpu_torch.ops import decode_attention as tdec
from manual_whisper_tpu_torch.ops import quant as tq

CPU = torch.device("cpu")
JCFG = jw.MODEL_CONFIGS["test"]
TCFG = tw.MODEL_CONFIGS["test"]


def _mk(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _bits(t):
    """bf16/f32 tensor or array -> integer bits, for bit-equality."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16 if t.dtype == torch.bfloat16
                      else torch.int32).numpy()
    a = np.asarray(t)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("key", tq._QUANT_KEYS)
def test_quantize_weight_matches_jax(key):
    tree = jw.init_params_host(0, JCFG)
    sub = "mlp" if key.startswith("fc") else "attn"
    w = tree["encoder"]["blocks"][sub][key]          # stacked [L, K, N]
    ref = jq.quantize_weight(w)
    out = tq.quantize_weight(torch.from_numpy(w))
    assert out["q"].dtype == torch.int8 and out["s"].dtype == torch.float32
    np.testing.assert_array_equal(out["q"].numpy(), ref["q"])
    np.testing.assert_array_equal(_bits(out["s"]), _bits(ref["s"]))


def test_quantize_params_and_bridge_match_jax():
    """The bridge carries JAX {q, s} leaves as per-layer int8/f32 tensors,
    bit-equal, and the port's own quantize_params gives the same tree."""
    host = jw.init_params_host(0, JCFG)
    jtree = jq.quantize_params(host)
    bridged = from_jax_tree(jtree, TCFG, CPU)
    own = tq.quantize_params(from_jax_tree(host, TCFG, CPU))
    for part, n_layers in (("encoder", JCFG.n_audio_layer),
                           ("decoder", JCFG.n_text_layer)):
        for layer in range(n_layers):
            for sub, key in [("attn", k) for k in ("q_w", "k_w", "v_w",
                                                    "o_w")] + \
                    [("mlp", "fc1_w"), ("mlp", "fc2_w")]:
                ref = jtree[part]["blocks"][sub][key]
                for tree in (bridged, own):
                    got = tree[part]["blocks"][layer][sub][key]
                    assert got["q"].dtype == torch.int8
                    assert got["s"].dtype == torch.float32
                    np.testing.assert_array_equal(got["q"].numpy(),
                                                  ref["q"][layer])
                    np.testing.assert_array_equal(_bits(got["s"]),
                                                  _bits(ref["s"][layer]))
    # norms, biases and embeddings are not quantized
    blk = own["decoder"]["blocks"][0]
    assert isinstance(blk["attn"]["q_b"], torch.Tensor)
    assert isinstance(own["decoder"]["tok_emb"], torch.Tensor)
    # quantizing twice is the identity (quantized leaves pass through)
    again = tq.quantize_params(own)
    assert again["encoder"]["blocks"][1]["mlp"]["fc1_w"] is \
        own["encoder"]["blocks"][1]["mlp"]["fc1_w"]


@pytest.mark.parametrize("m", [1, 4, 17])
def test_int8_matmul_plain_matches_jax(m):
    k, n = 64, 256
    x = _mk((m, k), 1)
    wq = jq.quantize_weight(_mk((k, n), 2, 0.125))
    ref_mm = np.asarray(jq.mm(jnp.asarray(x), wq))
    ref_pallas = np.asarray(jq.int8_matmul_pallas(
        jnp.asarray(x), jnp.asarray(wq["q"]), jnp.asarray(wq["s"]),
        interpret=True))
    out = tq.int8_matmul(torch.from_numpy(x), torch.from_numpy(wq["q"]),
                         torch.from_numpy(wq["s"]))
    assert out.dtype == torch.float32 and out.shape == (m, n)
    np.testing.assert_allclose(out.numpy(), ref_mm, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), ref_pallas, atol=1e-4)


def test_mm_dispatches_on_the_weight():
    x = torch.from_numpy(_mk((2, 3, 64), 3))
    w = torch.from_numpy(_mk((64, 32), 4, 0.125))
    torch.testing.assert_close(tq.mm(x, w), x @ w)
    wq = tq.quantize_weight(w)
    y = tq.mm(x, wq)
    assert y.shape == (2, 3, 32)
    torch.testing.assert_close(
        y, tq.int8_matmul_plain(x.reshape(6, 64), wq["q"],
                                wq["s"]).reshape(2, 3, 32))
    # dequantization error of int8: at most half a step per weight
    torch.testing.assert_close(y, x @ w, atol=0.05, rtol=0)


def _cross_kv(seed, b=2, h=3, ta=150, dh=64):
    """JAX-layout ([B, H, dh, Ta]) K/V from a seed."""
    return (_mk((b, h, dh, ta), seed), _mk((b, h, dh, ta), seed + 1, 2.0))


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_quantize_cross_kv_matches_jax(scale_dtype):
    k, v = _cross_kv(5)
    ref = jw.quantize_cross_kv((jnp.asarray(k), jnp.asarray(v)),
                               scale_dtype=getattr(jnp, scale_dtype))
    out = tw.quantize_cross_kv(
        torch.from_numpy(k.transpose(0, 1, 3, 2)),
        torch.from_numpy(v.transpose(0, 1, 3, 2)),
        getattr(torch, scale_dtype))
    for got, want in zip(out, ref):
        want = np.asarray(want)
        if got.dtype == torch.int8:
            np.testing.assert_array_equal(got.numpy(),
                                          want.transpose(0, 1, 3, 2))
        else:
            assert got.dtype == getattr(torch, scale_dtype)
            np.testing.assert_array_equal(_bits(got), _bits(want[:, :, 0]))


def _port_int8(k, v, scale_dtype=torch.float32):
    return tw.quantize_cross_kv(torch.from_numpy(k.transpose(0, 1, 3, 2)),
                                torch.from_numpy(v.transpose(0, 1, 3, 2)),
                                scale_dtype)


def _jax_layout(kv4):
    """Port (k_q, k_s, v_q, v_s) -> the JAX layout, as numpy/jnp."""
    k_q, k_s, v_q, v_s = kv4

    def scales(s):
        if s.dtype == torch.bfloat16:
            return jnp.asarray(s.float().numpy()[:, :, None, :], jnp.bfloat16)
        return jnp.asarray(s.numpy()[:, :, None, :])
    return (jnp.asarray(k_q.numpy().transpose(0, 1, 3, 2)), scales(k_s),
            jnp.asarray(v_q.numpy().transpose(0, 1, 3, 2)), scales(v_s))


@pytest.mark.parametrize("kv_len", [150, 100, 1])
def test_int8_cross_matches_jax_interpret(kv_len):
    q = _mk((2, 3, 1, 64), 0)
    kv4 = _port_int8(*_cross_kv(1))
    ref = np.asarray(jdec.decode_cross_attention_int8(
        jnp.asarray(q), *_jax_layout(kv4), kv_len=kv_len, interpret=True))
    out = tdec.decode_cross_attention_int8(
        torch.from_numpy(q), *kv4, torch.tensor([kv_len], dtype=torch.int32))
    assert out.shape == ref.shape == (2, 3, 1, 64)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_int8_cross_matches_jax_einsum(scale_dtype):
    """Against the einsum ``_cross_attend`` (the JAX decode default), with
    f32 and bf16 scales: the Pallas kernel's bf16-scale case is untested
    in the JAX package, the einsum is its reference."""
    q = _mk((2, 3, 1, 64), 7)
    kv4 = _port_int8(*_cross_kv(8), scale_dtype)
    ref = np.asarray(jw._cross_attend(jnp.asarray(q), _jax_layout(kv4), 64))
    out = tdec.attend_int8_plain(torch.from_numpy(q), *kv4)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    # decode-step wrapper with every position valid: the same function
    full = tdec.decode_cross_attention_int8(
        torch.from_numpy(q), *kv4, torch.tensor([150], dtype=torch.int32))
    torch.testing.assert_close(full, out, atol=1e-6, rtol=0)


def test_int8_cross_bf16_query_matches_jax_einsum():
    """bf16 activations (what compute_type="int8" runs): within 2e-2, two
    bf16 roundings of outputs of magnitude below 4."""
    q = _mk((2, 3, 1, 64), 9)
    kv4 = _port_int8(*_cross_kv(10), torch.bfloat16)
    qb = jnp.asarray(q, jnp.bfloat16)
    ref = np.asarray(jw._cross_attend(qb, _jax_layout(kv4), 64), np.float32)
    out = tdec.attend_int8_plain(
        torch.from_numpy(q).to(torch.bfloat16), *kv4)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2)


def test_int8_cpu_tensors_launch_no_kernel():
    before = dict(_build.launches)
    x = torch.zeros(3, 64, dtype=torch.bfloat16)
    wq = tq.quantize_weight(torch.ones(64, 32))
    tq.mm(x, wq)
    kv4 = tw.quantize_cross_kv(torch.ones(1, 2, 8, 32), torch.ones(1, 2, 8, 32))
    tdec.decode_cross_attention_int8(x[:2, :32].reshape(1, 2, 1, 32), *kv4,
                                     torch.tensor([8], dtype=torch.int32))
    assert dict(_build.launches) == before
