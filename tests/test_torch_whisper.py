"""PyTorch port: the weight bridge and the Whisper forward vs the JAX package.

Same weights (``init_params_host`` or the committed ``.synth_ckpt``), same
inputs from a numpy seed.  Float32 on both sides; atol 1e-4 and rtol 1e-4
because the summation order differs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manual_whisper_tpu.convert.from_hf import load_params
from manual_whisper_tpu.models import whisper as jw
from manual_whisper_tpu.ops.quant import is_quantized, quantize_params
from manual_whisper_tpu_torch.convert import from_jax_tree
from manual_whisper_tpu_torch.models import whisper as tw

TOL = dict(atol=1e-4, rtol=1e-4)
CPU = torch.device("cpu")
JCFG = jw.MODEL_CONFIGS["test"]
TCFG = tw.MODEL_CONFIGS["test"]


@pytest.fixture(scope="module")
def synth():
    params = load_params(".synth_ckpt")
    if params is None:
        pytest.skip("no committed synth checkpoint")
    return params, from_jax_tree(params, TCFG, CPU)


def _mel(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (batch, TCFG.n_mels, 2 * TCFG.n_audio_ctx)).astype(np.float32)


def _close(out, ref):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), **TOL)


def test_configs_match_jax():
    for name, jc in jw.MODEL_CONFIGS.items():
        tc = tw.MODEL_CONFIGS[name]
        for field in ("n_mels", "n_vocab", "n_audio_ctx", "n_audio_state",
                      "n_audio_head", "n_audio_layer", "n_text_ctx",
                      "n_text_state", "n_text_head", "n_text_layer",
                      "num_languages"):
            assert getattr(tc, field) == getattr(jc, field), (name, field)
    np.testing.assert_array_equal(tw.sinusoids(150, 64),
                                  jw.sinusoids(150, 64))


def test_bridge_layout_on_init_params_host():
    tree = jw.init_params_host(0, JCFG)
    p = from_jax_tree(tree, TCFG, CPU)
    assert len(p["encoder"]["blocks"]) == JCFG.n_audio_layer
    assert len(p["decoder"]["blocks"]) == JCFG.n_text_layer
    np.testing.assert_array_equal(
        p["encoder"]["conv1_w"].numpy(),
        tree["encoder"]["conv1_w"].transpose(2, 1, 0))
    np.testing.assert_array_equal(
        p["decoder"]["blocks"][1]["xattn"]["k_w"].numpy(),
        tree["decoder"]["blocks"]["xattn"]["k_w"][1])
    np.testing.assert_array_equal(
        p["encoder"]["blocks"][0]["mlp"]["fc1_b"].numpy(),
        tree["encoder"]["blocks"]["mlp"]["fc1_b"][0])


def test_bridge_layout_matches_random_init():
    """The port's own seeded init builds the same tree the bridge builds."""
    ref = from_jax_tree(jw.init_params_host(0, JCFG), TCFG, CPU)
    own = tw.init_params(TCFG, CPU, seed=0)

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape), t.dtype
    assert shapes(own) == shapes(ref)
    again = tw.init_params(TCFG, CPU, seed=0)
    assert torch.equal(own["decoder"]["tok_emb"], again["decoder"]["tok_emb"])


def test_bridge_bf16_leaves_bit_exact():
    cfg = JCFG.with_dtype(jnp.bfloat16)
    tree = jw.init_params_host(1, cfg)
    leaf = tree["decoder"]["tok_emb"]
    assert leaf.dtype.name == "bfloat16"
    p = from_jax_tree(tree, TCFG.with_dtype(torch.bfloat16), CPU)
    got = p["decoder"]["tok_emb"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  leaf.view(np.int16))
    q_w = tree["encoder"]["blocks"]["attn"]["q_w"][1]
    np.testing.assert_array_equal(
        p["encoder"]["blocks"][1]["attn"]["q_w"].view(torch.int16).numpy(),
        q_w.view(np.int16))


def test_bridge_rejects_int8_leaves():
    """int8 {q, s} leaves cross as per-layer int8/f32 tensors (not cast to
    the config's dtype); a malformed one is rejected."""
    tree = quantize_params(jw.init_params_host(0, JCFG))
    p = from_jax_tree(tree, TCFG.with_dtype(torch.bfloat16), CPU)
    w = p["decoder"]["blocks"][1]["mlp"]["fc2_w"]
    assert w["q"].dtype == torch.int8 and w["s"].dtype == torch.float32
    np.testing.assert_array_equal(
        w["q"].numpy(), tree["decoder"]["blocks"]["mlp"]["fc2_w"]["q"][1])
    assert p["decoder"]["blocks"][1]["mlp"]["fc2_b"].dtype == torch.bfloat16
    bad = tree["encoder"]["blocks"]["attn"]["q_w"]
    bad["q"] = bad["q"].astype(np.float32)
    with pytest.raises(ValueError, match="int8"):
        from_jax_tree(tree, TCFG, CPU)


def test_encode_matches_jax(synth):
    jparams, tparams = synth
    mel = _mel()
    ref = jw.encode(jparams, jnp.asarray(mel), JCFG)
    out = tw.encode(tparams, torch.from_numpy(mel), TCFG)
    assert out.shape == ref.shape == (2, TCFG.n_audio_ctx, 64)
    _close(out.numpy(), ref)


def test_cross_kv_and_decoder_match_jax(synth):
    """precompute_cross_kv, prefill logits and three decode steps."""
    jparams, tparams = synth
    xa_np = np.array(jw.encode(jparams, jnp.asarray(_mel(1)), JCFG))
    xa = torch.from_numpy(xa_np)
    b, L = 2, JCFG.n_text_layer
    prefix = [257, 258, 259, 362]
    steps = 3
    cache_len = len(prefix) + steps

    jk, jv = jw.precompute_cross_kv(jparams, jnp.asarray(xa_np), JCFG)
    tcross = tw.precompute_cross_kv(tparams, xa, TCFG)
    for layer in range(L):          # JAX keeps [B, H, dh, Ta]
        _close(tcross[layer][0].numpy(),
               np.swapaxes(np.asarray(jk[layer]), -1, -2))
        _close(tcross[layer][1].numpy(),
               np.swapaxes(np.asarray(jv[layer]), -1, -2))

    toks = np.tile(np.asarray(prefix, np.int32), (b, 1))
    jcache = jw.init_kv_cache(JCFG, b, max_len=cache_len)
    jlogits, jcache = jw.decoder_forward(
        jparams, jnp.asarray(toks), None, JCFG, pos_offset=0,
        kv_cache=jcache, cross_kv=(jk, jv))
    tcache = tw.init_kv_cache(TCFG, b, cache_len, CPU)
    tlogits, tcache = tw.decoder_forward(
        tparams, torch.from_numpy(toks).long(), None, TCFG, 0, tcache,
        tcross)
    assert tlogits.dtype == torch.float32
    _close(tlogits.numpy(), jlogits)

    dec_u = jw.unstack_decoder(jparams, JCFG)
    cross_layers = jw.unstack_cross_kv((jk, jv), L)
    positions = torch.arange(cache_len, dtype=torch.int32)
    lengths_cross = torch.tensor([xa.shape[1]], dtype=torch.int32)
    emb32 = tparams["decoder"]["tok_emb"].float()
    for i, tok in enumerate((70, 80, 90)):
        pos = len(prefix) + i
        jl, jcache = jw.decode_step(dec_u, jnp.full((b,), tok, jnp.int32),
                                    jnp.int32(pos), jcache, cross_layers,
                                    JCFG)
        tl = tw.decode_step(
            tparams, torch.full((b,), tok, dtype=torch.long),
            tw.StepLengths(positions[pos:pos + 1], lengths_cross),
            tcache, tcross, TCFG, emb32)
        _close(tl.numpy(), jl)


def test_decoder_forward_rejects_offset_without_cache(synth):
    _, tparams = synth
    with pytest.raises(ValueError):
        tw.decoder_forward(tparams, torch.zeros(1, 2, dtype=torch.long),
                           torch.zeros(1, 150, 64), TCFG, pos_offset=3)


def _int8_decoder_logits(jparams, tparams, jcfg, tcfg, scale_dtype, xa_np):
    """Prefill logits and three decode-step logits with int8 cross K/V, on
    both sides (JAX: einsum ``_cross_attend``; port: K5's plain version)."""
    xa = torch.from_numpy(xa_np).to(tcfg.dtype)
    b, L = xa_np.shape[0], jcfg.n_text_layer
    prefix = [257, 258, 259, 362]
    cache_len = len(prefix) + 3
    jcross = jw.precompute_cross_kv(
        jparams, jnp.asarray(xa_np, jcfg.dtype), jcfg, quantize=True,
        scale_dtype=getattr(jnp, str(scale_dtype).split(".")[-1]))
    tcross = tw.precompute_cross_kv(tparams, xa, tcfg, quantize=True,
                                    scale_dtype=scale_dtype)
    assert len(tcross) == L and len(tcross[0]) == 4
    assert tcross[0][0].dtype == torch.int8
    assert tcross[0][1].dtype == scale_dtype
    toks = np.tile(np.asarray(prefix, np.int32), (b, 1))
    jcache = jw.init_kv_cache(jcfg, b, max_len=cache_len)
    jlog, jcache = jw.decoder_forward(
        jparams, jnp.asarray(toks), None, jcfg, pos_offset=0,
        kv_cache=jcache, cross_kv=jcross)
    tcache = tw.init_kv_cache(tcfg, b, cache_len, CPU)
    tlog, tcache = tw.decoder_forward(
        tparams, torch.from_numpy(toks).long(), None, tcfg, 0, tcache,
        tcross)
    out, ref = [tlog.numpy()], [np.asarray(jlog)]
    dec_u = jw.unstack_decoder(jparams, jcfg)
    cross_layers = jw.unstack_cross_kv(jcross, L)
    positions = torch.arange(cache_len, dtype=torch.int32)
    cross_len = torch.tensor([xa.shape[1]], dtype=torch.int32)
    emb32 = tparams["decoder"]["tok_emb"].float()
    for i, tok in enumerate((70, 80, 90)):
        pos = len(prefix) + i
        jl, jcache = jw.decode_step(dec_u, jnp.full((b,), tok, jnp.int32),
                                    jnp.int32(pos), jcache, cross_layers,
                                    jcfg)
        tl = tw.decode_step(
            tparams, torch.full((b,), tok, dtype=torch.long),
            tw.StepLengths(positions[pos:pos + 1], cross_len),
            tcache, tcross, tcfg, emb32)
        out.append(tl.numpy())
        ref.append(np.asarray(jl))
    return out, ref


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_int8_cross_kv_and_decoder_match_jax(synth, scale_dtype):
    """int8 weights and int8 cross K/V at float32 activations: prefill and
    decode-step logits within 1e-4."""
    jparams = quantize_params(synth[0])
    tparams = from_jax_tree(jparams, TCFG, CPU)
    xa_np = np.array(jw.encode(jparams, jnp.asarray(_mel(2)), JCFG))
    torch.testing.assert_close(
        tw.encode(tparams, torch.from_numpy(_mel(2)), TCFG),
        torch.from_numpy(xa_np), **TOL)
    out, ref = _int8_decoder_logits(jparams, tparams, JCFG, TCFG,
                                    scale_dtype, xa_np)
    for o, r in zip(out, ref):
        _close(o, r)


def test_int8_bf16_activations_match_jax(synth):
    """What ``load_model(compute_type="int8")`` runs: bf16 activations,
    int8 weights, int8 cross K/V with f32 scales, both sides in bf16.  The
    two frameworks round bf16 at other places: on the CPU the logits (std
    0.74-0.85) differed by at most 0.038; the limit is 0.1."""
    jcfg = JCFG.with_dtype(jnp.bfloat16)
    tcfg = TCFG.with_dtype(torch.bfloat16)
    jparams = quantize_params(synth[0])
    tparams = from_jax_tree(jparams, tcfg, CPU)

    def to_bf16(node):
        if is_quantized(node):
            return node
        if isinstance(node, dict):
            return {k: to_bf16(v) for k, v in node.items()}
        return jnp.asarray(node, jnp.bfloat16)
    jbf = to_bf16(jparams)
    xa_np = np.array(jw.encode(jparams, jnp.asarray(_mel(3)), JCFG))
    out, ref = _int8_decoder_logits(jbf, tparams, jcfg, tcfg, torch.float32,
                                    xa_np)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, np.asarray(r, np.float32), atol=0.1)
