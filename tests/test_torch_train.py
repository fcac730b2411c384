"""PyTorch port: the fine-tuning step against the JAX package's.

Same weights (``init_params_host`` through the bridge), same batch from a
numpy seed, float32 on both sides, the ``test`` config:

- ``encode(use_flash=False)`` against JAX ``encode`` (its einsum branch);
- ``loss_fn`` within 1e-5 relative, with a row whose mask is all zero;
- every gradient leaf against ``jax.grad`` within 1e-4 of the leaf's
  largest magnitude (through ``convert.to_jax_tree``);
- three AdamW updates against ``optax.adamw`` on the same gradients (JAX's
  at JAX's params, each step), at a constant lr and on the warmup-cosine
  schedule: params, both moments and the count within ADAM_TOL of each
  leaf's largest magnitude; a planted weight decay of 1e-2 must exceed
  it.  The optimizers get the same gradients because Adam's first update
  is lr * g / (|g| + eps): where |g| is near eps a gradient's last bits
  move the update by a good part of lr, so two gradient computations
  cannot be held to a tolerance that catches the fault.  The whole steps
  (each side's own gradients) are held by their losses, within 1e-5.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from cpu_budget import one_torch_thread  # noqa: F401
from manual_whisper_tpu.models import whisper as jw
from manual_whisper_tpu.ops.quant import quantize_params as jquantize
from manual_whisper_tpu.training import train as jt
from manual_whisper_tpu_torch.convert import from_jax_tree, to_jax_tree
from manual_whisper_tpu_torch.models import whisper as tw
from manual_whisper_tpu_torch.training import optim as to
from manual_whisper_tpu_torch.training import train as tt

CPU = torch.device("cpu")
JCFG = jw.MODEL_CONFIGS["test"]
TCFG = tw.MODEL_CONFIGS["test"]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's largest magnitude
# of each leaf's largest magnitude; measured 8.0e-8 at most (params; the
# moments are bit-equal), while the planted weight decay moves the params
# by 3.0e-5 of it
ADAM_TOL = 1e-6


@pytest.fixture(scope="module")
def tree():
    return jw.init_params_host(0, JCFG)


def _batch(seed=0, rows=3, length=10):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((rows, JCFG.n_mels, 2 * JCFG.n_audio_ctx)
                              ).astype(np.float32)
    tokens = rng.integers(0, JCFG.n_vocab, (rows, length)).astype(np.int32)
    mask = np.ones((rows, length), np.float32)
    mask[1, :4] = 0.0            # a prompt left out of the loss
    mask[2] = 0.0                # a row with no labels at all
    return mel, tokens, mask


def _torch(batch):
    return tuple(torch.from_numpy(x) for x in batch)


def _leaf_errors(got, want):
    """{path: max |got - want| / max |want|} over two JAX-layout trees."""
    out = {}

    def walk(a, b, path):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
            return
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, path
        out[path] = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    walk(got, want, "")
    return out


def test_encode_einsum_matches_jax(tree):
    mel = _batch()[0]
    ref = jw.encode(tree, jnp.asarray(mel), JCFG)
    out = tw.encode(from_jax_tree(tree, TCFG, CPU), torch.from_numpy(mel),
                    TCFG, use_flash=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


def test_loss_matches_jax(tree):
    batch = _batch()
    ref = float(jt.loss_fn(tree, *map(jnp.asarray, batch), JCFG))
    got = float(tt.loss_fn(from_jax_tree(tree, TCFG, CPU), *_torch(batch),
                           TCFG))
    assert abs(got - ref) <= LOSS_RTOL * abs(ref), (got, ref)
    # a batch with no labels: the mean over max(count, 1) is 0
    empty = (batch[0], batch[1], np.zeros_like(batch[2]))
    assert float(tt.loss_fn(from_jax_tree(tree, TCFG, CPU), *_torch(empty),
                            TCFG)) == 0.0


def _port_grads(params, batch):
    leaves = to.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = tt.loss_fn(params, *_torch(batch), TCFG)
    grads = iter(torch.autograd.grad(loss, leaves))
    for p in leaves:
        p.requires_grad_(False)
    return to.tree_map(lambda _: next(grads), params)


def test_grads_match_jax(tree):
    batch = _batch()
    ref = jax.grad(jt.loss_fn)(tree, *map(jnp.asarray, batch), JCFG)
    got = to_jax_tree(_port_grads(from_jax_tree(tree, TCFG, CPU), batch))
    errs = _leaf_errors(got, jax.tree.map(np.asarray, ref))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


def _adam_run(tree, lr, weight_decay=1e-4, steps=3):
    """Both optimizers over ``steps`` updates from JAX's gradients at JAX's
    params; returns (JAX params, state, port params, port state)."""
    if lr == "schedule":
        jlr = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup_steps=2,
                                                 decay_steps=5)
        tlr = to.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 5)
    else:
        jlr = tlr = lr
    joptim = optax.adamw(jlr)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = joptim.init(jparams)
    toptim = to.adamw(tlr, weight_decay=weight_decay)
    tparams = from_jax_tree(tree, TCFG, CPU)
    tstate = toptim.init(tparams)
    for step in range(steps):
        batch = _batch(seed=step)
        g = jax.grad(jt.loss_fn)(jparams, *map(jnp.asarray, batch), JCFG)
        updates, jstate = joptim.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tg = from_jax_tree(jax.tree.map(np.asarray, g), TCFG, CPU)
        toptim.update(to.tree_leaves(tg), tstate, tparams)
    return jparams, jstate, tparams, tstate


def _adam_errors(tree, lr, weight_decay=1e-4):
    jparams, jstate, tparams, tstate = _adam_run(tree, lr, weight_decay)
    adam = jstate[0]
    assert tstate.count == int(adam.count) == 3
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"params": _leaf_errors(to_jax_tree(tparams), as_np(jparams)),
            "mu": _leaf_errors(to_jax_tree(tstate.mu), as_np(adam.mu)),
            "nu": _leaf_errors(to_jax_tree(tstate.nu), as_np(adam.nu))}


@pytest.mark.parametrize("lr", [1e-3, "schedule"])
def test_adamw_matches_optax(tree, lr):
    errs = _adam_errors(tree, lr)
    for what, per_leaf in errs.items():
        worst = max(per_leaf, key=per_leaf.get)
        assert per_leaf[worst] <= ADAM_TOL, (what, worst, per_leaf[worst])


def test_adamw_weight_decay_fault_is_caught(tree):
    """torch's AdamW default (1e-2) in place of optax's (1e-4)."""
    errs = _adam_errors(tree, 1e-3, weight_decay=1e-2)
    assert max(errs["params"].values()) > 10 * ADAM_TOL


def test_schedule_matches_optax():
    ref = optax.warmup_cosine_decay_schedule(1e-5, 1e-3, warmup_steps=3,
                                             decay_steps=10, end_value=1e-4)
    got = to.warmup_cosine_decay_schedule(1e-5, 1e-3, 3, 10, end_value=1e-4)
    for count in range(14):
        assert got(count) == pytest.approx(float(ref(count)), rel=1e-6,
                                           abs=1e-12), count


def test_train_steps_match_jax(tree):
    """Three whole steps on each side (own gradients): the losses."""
    jstate = jt.init_train_state(jax.tree.map(jnp.asarray, tree),
                                 optax.adamw(1e-3))
    jstep = jt.make_train_step(JCFG, optax.adamw(1e-3))
    optimizer = to.adamw(1e-3)
    tstate = tt.init_train_state(from_jax_tree(tree, TCFG, CPU), optimizer)
    tstep = tt.make_train_step(TCFG, optimizer)
    for step in range(3):
        batch = _batch(seed=step)
        jstate, jloss = jstep(jstate, *map(jnp.asarray, batch))
        tstate, tloss = tstep(tstate, *_torch(batch))
        assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(
            float(jloss)), (step, float(tloss), float(jloss))
    assert tstate.step == int(jstate.step) == 3


def test_step_is_in_place_and_bf16_moments_stay_bf16():
    cfg = TCFG.with_dtype(torch.bfloat16)
    optimizer = to.adamw(1e-3)
    state = tt.init_train_state(tw.init_params(cfg, CPU, seed=1), optimizer)
    leaves = (to.tree_leaves(state.params) + to.tree_leaves(state.opt_state.mu)
              + to.tree_leaves(state.opt_state.nu))
    ptrs = [t.data_ptr() for t in leaves]
    before = state.params["decoder"]["tok_emb"].clone()
    state, loss = tt.make_train_step(cfg, optimizer)(state,
                                                     *_torch(_batch()))
    assert torch.isfinite(loss)
    assert [t.data_ptr() for t in leaves] == ptrs
    assert not torch.equal(before, state.params["decoder"]["tok_emb"])
    assert {t.dtype for t in leaves} == {torch.bfloat16}
    assert not any(t.requires_grad for t in to.tree_leaves(state.params))


def test_train_path_never_calls_flash_attention(monkeypatch):
    def refuse(*args):
        raise AssertionError("the train step ran the flash kernel's path")
    monkeypatch.setattr(tw, "flash_attention", refuse)
    optimizer = to.adamw(1e-3)
    state = tt.init_train_state(tw.init_params(TCFG, CPU, seed=0), optimizer)
    _, loss = tt.make_train_step(TCFG, optimizer)(state, *_torch(_batch()))
    assert torch.isfinite(loss)
    with pytest.raises(AssertionError, match="flash"):
        tw.encode(state.params, _torch(_batch())[0], TCFG)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_to_jax_tree_round_trip(kind):
    cfg = JCFG.with_dtype(jnp.bfloat16 if kind == "bfloat16"
                          else jnp.float32)
    tree = jw.init_params_host(2, cfg)
    if kind == "int8":
        tree = jquantize(tree)
    tcfg = TCFG.with_dtype(torch.bfloat16 if kind == "bfloat16"
                           else torch.float32)
    params = from_jax_tree(tree, tcfg, CPU)
    back = to_jax_tree(params)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8)),
        back, tree)
    jax.tree.map(lambda a, b: (a.dtype == b.dtype) or pytest.fail(
        f"{a.dtype} != {b.dtype}"), back, tree)
    again = from_jax_tree(back, tcfg, CPU)
    for a, b in zip(to.tree_leaves(again), to.tree_leaves(params),
                    strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
