"""Whisper fine-tuning step (port of the JAX ``training/train.py``), with
or without a (data, model) mesh.

Loss: teacher-forced cross-entropy over the decoder's logits, predicting
``tokens[:, 1:]`` from ``tokens[:, :-1]``, masked by ``loss_mask[:, 1:]``,
the masked mean over max(mask sum, 1).  The encoder runs its einsum
attention (``encode(..., use_flash=False)``, as the JAX ``loss_fn``
does), which autograd differentiates; K2 has no backward, and the JAX
training path runs no Pallas kernel.  A batch's log-mel comes from
``features`` (K1 on the card), outside autograd.

Optimizer: ``optim.adamw`` (``optax.adamw``'s semantics and defaults),
params and moments updated in place.

With a mesh the step is the JAX step's GSPMD program spelled out: the
params are the rank's shards (``parallel.shard_params``; the moments are
made from them, so they live on the same shards) and the batch the rank's
rows (``parallel.shard_batch``).  The loss is the masked mean over the
global batch, so the label count is all-reduced over the data dim first,
each rank's masked sum is divided by the global count, and the gradients
are summed over the data dim (a mean over ranks, as DDP takes, differs
whenever rows carry different label counts).  Tensor parallelism runs
inside the model functions (``models/whisper.py``), over the mesh's model
group.  Ranks must start from identical params.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from ..models.whisper import WhisperConfig, decoder_forward, encode
from ..ops.mel import log_mel_spectrogram
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_group
from .optim import AdamW, AdamWState, tree_leaves


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: AdamWState
    step: int


def features(audio: torch.Tensor, cfg: WhisperConfig) -> torch.Tensor:
    """Log-mel of a batch of audio [B, samples] (K1 on the card), without
    grad."""
    with torch.no_grad():
        return log_mel_spectrogram(audio, n_mels=cfg.n_mels)


def masked_nll(params, mel: torch.Tensor, tokens: torch.Tensor,
               loss_mask: torch.Tensor, cfg: WhisperConfig, group=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the masked next-token NLL, the mask's sum) of a batch;
    ``group`` is the model group of tensor-parallel shards."""
    tokens = tokens.long()
    xa = encode(params, mel, cfg, use_flash=False, group=group)
    logits, _ = decoder_forward(params, tokens[:, :-1], xa, cfg, group=group)
    mask = loss_mask[:, 1:].float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, None])[..., 0]
    return (nll * mask).sum(), mask.sum()


def loss_fn(params, mel: torch.Tensor, tokens: torch.Tensor,
            loss_mask: torch.Tensor, cfg: WhisperConfig) -> torch.Tensor:
    """Cross entropy: predict tokens[:, 1:] from tokens[:, :-1]."""
    nll, count = masked_nll(params, mel, tokens, loss_mask, cfg)
    return nll / count.clamp_min(1.0)


def init_train_state(params, optimizer: AdamW) -> TrainState:
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=0)


def make_train_step(cfg: WhisperConfig, optimizer: AdamW, mesh=None):
    """The train step ``(state, mel, tokens, loss_mask) -> (state, loss)``:
    the loss of the global batch (a float tensor on the batch's device),
    and ``state`` updated in place.  With ``mesh``, ``state.params`` are
    the rank's shards and the batch the rank's rows."""
    data_group = None if mesh is None else axis_group(mesh, DATA_AXIS)
    model_group = None if mesh is None else axis_group(mesh, MODEL_AXIS)

    def train_step(state: TrainState, mel: torch.Tensor,
                   tokens: torch.Tensor, loss_mask: torch.Tensor
                   ) -> Tuple[TrainState, torch.Tensor]:
        leaves = tree_leaves(state.params)
        if any(not p.is_floating_point() for p in leaves):
            raise ValueError("training needs float params (int8 weights "
                             "have no gradient)")
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                nll, count = masked_nll(state.params, mel, tokens,
                                        loss_mask, cfg, model_group)
                count = _all_sum(count.detach(), data_group)
                loss = nll / count.clamp_min(1.0)
                grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        if data_group is not None:
            for g in grads:
                dist.all_reduce(g, group=data_group)
        optimizer.update(grads, state.opt_state, leaves)
        state.step += 1
        return state, _all_sum(loss.detach(), data_group)

    return train_step


def _all_sum(x: torch.Tensor, group: Optional[Any]) -> torch.Tensor:
    if group is None:
        return x
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x
