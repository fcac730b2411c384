"""The control of an int8 configuration's Whisper numbers: the reference
Whisper in the program's place with every block weight rounded to int4,
symmetric per output channel (scale absmax / 7, codes rounded half to
even and clipped to +-7), one precision below the int8 weights that the
configuration states.  A block weight is recognised by its shape, [d, d],
[d, 4 d] or [4 d, d] (as ``x @ w``, input axis first); activations and
the logits' product pass unrounded.  The program's speech probabilities
stay its own."""

import torch

from reference import whisper_ref


def _is_block_weight(x: torch.Tensor) -> bool:
    if x.dim() != 2:
        return False
    k, n = x.shape
    return n == k or n == 4 * k or k == 4 * n


def _int4(x: torch.Tensor) -> torch.Tensor:
    """A block weight rounded to per-output-channel int4; anything else as
    it is."""
    if not _is_block_weight(x):
        return x
    scale = torch.clamp_min(x.abs().amax(dim=0) / 7.0, 1e-10)
    return torch.clamp(torch.round(x / scale), -7, 7) * scale


def products():
    return whisper_ref.rounded_products(_int4)
