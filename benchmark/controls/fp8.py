"""The control of a bfloat16 configuration's Whisper numbers: the
reference Whisper in the program's place with every linear product (the
blocks' and the logits') computed from operands rounded to float8 e4m3
with one scale a tensor, the usual fp8 recipe, one precision below
bfloat16.  The program's speech probabilities stay its own."""

import torch

from reference import whisper_ref


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` as float8 e4m3 holds it, scaled to its largest value."""
    scale = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def products():
    return whisper_ref.rounded_products(_e4m3)
