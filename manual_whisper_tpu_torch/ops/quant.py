"""Int8 weight-only quantization and the W8A16 matmul: wrapper of kernel K6
(``csrc/int8_matmul.cu``).

Port of the JAX package's ``ops/quant.py``: block matmul weights become
``{"q": int8 [K, N], "s": float32 [N]}`` (symmetric, per output channel,
over the K axis), activations stay bf16 (the reference's CTranslate2
``compute_type="int8"`` scheme).  ``mm`` is the model's matmul helper: a
tensor weight gives ``x @ w``; a ``{q, s}`` weight gives ``int8_matmul``,
which launches K6 on a CUDA tensor and runs ``int8_matmul_plain`` on a CPU
tensor.  K6 replaces ``_int8_mm_kernel`` / ``int8_matmul_pallas``; in the
JAX package that kernel is only tested and ``mm`` goes through XLA, in the
port K6 carries every int8 block matmul.

K6 picks its route by M alone.  M <= 16 (every decode step of the greedy,
timestamp and beam loops up to 16 rows, such as the benchmark's batch of
16) goes to ``matvec_kernel``, which streams the codes from device memory
into tensor-core fragments and splits K over warps and clusters, so that
a decode shape fills the card's SMs.  M > 16 (encoder, cross K/V,
prefill, larger beam steps) goes to ``tile_kernel``, whose blocks are 128
rows: at M <= 16 most of each x tile would be zeros, and one block per
column tile would leave most SMs idle while each block walks all of K.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..spans import count
from . import _build

# weights quantized inside transformer blocks (biases and norms excluded)
_QUANT_KEYS = ("q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w")


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 of w [..., K, N]: scale
    max(absmax over K / 127, 1e-10), codes round-half-even, clipped to
    +-127.  Returns {"q": int8 [..., K, N], "s": float32 [..., N]}."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp_min(absmax / 127.0, 1e-10)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale[..., 0, :]}


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def quantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize every block matmul weight (``_QUANT_KEYS``) of the port's
    weights; embeddings, convolutions, positions, norms and biases keep
    their dtype.  Already-quantized leaves pass through."""
    def block(blk):
        return {name: ({k: (quantize_weight(v) if k in _QUANT_KEYS
                            and not is_quantized(v) else v)
                        for k, v in sub.items()}
                       if isinstance(sub, dict) else sub)
                for name, sub in blk.items()}

    return {part: {**params[part],
                   "blocks": [block(b) for b in params[part]["blocks"]]}
            for part in ("encoder", "decoder")}


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                      s: torch.Tensor) -> torch.Tensor:
    """Plain version of K6 (the JAX ``mm``): x [M, K] @ (q [K, N] * s [N])
    accumulated in float32, returned in x's dtype."""
    return ((x.float() @ q.float()) * s.float()).to(x.dtype)


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """K6: x [M, K] bf16 @ dequant(q int8 [K, N], s f32 [N]) -> [M, N] bf16.

    On a CPU tensor runs ``int8_matmul_plain``.  On a CUDA tensor launches
    the kernel or raises (K a multiple of 8 and N of 16: 16-byte loads);
    each launch counts as (M, K, N)."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, s)
    m, k = x.shape
    n = q.shape[1]
    _build.require(x, "x", torch.bfloat16, (m, k), x.device)
    _build.require(q, "q", torch.int8, (k, n), x.device)
    _build.require(s, "s", torch.float32, (n,), x.device)
    if k % 8 or n % 16:
        raise ValueError(f"int8_matmul: K must be a multiple of 8 and N of "
                         f"16, got K={k} N={n}")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    lib = _build.library("int8_matmul")
    err = lib.mwx_int8_matmul(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                              out.data_ptr(), m, k, n, _build.stream_of(x))
    _build.check(err, "int8_matmul kernel")
    count("int8_matmul", (m, k, n))
    return out


def mm(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x [..., K] @ w for a plain [K, N] tensor or a ``{q, s}`` weight."""
    if not is_quantized(w):
        return x @ w
    lead = x.shape[:-1]
    y = int8_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w["q"], w["s"])
    return y.reshape(*lead, y.shape[-1])
