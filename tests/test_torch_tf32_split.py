"""PyTorch port: why K2's float32 build multiplies in 3xTF32 and not TF32.

``csrc/flash_attention.cu`` runs both products of float32 attention on the
tensor cores in TF32, which keeps 10 mantissa bits.  Each operand x is split
into hi = rna(x) and lo = rna(x - hi) (``cvt.rna.tf32.f32``: round to
nearest, ties away from zero), and every product is the three TF32 products
hi hi + hi lo + lo hi.  This file emulates that arithmetic on the CPU with
integer views of float32 and holds it, and a single TF32 product, against
the JAX package's ``flash_attention`` in interpret mode at the test config's
shapes with keys scaled 3x (a sharp softmax): the split is within 1e-5, the
single product outside the card's (1e-4, 1e-4), so that tolerance tells the
two apart.  Then the split's own properties.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manual_whisper_tpu.ops import attention as jatt
from manual_whisper_tpu_torch.ops import attention as tatt

# the card's tolerance of K2 f32 against its plain version (chip_smoke.py's
# TOL["flash_attention_f32"], tests/test_torch_cuda.py's)
CARD_TOL = (1e-4, 1e-4)


def cvt_rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 as ``cvt.rna.tf32.f32``: add half of the 13 dropped
    bits' weight to the magnitude's bits, then clear them (sign and
    magnitude, so a tie goes away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    hi = cvt_rna_tf32(x)
    return hi, cvt_rna_tf32(x - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel forms it: lo hi + hi lo + hi hi, each product of
    TF32 values exact (22 bits), summed in float64 (the card sums in
    float32, whose rounding the tolerance covers)."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    d = torch.float64
    return (al.to(d) @ bh.to(d) + ah.to(d) @ bl.to(d)
            + ah.to(d) @ bh.to(d)).float()


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one TF32 product: both operands rounded once."""
    d = torch.float64
    return (cvt_rna_tf32(a).to(d) @ cvt_rna_tf32(b).to(d)).float()


def attention_with(matmul, q, k, v):
    """softmax(q k^T / sqrt(dh)) v with both products through ``matmul``
    and the softmax in float32, as K2 computes it."""
    s = matmul(q, k.transpose(-1, -2)) / q.shape[-1] ** 0.5
    return matmul(torch.softmax(s, dim=-1), v)


def _mk(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def sharp():
    """The test config's encoder attention (2 heads of 32 over 150
    frames), batch 2, keys scaled 3x; the JAX kernel in interpret mode."""
    q, k, v = (_mk((2, 2, 150, 32), seed, scale)
               for seed, scale in ((70, 1.0), (71, 3.0), (72, 1.0)))
    ref = np.asarray(jatt.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), interpret=True))
    return [torch.from_numpy(x) for x in (q, k, v)], torch.from_numpy(ref.copy())


def _excess(out, ref, atol, rtol):
    return float(((out - ref).abs() - atol - rtol * ref.abs()).max())


def test_3xtf32_attention_matches_jax_within_1e5(sharp):
    (q, k, v), ref = sharp
    out = attention_with(matmul_3xtf32, q, k, v)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5, rtol=0)
    assert _excess(out, ref, *CARD_TOL) < 0


def test_one_tf32_product_misses_the_card_tolerance(sharp):
    (q, k, v), ref = sharp
    out = attention_with(matmul_tf32, q, k, v)
    assert _excess(out, ref, *CARD_TOL) > 0
    # and by more than the 3xTF32 emulation's whole error
    split_err = float((attention_with(matmul_3xtf32, q, k, v) - ref).abs()
                      .max())
    assert float((out - ref).abs().max()) > 10 * split_err


def test_the_plain_version_is_the_float32_reference(sharp):
    """The card holds K2 f32 to ``attention_plain``: on these inputs it is
    the JAX kernel's float32 result to float32 rounding."""
    (q, k, v), ref = sharp
    np.testing.assert_allclose(tatt.attention_plain(q, k, v).numpy(),
                               ref.numpy(), atol=1e-5, rtol=0)


def test_rna_rounds_to_nearest_ties_away_on_13_dropped_bits():
    ulp = 2.0 ** -10                       # TF32's spacing above 1
    x = torch.tensor([1 + ulp / 2,         # a tie: away from zero
                      -(1 + ulp / 2),
                      1 + ulp / 2 - 2.0 ** -23,   # just below it: down
                      1 + 3 * ulp / 2,     # a tie above an odd value: up
                      1 + ulp / 4], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 1.0],
                        dtype=torch.float32)
    assert torch.equal(cvt_rna_tf32(x), want)
    zeros = torch.tensor([0.0, -0.0])
    assert torch.equal(cvt_rna_tf32(zeros).view(torch.int32),
                       zeros.view(torch.int32))


@pytest.mark.parametrize("scale", [1e-6, 1e-3, 1.0, 3.0, 1e6])
def test_split_reproduces_x_to_2_pow_minus_22(scale):
    x = torch.from_numpy(_mk((100000,), 73, scale))
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    rel = ((x.double() - hi.double() - lo.double()).abs()
           / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -22
    # hi alone keeps only TF32's 11 significant bits
    rel_hi = ((x.double() - hi.double()).abs() / x.double().abs()).max()
    assert 2.0 ** -13 < float(rel_hi) <= 2.0 ** -11


def test_rna_matches_a_float64_rounding():
    """rna against round-half-away-from-zero on the scaled significand,
    computed in float64 without bit tricks."""
    x = torch.from_numpy(_mk((200000,), 74, 7.0)).double()
    e = torch.floor(torch.log2(x.abs()))
    step = torch.pow(2.0, e - 10)
    m = x.abs() / step
    want = torch.sign(x) * torch.floor(m + 0.5) * step
    assert torch.equal(cvt_rna_tf32(x.float()).double(), want)
