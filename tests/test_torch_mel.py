"""PyTorch port: log-mel frontend (K1's plain version) vs the JAX package.

Same audio, made from a numpy seed, through the JAX XLA path, the JAX
Pallas kernel in interpret mode and the port on the CPU.  Both sides are
float32; atol 1e-4 in log10 / normalised units (summation order differs).
"""

import collections

import numpy as np
import pytest
import torch

from manual_whisper_tpu.ops import mel as jmel
from manual_whisper_tpu.ops.mel_pallas import unnormalized_log_mel_pallas
from manual_whisper_tpu_torch import spans
from manual_whisper_tpu_torch.ops import mel as tmel

ATOL = 1e-4


def _audio(batch, seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    x = (0.4 * np.sin(2 * np.pi * (200 + 50 * t) * t)[None]
         + 0.1 * rng.standard_normal((batch, len(t))))
    return x.astype(np.float32)


def test_constants_are_exact_copies():
    for n_mels in (80, 128):
        np.testing.assert_array_equal(tmel.mel_filter_bank(n_mels),
                                      jmel.mel_filter_bank(n_mels))
    np.testing.assert_array_equal(tmel._dft_window_matrix(),
                                  jmel._dft_window_matrix())


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_jax_xla_path(n_mels):
    audio = _audio(2, 1.0, seed=n_mels)
    ref = np.asarray(jmel.log_mel_spectrogram(audio, n_mels=n_mels))
    out = tmel.log_mel_spectrogram(torch.from_numpy(audio), n_mels).numpy()
    assert out.shape == ref.shape == (2, n_mels, 100)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_unbatched_input():
    audio = _audio(1, 0.5)[0]
    ref = np.asarray(jmel.log_mel_spectrogram(audio, n_mels=80))
    out = tmel.log_mel_spectrogram(torch.from_numpy(audio), 80).numpy()
    assert out.shape == ref.shape == (80, 50)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_unnormalized_matches_pallas_kernel_interpret():
    """At a 600-frame multiple, the kernel's own block size."""
    audio = _audio(1, 6.0, seed=3)             # 600 frames
    ker = np.asarray(unnormalized_log_mel_pallas(audio, 80, interpret=True))
    out = tmel.unnormalized_log_mel(torch.from_numpy(audio), 80).numpy()
    assert out.shape == ker.shape == (1, 600, 80)
    np.testing.assert_allclose(out, ker, atol=ATOL)


def test_irregular_frame_count_on_cpu():
    """The port takes any frame count (the TPU kernel needs % 600)."""
    audio = _audio(1, 0.77, seed=4)
    ref = np.asarray(jmel.unnormalized_log_mel(audio, 80))
    out = tmel.unnormalized_log_mel(torch.from_numpy(audio), 80).numpy()
    assert out.shape == ref.shape == (1, 77, 80)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_cpu_tensor_runs_plain_version_not_kernel():
    launches = collections.Counter()
    with spans.bind({}, "test", launches):
        tmel.unnormalized_log_mel(torch.zeros(1, 1600), 80)
    assert not launches


def test_silence_is_finite():
    out = tmel.log_mel_spectrogram(torch.zeros(16000), 80)
    assert torch.isfinite(out).all()


def _folds():
    return tuple(torch.from_numpy(f) for f in tmel.folded_dft())


def _folded_spectrum(frames):
    """re, im [N, 201] of frames [N, 400] through K1's folded constants, as
    the kernel sums them: e = x[k] + x[400-k] and o = x[k] - x[400-k] for
    k = 1..199, x[200] on its own."""
    x = torch.from_numpy(frames)
    head, tail = x[:, 1:200], x[:, 201:400].flip(1)
    even = torch.cat([head + tail, x[:, 200:201]], dim=1)
    cos_fold, sin_fold = _folds()
    return even @ cos_fold, (head - tail) @ sin_fold


def test_window_is_symmetric_so_the_dft_folds():
    dft = tmel._dft_window_matrix().astype(np.float32)
    cos, sin = dft[:, :tmel.N_FREQS], dft[:, tmel.N_FREQS:]
    np.testing.assert_array_equal(dft[0], 0.0)              # w[0] = 0
    np.testing.assert_allclose(cos[399:200:-1], cos[1:200], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(sin[399:200:-1], -sin[1:200], rtol=0,
                               atol=1e-12)


def test_folded_constants_are_the_plain_versions_values():
    c = tmel._constants(80, torch.device("cpu"))
    cos_fold, sin_fold = _folds()
    assert cos_fold.shape == (200, 201) and sin_fold.shape == (199, 201)
    assert cos_fold.dtype == sin_fold.dtype == torch.float32
    assert torch.equal(cos_fold, c.dft[1:201, :201])
    assert torch.equal(sin_fold, c.dft[1:200, 201:])


def test_folded_product_reproduces_the_dft():
    rng = np.random.default_rng(11)
    frames = rng.standard_normal((64, 400)).astype(np.float32)
    c = tmel._constants(80, torch.device("cpu"))
    ref = torch.from_numpy(frames) @ c.dft
    re, im = _folded_spectrum(frames)
    for out, want in ((re, ref[:, :201]), (im, ref[:, 201:])):
        assert torch.all((out - want).abs() <= 1e-5 * (1 + want.abs()))


@pytest.mark.parametrize("n_mels,nnz", [(40, 383), (80, 391), (128, 394)])
def test_band_table_covers_every_nonzero_once(n_mels, nnz):
    filters = tmel.mel_filter_bank(n_mels).astype(np.float32)
    table, weights = tmel.band_table(filters)
    assert table.shape == (n_mels, 4) and table.dtype == np.int32
    assert len(weights) == nnz == np.count_nonzero(filters)
    dense = np.zeros_like(filters)
    seen = np.zeros(filters.shape, np.int64)
    for m, (lo, n, off, widest) in enumerate(table):
        assert off == table[:m, 1].sum()                 # packed in order
        assert widest == table[:, 1].max() <= tmel.MAX_KERNEL_BAND
        dense[lo:lo + n, m] = weights[off:off + n]
        seen[lo:lo + n, m] += 1
    np.testing.assert_array_equal(dense, filters)
    assert seen[filters != 0].min() == seen.max() == 1


@pytest.mark.parametrize("n_mels", [80, 128])
def test_sparse_filterbank_equals_the_dense_product(n_mels):
    rng = np.random.default_rng(n_mels)
    power = torch.from_numpy(
        rng.exponential(size=(50, 201)).astype(np.float32))
    c = tmel._constants(n_mels, torch.device("cpu"))
    dense = power @ c.filters
    sparse = torch.zeros_like(dense)
    for m, (lo, n, off, _) in enumerate(c.bands.tolist()):
        sparse[:, m] = power[:, lo:lo + n] @ c.weights[off:off + n]
    assert torch.all((sparse - dense).abs() <= 1e-6 * dense.abs())


@pytest.mark.parametrize("tn,gx", [(13, 8), (7, 16)])
def test_packed_constants_hold_the_folds(tn, gx):
    """``pack_folded`` puts column g * tn + s at plane s // 4, group g, lane
    s % 4 of its row, zero elsewhere; ``packed_folds`` (what a kernel of
    that tile is given) are columns 0..100 of the folds packed so."""
    for fold, packed in zip(tmel.folded_dft(), tmel.packed_folds(tn, gx)):
        cols = fold[:, :tmel.KERNEL_COLS]
        p = tmel.pack_folded(cols, tn, gx)
        planes = -(-tn // 4)
        assert p.shape == (200, planes * gx * 4)
        grid = p.reshape(200, planes, gx, 4)
        f = np.arange(tmel.KERNEL_COLS)
        got = grid[:, (f % tn) // 4, f // tn, (f % tn) % 4]
        np.testing.assert_array_equal(got[:fold.shape[0]], cols)
        assert np.count_nonzero(got[fold.shape[0]:]) == 0
        assert np.count_nonzero(p) == np.count_nonzero(cols)
        np.testing.assert_array_equal(packed, p)


def test_mirrored_bins_come_from_the_same_columns():
    """Row k of bin 200 - f is (-1)^k times bin f's (cosine) and minus that
    (sine), to 2e-13: the kernel sums bins 0..100 over even and odd taps
    apart and takes bins 100..200 as their difference."""
    f = np.arange(tmel.KERNEL_COLS)
    for fold, sign in zip(tmel.folded_dft(), (1.0, -1.0)):
        k = np.arange(1, fold.shape[0] + 1)[:, None]
        np.testing.assert_allclose(fold[:, 200 - f],
                                   sign * (-1.0) ** k * fold[:, f],
                                   rtol=0, atol=1e-12)


def _kernel_spectrum(frames):
    """power [N, 201] of frames [N, 400] as K1 sums it: taps folded, bins
    0..100 summed over even taps (P) and odd taps (Q) apart, bin f as
    P + Q and bin 200 - f as P - Q."""
    x = torch.from_numpy(frames)
    head, tail = x[:, 1:200], x[:, 201:400].flip(1)
    folds = (torch.cat([head + tail, x[:, 200:201]], dim=1),
             torch.cat([head - tail, torch.zeros_like(x[:, :1])], dim=1))
    power = torch.zeros(len(frames), 201)
    for fold, half in zip(folds, _folds()):
        cols = torch.cat([half, torch.zeros(200 - len(half), 201)])[:, :101]
        odd_taps = fold[:, 0::2] @ cols[0::2]        # rows 0, 2..: taps 1, 3..
        even_taps = fold[:, 1::2] @ cols[1::2]
        power[:, :101] += (even_taps + odd_taps) ** 2
        power[:, 200 - torch.arange(100)] += \
            ((even_taps - odd_taps) ** 2)[:, :100]
    return power


def test_twice_folded_spectrum_matches_the_dense_one():
    rng = np.random.default_rng(12)
    frames = rng.standard_normal((64, 400)).astype(np.float32)
    c = tmel._constants(80, torch.device("cpu"))
    spec = torch.from_numpy(frames) @ c.dft
    ref = spec[:, :201] ** 2 + spec[:, 201:] ** 2
    out = _kernel_spectrum(frames)
    assert torch.all((out - ref).abs() <= 5e-5 * (1 + ref))
