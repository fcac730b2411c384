"""PyTorch port: log-mel frontend (K1's plain version) vs the JAX package.

Same audio, made from a numpy seed, through the JAX XLA path, the JAX
Pallas kernel in interpret mode and the port on the CPU.  Both sides are
float32; atol 1e-4 in log10 / normalised units (summation order differs).
"""

import numpy as np
import pytest
import torch

from manual_whisper_tpu.ops import mel as jmel
from manual_whisper_tpu.ops.mel_pallas import unnormalized_log_mel_pallas
from manual_whisper_tpu_torch.ops import _build
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
    before = _build.launches["mel"]
    tmel.unnormalized_log_mel(torch.zeros(1, 1600), 80)
    assert _build.launches["mel"] == before


def test_silence_is_finite():
    out = tmel.log_mel_spectrogram(torch.zeros(16000), 80)
    assert torch.isfinite(out).all()
