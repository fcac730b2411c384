"""PyTorch port: torch exports of the repository's orbax checkpoints.

The registry's preferred form is the orbax ``jax/`` tree, which the port
reads as the JAX package does (``from_hf.load_params``).  The
synthetic-data checkpoints are also written as torch files in the key
names of the checkpoints they stand for, the registry's second form:

- ``.weights/jonatasgrosman--wav2vec2-large-xlsr-53-english/
  pytorch_model.bin`` in HF ``Wav2Vec2ForCTC`` keys (the positional conv in
  weight-norm form, ``weight_g`` / ``weight_v``), committed (0.5 MB);
- ``.weights/wespeaker-voxceleb-resnet34-LM/pytorch_model.bin`` in
  wespeaker ResNet34 keys.  At 26.6 MB it is not committed (the
  repository's tree must stay small) and is optional: the port reads the
  ResNet34 from its orbax tree.  The test writes it to a temporary
  directory, and ``--export`` writes it beside the orbax tree, where
  ``git`` ignores it.

Each file, read back through the JAX package's own converter
(``convert_wav2vec2_state_dict``, ``convert_wespeaker_resnet``), must be
its orbax tree array for array and bit for bit, and the port's converters
must read the same trees.  To write both files again, run this file from
the repository root:
``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_export.py --export``.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from manual_whisper_tpu.convert.from_hf import load_params
from manual_whisper_tpu.models import diarize as jdiarize
from manual_whisper_tpu.models import wav2vec2 as jw2v
from manual_whisper_tpu_torch.convert import (convert_wav2vec2_state_dict,
                                              wav2vec2_hf_state_dict,
                                              wespeaker_state_dict)
from manual_whisper_tpu_torch.models import diarize as tdiarize
from manual_whisper_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from cpu_budget import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
ALIGN_DIR = ROOT / ".weights" / "jonatasgrosman--wav2vec2-large-xlsr-53-english"
EMBED_DIR = ROOT / ".weights" / "wespeaker-voxceleb-resnet34-LM"


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _assert_same_tree(got, ref):
    a, b = _leaves(got), _leaves(ref)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def _aligner():
    tree = load_params(ALIGN_DIR / "jax")
    if tree is None:
        return None, None
    meta = json.loads((ALIGN_DIR / "align_meta.json").read_text())
    return jax.tree.map(np.asarray, tree), meta


@pytest.fixture(scope="module")
def aligner():
    tree, meta = _aligner()
    if tree is None:
        pytest.skip("no synthetic aligner in the repository")
    return tree, meta


@pytest.mark.parametrize("reader", ["jax", "port"])
def test_wav2vec2_export_equals_orbax_tree(aligner, reader):
    tree, meta = aligner
    sd = torch.load(str(ALIGN_DIR / "pytorch_model.bin"), map_location="cpu",
                    weights_only=True)
    expected = wav2vec2_hf_state_dict(tree)
    assert list(sd) == list(expected)
    for k in sd:
        assert sd[k].dtype == torch.float32
        assert torch.equal(sd[k], expected[k]), k
    assert "wav2vec2.encoder.pos_conv_embed.conv.weight_g" in sd
    if reader == "jax":
        got = jw2v.convert_wav2vec2_state_dict(
            sd, jw2v.Wav2Vec2Config(**meta["config"]))
    else:
        got = convert_wav2vec2_state_dict(sd, Wav2Vec2Config(**meta["config"]))
    _assert_same_tree(got, tree)


def _embedder():
    tree = load_params(EMBED_DIR / "jax")
    return None if tree is None else jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def embedder():
    tree = _embedder()
    if tree is None:
        pytest.skip("no synthetic speaker embedder in the repository")
    return tree


@pytest.mark.parametrize("reader", ["jax", "port"])
def test_wespeaker_export_equals_orbax_tree(embedder, reader, tmp_path):
    torch.save(wespeaker_state_dict(embedder), tmp_path / "pytorch_model.bin")
    sd = torch.load(str(tmp_path / "pytorch_model.bin"), map_location="cpu",
                    weights_only=True)
    expected = wespeaker_state_dict(embedder)
    assert list(sd) == list(expected)
    for k in sd:
        assert sd[k].dtype == torch.float32
        assert torch.equal(sd[k], expected[k]), k
    convert = (jdiarize.convert_wespeaker_resnet if reader == "jax"
               else tdiarize.convert_wespeaker_resnet)
    cfg = (jdiarize.EmbeddingConfig() if reader == "jax"
           else tdiarize.EmbeddingConfig())
    _assert_same_tree(convert(sd, cfg), embedder)


def test_committed_export_is_small():
    """The committed aligner export stays about 0.5 MB."""
    assert (ALIGN_DIR / "pytorch_model.bin").stat().st_size < 1 << 20


def _export() -> None:
    tree, _ = _aligner()
    torch.save(wav2vec2_hf_state_dict(tree), ALIGN_DIR / "pytorch_model.bin")
    torch.save(wespeaker_state_dict(_embedder()),
               EMBED_DIR / "pytorch_model.bin")


if __name__ == "__main__" and "--export" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    _export()
