"""PyTorch port: the reader of the JAX package's orbax checkpoints.

- The zstd decoder (``native/mwx_zstd.cpp``) against ``zstandard``:
  generated bytes (empty, random, repetitive) at levels -5, 1, 3 and 19,
  with and without checksum and content size; several frames back to
  back and a skippable frame; a broken checksum, a truncated frame, a
  dictionary ID and a short output buffer raise.
- The OCDBT key-value store (``ocdbt.KvStore``) against tensorstore's
  ``list()`` and ``read()``: the repository's four trees, a deep b-tree
  with inline and indirect values, an uncompressed store.
- zarr v2 arrays (``ocdbt.read_zarr``) against tensorstore's zarr driver:
  edge chunks, missing chunks and their fill value, every dtype read, no
  compressor, ``/`` separators; another dtype raises naming it.
- ``from_hf.load_params`` against orbax's ``restore``: the four trees and
  a tree written here with the JAX ``save_params`` (f32, bf16, int8 and
  int32 leaves, a list node, a scalar); structure, container types, key
  strings, dtypes, shapes and bits equal.  A missing path gives None; a
  flipped byte in a chunk or a node makes the read fail.
"""

import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from manual_whisper_tpu.convert.from_hf import load_params as jax_load
from manual_whisper_tpu.convert.from_hf import save_params
from manual_whisper_tpu_torch import ocdbt
from manual_whisper_tpu_torch.from_hf import load_params

ROOT = Path(__file__).resolve().parent.parent
TREES = [ROOT / ".synth_ckpt"] + [
    ROOT / ".weights" / name / "jax"
    for name in ("pyannote-segmentation-3.0",
                 "jonatasgrosman--wav2vec2-large-xlsr-53-english",
                 "wespeaker-voxceleb-resnet34-LM")]
LEAVES = {".synth_ckpt": 50, "pyannote-segmentation-3.0": 52,
          "jonatasgrosman--wav2vec2-large-xlsr-53-english": 47,
          "wespeaker-voxceleb-resnet34-LM": 182}


def _tree_id(path):
    return path.name if path.name != "jax" else path.parent.name


# ---------------------------------------------------------------------------
# zstd
# ---------------------------------------------------------------------------

_data = st.one_of(
    st.just(b""),
    st.binary(max_size=3000),
    st.builds(lambda chunk, n: (chunk * n)[:200_000],
              st.binary(min_size=1, max_size=40),
              st.integers(1, 12_000)),
    st.lists(st.sampled_from([b"ab", b"the ", b"\x00\x00", b"xyz", b"\xff"]),
             max_size=4000).map(b"".join))


@pytest.mark.parametrize("content_size", [False, True])
@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", [-5, 1, 3, 19])
@settings(max_examples=25, deadline=None, database=None)
@given(data=_data)
def test_zstd_equals_zstandard(level, checksum, content_size, data):
    frame = zstandard.ZstdCompressor(
        level=level, write_checksum=checksum,
        write_content_size=content_size).compress(data)
    assert ocdbt.zstd_decompress(frame) == data
    assert ocdbt.zstd_decompress(frame, len(data)) == data


@pytest.mark.parametrize("level", [-5, 1, 3, 19])
def test_zstd_large_inputs(level):
    """Several 128 KiB blocks: float32 weights (Huffman literals in four
    streams, few matches) and text with long matches and repeat offsets."""
    rng = np.random.default_rng(level + 10)
    weights = rng.standard_normal(150_000).astype("<f4").tobytes()
    words = [bytes(rng.integers(97, 123, rng.integers(1, 9)))
             for _ in range(300)]
    text = b" ".join(words[i] for i in rng.integers(0, 300, 120_000))
    for data in (weights, text):
        frame = zstandard.ZstdCompressor(level=level,
                                         write_checksum=True).compress(data)
        assert ocdbt.zstd_decompress(frame) == data
        assert ocdbt.zstd_decompress(frame, len(data)) == data


def test_zstd_frames_back_to_back_and_skippable():
    parts = [b"first " * 50, b"", os.urandom(5000), b"last"]
    frames = [zstandard.ZstdCompressor(level=3, write_checksum=i % 2 == 0)
              .compress(p) for i, p in enumerate(parts)]
    skippable = (0x184D2A53).to_bytes(4, "little") + \
        (7).to_bytes(4, "little") + b"ignored"
    stream = frames[0] + skippable + frames[1] + frames[2] + skippable \
        + frames[3]
    assert ocdbt.zstd_decompress(stream) == b"".join(parts)
    assert ocdbt.zstd_decompress(skippable + frames[0]) == parts[0]


def _block(payload: bytes, last: bool) -> bytes:
    """A compressed block: header (size, type 2, last flag) + payload."""
    return ((len(payload) << 3) | (2 << 1) | int(last)).to_bytes(3, "little") \
        + payload


def test_zstd_hand_made_frame():
    """Parts a compressor rarely emits, in a frame built by hand: raw
    literals with a 3-byte header, 32512 sequences (the count's 3-byte
    form), RLE tables for all three codes, repeat offset 1; then a block of
    RLE literals whose tables repeat the previous block's.  ``zstandard``
    decodes the same bytes."""
    n = 0x7F00
    first = (bytes([0x0C, (n >> 4) & 0xFF, n >> 12]) + b"a" * n   # raw lits
             + b"\xff\x00\x00"                # n sequences
             + bytes([0x54, 1, 0, 0])          # RLE modes: LL 1, OF 0, ML 0
             + b"\x01")                        # no bits: every state is 0
    second = (bytes([(10 << 3) | 1]) + b"b"      # 10 RLE literals
              + b"\x01" + bytes([0xFC]) + b"\x01")  # 1 sequence, repeat
    frame = (0xFD2FB528).to_bytes(4, "little") + bytes([0x00, 0x38]) \
        + _block(first, False) + _block(second, True)
    ref = zstandard.ZstdDecompressor().decompress(frame,
                                                   max_output_size=1 << 20)
    assert ref == b"a" * (4 * n) + b"b" * 13
    assert ocdbt.zstd_decompress(frame) == ref


def test_zstd_rejects_broken_input():
    data = b"a checksum covers every byte " * 40
    frame = zstandard.ZstdCompressor(level=3,
                                     write_checksum=True).compress(data)
    broken = frame[:-1] + bytes([frame[-1] ^ 1])
    with pytest.raises(ValueError, match="checksum"):
        ocdbt.zstd_decompress(broken)
    for cut in (1, 5, len(frame) // 2, len(frame) - 1):
        with pytest.raises(ValueError, match="zstd"):
            ocdbt.zstd_decompress(frame[:cut])
    with pytest.raises(ValueError, match="magic"):
        ocdbt.zstd_decompress(b"\x00" * 16)
    with pytest.raises(ValueError, match="too small"):
        ocdbt.zstd_decompress(frame, len(data) - 1)
    # the same frame with a dictionary ID (flag 1, one byte) spliced in
    plain = zstandard.ZstdCompressor(level=3,
                                     write_content_size=False).compress(data)
    fhd, rest = plain[4], plain[5:]
    assert fhd & 3 == 0 and not fhd & 0x20
    with_dict = plain[:4] + bytes([fhd | 1]) + rest[:1] + b"\x07" + rest[1:]
    with pytest.raises(ValueError, match="dictionary"):
        ocdbt.zstd_decompress(with_dict)


def test_crc32c():
    assert ocdbt.crc32c(b"123456789") == 0xE3069283
    assert ocdbt.crc32c(b"") == 0


# ---------------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------------

def _tensorstore_items(root: Path):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{root.resolve()}/"}).result()
    return {k: kv.read(k).result().value for k in kv.list().result()}


@pytest.mark.parametrize("tree", TREES, ids=_tree_id)
def test_kvstore_equals_tensorstore(tree):
    ref = _tensorstore_items(tree)
    store = ocdbt.KvStore(tree)
    assert list(store.refs) == sorted(ref)
    assert {k: store.read(k) for k in store.refs} == ref
    assert sum(k.endswith(b"/.zarray") for k in ref) == LEAVES[_tree_id(tree)]


@pytest.mark.parametrize("config", [
    {"max_decoded_node_bytes": 200, "max_inline_value_bytes": 8,
     "compression": {"id": "zstd", "level": 5}},
    {"compression": None, "max_inline_value_bytes": 100}],
    ids=["deep", "uncompressed"])
def test_kvstore_b_tree_shapes(config, tmp_path):
    """A tree several levels deep (small nodes; keys sharing prefixes
    across levels; inline and indirect values), and a store without
    compression, written in two commits."""
    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}/",
            "config": config}
    kv = ts.KvStore.open(spec).result()
    rng = np.random.default_rng(3)
    for commit in range(2):
        with ts.Transaction() as txn:
            for i in range(80):
                key = f"k{commit}/{'ab'[i % 2]}/{i:03d}".encode()
                kv.with_transaction(txn)[key] = \
                    rng.bytes(int(rng.integers(0, 300)))
    ref = _tensorstore_items(tmp_path)
    assert len(ref) == 160
    if "max_decoded_node_bytes" in config:      # interior nodes were read
        manifest = ts.ocdbt.dump(kv.base).result()
        assert manifest["versions"][-1]["root_height"] > 0
    store = ocdbt.KvStore(tmp_path)
    assert list(store.refs) == sorted(ref)
    assert {k: store.read(k) for k in store.refs} == ref


# ---------------------------------------------------------------------------
# zarr v2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,fill", [
    ("<f4", 1.5), ("<f2", None), ("bfloat16", 2.0), ("|i1", -3),
    ("<i4", None), ("<i8", 7)])
@pytest.mark.parametrize("compressor,separator", [
    ({"id": "zstd", "level": 3}, "."), (None, "/")],
    ids=["zstd", "raw"])
def test_zarr_equals_tensorstore(dtype, fill, compressor, separator,
                                 tmp_path):
    """A [7, 5] array in [3, 2] chunks (edge chunks on both axes), with
    the last chunk row and column never written (read as the fill
    value)."""
    kv = {"driver": "ocdbt", "base": f"file://{tmp_path}/"}
    spec = {"driver": "zarr", "kvstore": dict(kv, path="arr/"),
            "metadata": {"shape": [7, 5], "chunks": [3, 2], "dtype": dtype,
                         "fill_value": fill, "compressor": compressor,
                         "dimension_separator": separator},
            "create": True}
    arr = ts.open(spec).result()
    values = np.arange(35).reshape(7, 5) * 3 - 20
    arr[0:6, 0:4] = values[0:6, 0:4].astype(arr.dtype.numpy_dtype)
    ref = arr.read().result()
    got = ocdbt.read_zarr(ocdbt.KvStore(tmp_path), "arr")
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()


def test_zarr_other_dtype_raises(tmp_path):
    spec = {"driver": "zarr",
            "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/",
                        "path": "arr/"},
            "metadata": {"shape": [4], "chunks": [4], "dtype": "<f8"},
            "create": True}
    ts.open(spec).result()[...] = np.ones(4)
    with pytest.raises(ValueError, match="'<f8'"):
        ocdbt.read_zarr(ocdbt.KvStore(tmp_path), "arr")


# ---------------------------------------------------------------------------
# load_params against orbax
# ---------------------------------------------------------------------------

def _assert_same_tree(ref, got, path="tree"):
    if isinstance(ref, dict):
        assert type(got) is dict and list(got) == list(ref), path
        for k in ref:
            _assert_same_tree(ref[k], got[k], f"{path}/{k}")
        return
    if isinstance(ref, list):
        assert type(got) is list and len(got) == len(ref), path
        for i, (x, y) in enumerate(zip(ref, got)):
            _assert_same_tree(x, y, f"{path}/{i}")
        return
    # orbax gives numpy arrays, and a jax.Array for a leaf saved from one
    assert isinstance(got, np.ndarray), path
    ref = np.asarray(ref)
    assert (got.dtype, got.shape) == (ref.dtype, ref.shape), path
    assert got.tobytes() == ref.tobytes(), path


@pytest.mark.parametrize("tree", TREES, ids=_tree_id)
def test_load_params_equals_orbax(tree):
    _assert_same_tree(jax_load(tree), load_params(tree))


@pytest.fixture(scope="module")
def mixed_tree(tmp_path_factory):
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((30, 40)).astype(np.float32),
            "h": jnp.asarray(rng.standard_normal(9), jnp.bfloat16),
            "q": {"q": rng.integers(-128, 128, (3, 4, 5), dtype=np.int8),
                  "s": rng.standard_normal(5).astype(np.float32)},
            "steps": np.arange(12, dtype=np.int32).reshape(3, 4),
            "layers": [{"g": np.ones(3, np.float32)},
                       {"g": np.full(3, 2, np.float32)},
                       np.zeros((2, 2), np.float32)],
            "scale": np.float32(0.5)}
    path = tmp_path_factory.mktemp("mixed") / "ckpt"
    save_params(tree, path)
    return path


def test_load_params_mixed_tree_equals_orbax(mixed_tree):
    got = load_params(mixed_tree)
    _assert_same_tree(jax_load(mixed_tree), got)
    assert got["h"].dtype.name == "bfloat16"
    assert isinstance(got["layers"], list) and len(got["layers"]) == 3


def test_load_params_missing_path(tmp_path):
    assert load_params(tmp_path / "absent") is None
    assert jax_load(tmp_path / "absent") is None


def test_empty_directory_fails_as_orbax(tmp_path):
    with pytest.raises(FileNotFoundError) as jax_err:
        jax_load(tmp_path)
    with pytest.raises(FileNotFoundError) as port_err:
        load_params(tmp_path)
    assert str(port_err.value) == str(jax_err.value)


def test_flipped_byte_fails_the_read(mixed_tree, tmp_path):
    """A flipped byte in a chunk (its zstd frame's first byte) and one in
    a b-tree node (caught by the node's CRC-32C) each make the read
    raise."""
    file, offset, _ = ocdbt.KvStore(mixed_tree).refs[b"w/0.0"]
    copy = tmp_path / "chunk"
    shutil.copytree(mixed_tree, copy)
    data = bytearray((copy / file[0] / file[1]).read_bytes())
    data[offset] ^= 0x10
    (copy / file[0] / file[1]).write_bytes(bytes(data))
    with pytest.raises(ValueError, match="zstd"):
        load_params(copy)
    node = tmp_path / "node"
    shutil.copytree(mixed_tree, node)
    root_file = next((node / "d").iterdir())
    data = bytearray(root_file.read_bytes())
    data[20] ^= 0x01
    root_file.write_bytes(bytes(data))
    with pytest.raises(ocdbt.FormatError, match="CRC-32C"):
        load_params(node)


def test_bf16_leaf_without_numpy_bfloat16(monkeypatch):
    """Where numpy has no ``bfloat16`` (no ``ml_dtypes``, as on a machine
    without JAX) a bf16 leaf is a torch bf16 tensor of the same bits, and
    it crosses the weight bridge as the numpy one does."""
    import torch

    from manual_whisper_tpu_torch.convert import tensor_from_numpy
    bits = np.array([0x3F80, -0x4080, 0x4049], np.int16)
    numpy_leaf = ocdbt._bf16(bits.copy())
    real_dtype = np.dtype

    def no_bfloat16(spec, *args, **kwargs):
        if spec == "bfloat16":
            raise TypeError("data type 'bfloat16' not understood")
        return real_dtype(spec, *args, **kwargs)
    monkeypatch.setattr(np, "dtype", no_bfloat16)
    torch_leaf = ocdbt._bf16(bits.copy())
    monkeypatch.undo()
    assert torch_leaf.dtype == torch.bfloat16
    assert torch.equal(tensor_from_numpy(torch_leaf),
                       tensor_from_numpy(numpy_leaf))
    assert tensor_from_numpy(torch_leaf).tolist() == [1.0, -1.0, 3.140625]
    assert jax.numpy.asarray(numpy_leaf).tolist() == [1.0, -1.0, 3.140625]
