"""PyTorch port: HF Whisper checkpoints and the regex-free pre-tokenizer.

A tiny ``WhisperForConditionalGeneration`` is built in the test (nothing is
downloaded) and saved as one safetensors file, as safetensors shards and as
``pytorch_model.bin``.  The port reads each one to logits within 1e-4 of
HF's, to weights equal to the JAX package's ``load_whisper_checkpoint``
tree after ``convert.from_jax_tree``, and to the JAX config.  Its
safetensors reader gives ``safetensors.torch.load_file``'s tensors; its
pre-tokenizer gives ``regex``'s splits on every assigned code point.
"""

import dataclasses
import json
import struct
import sys
import unicodedata

import jax.numpy as jnp
import numpy as np
import pytest
import regex
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from safetensors.torch import load_file, save_file
from transformers import WhisperConfig as HFConfig
from transformers import WhisperForConditionalGeneration

from manual_whisper_tpu.convert import from_hf as jhf
from manual_whisper_tpu.pipeline import load_model as j_load_model
from manual_whisper_tpu.pipeline.transcribe import \
    TranscribePipeline as JPipeline
from manual_whisper_tpu.tokenizer import ByteLevelBPE as JBPE
from manual_whisper_tpu.tokenizer import make_test_tokenizer as j_tokenizer
from manual_whisper_tpu_torch import from_hf
from manual_whisper_tpu_torch.convert import from_jax_tree
from manual_whisper_tpu_torch.models.whisper import decoder_forward, encode
from manual_whisper_tpu_torch.pipeline import load_model
from manual_whisper_tpu_torch.tokenizer import ByteLevelBPE, bytes_to_unicode
from manual_whisper_tpu_torch.tokenizer.bpe import (_PRETOKENIZE_PATTERN,
                                                    pretokenize)

CPU = torch.device("cpu")
FORMATS = ["safetensors", "shards", "bin"]
PATTERN = regex.compile(_PRETOKENIZE_PATTERN)


def _tiny_hf():
    torch.manual_seed(0)
    cfg = HFConfig(
        vocab_size=2000, num_mel_bins=80, d_model=64,
        encoder_layers=2, encoder_attention_heads=2,
        decoder_layers=2, decoder_attention_heads=2,
        encoder_ffn_dim=256, decoder_ffn_dim=256,
        max_source_positions=60, max_target_positions=64,
        pad_token_id=0, bos_token_id=0, eos_token_id=0,
        decoder_start_token_id=0, suppress_tokens=None,
        begin_suppress_tokens=None)
    return WhisperForConditionalGeneration(cfg).eval()


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The tiny model and a directory per on-disk format."""
    model = _tiny_hf()
    root = tmp_path_factory.mktemp("hf")
    dirs = {}
    for fmt in FORMATS:
        kw = {"safe_serialization": fmt != "bin"}
        if fmt == "shards":
            kw["max_shard_size"] = "200KB"
        model.save_pretrained(root / fmt, **kw)
        dirs[fmt] = root / fmt
    assert (dirs["safetensors"] / "model.safetensors").exists()
    assert (dirs["shards"] / "model.safetensors.index.json").exists()
    assert len(list(dirs["shards"].glob("model-*.safetensors"))) > 2
    assert (dirs["bin"] / "pytorch_model.bin").exists()
    return model, dirs


@pytest.mark.parametrize("fmt", FORMATS)
def test_logits_match_hf(checkpoints, fmt):
    model, dirs = checkpoints
    params, cfg = from_hf.load_whisper_checkpoint(dirs[fmt], CPU,
                                                  torch.float32)
    gen = torch.Generator().manual_seed(1)
    mel = torch.randn(2, 80, 120, generator=gen)
    tokens = torch.randint(0, 2000, (2, 7), generator=gen)
    with torch.no_grad():
        ref = model(input_features=mel, decoder_input_ids=tokens).logits
        logits, _ = decoder_forward(params, tokens, encode(params, mel, cfg),
                                    cfg)
    assert logits.shape == ref.shape == (2, 7, 2000)
    torch.testing.assert_close(logits.float(), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("fmt", FORMATS)
def test_weights_equal_jax_loader(checkpoints, fmt):
    _, dirs = checkpoints
    params, cfg = from_hf.load_whisper_checkpoint(dirs[fmt], CPU,
                                                  torch.float32)
    tree, _ = jhf.load_whisper_checkpoint(dirs[fmt])
    ref = from_jax_tree(tree, cfg, CPU)

    def walk(a, b, name):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), name
            for k in a:
                walk(a[k], b[k], f"{name}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), name
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{name}/{i}")
        else:
            assert a.dtype == b.dtype == torch.float32, name
            assert torch.equal(a, b), name

    walk(params, ref, "")


def test_config_matches_jax(checkpoints):
    _, dirs = checkpoints
    hf_cfg = json.loads((dirs["bin"] / "config.json").read_text())
    ours = dataclasses.asdict(from_hf.hf_config_to_whisper_config(hf_cfg,
                                                                  "x"))
    ref = dataclasses.asdict(jhf.hf_config_to_whisper_config(hf_cfg, "x"))
    for field in ("dtype", "use_flash_attention"):
        ours.pop(field, None)
        ref.pop(field, None)
    assert ours == ref
    for vocab, langs in ((51865, 99), (51866, 100)):
        cfg = from_hf.hf_config_to_whisper_config({**hf_cfg,
                                                   "vocab_size": vocab})
        assert cfg.num_languages == langs


def test_missing_weights_raise(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="no weights"):
        from_hf.read_state_dict(tmp_path)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_safetensors_reader_matches_library(tmp_path, dtype):
    gen = torch.Generator().manual_seed(2)
    tensors = {"a": torch.randn(3, 5, generator=gen).to(dtype),
               "b.weight": torch.randn(7, generator=gen).to(dtype),
               "scalar": torch.tensor(1.5, dtype=dtype),
               "empty": torch.zeros(0, 4, dtype=dtype)}
    path = tmp_path / "t.safetensors"
    save_file(tensors, str(path), metadata={"format": "pt"})
    ours, ref = from_hf.load_safetensors(path), load_file(str(path))
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype == dtype, k
        assert ours[k].shape == ref[k].shape, k
        assert torch.equal(ours[k], ref[k]), k


def test_safetensors_reader_rejects_malformed(tmp_path):
    path = tmp_path / "bad.safetensors"
    save_file({"x": torch.zeros(4, dtype=torch.int32)}, str(path))
    with pytest.raises(ValueError, match="I32"):
        from_hf.load_safetensors(path)
    header = json.dumps({"x": {"dtype": "F32", "shape": [4],
                               "data_offsets": [0, 32]}}).encode()
    path.write_bytes(struct.pack("<Q", len(header)) + header + bytes(16))
    with pytest.raises(ValueError, match="byte range"):
        from_hf.load_safetensors(path)
    path.write_bytes(b"\x01")
    with pytest.raises(ValueError, match="header"):
        from_hf.load_safetensors(path)


def test_load_model_reads_registry_checkpoint(checkpoints, tmp_path,
                                              monkeypatch):
    """``load_model(name)`` finds ``$MWX_WEIGHTS_DIR/<name>`` and reads its
    weights and its tokenizer as the JAX ``load_model`` does, then
    transcribes as the JAX pipeline does on that checkpoint at float32.
    (The JAX ``load_model`` itself runs such a checkpoint only in bf16: at
    ``compute_type="float32"`` it casts the weights but keeps the config's
    bf16, and its encoder's convolution rejects the mix.)"""
    _, dirs = checkpoints
    entry = tmp_path / "tiny-hf"
    entry.mkdir()
    for f in dirs["safetensors"].iterdir():
        (entry / f.name).write_bytes(f.read_bytes())
    j_tokenizer().bpe.save(entry)
    (entry / "tokenizer_meta.json").write_text('{"num_languages": 100}')
    monkeypatch.setenv("MWX_WEIGHTS_DIR", str(tmp_path))
    with pytest.warns(RuntimeWarning, match="energy"):
        tm = load_model("tiny-hf", device="cpu", compute_type="float32",
                        language="en")
        jm = j_load_model("tiny-hf", language="en", mesh=None)
    assert tm.cfg.n_audio_ctx == 60 and tm.cfg.name == jm.cfg.name
    assert dataclasses.astuple(tm.tokenizer.special) \
        == dataclasses.astuple(jm.tokenizer.special)
    assert tm.tokenizer.bpe.vocab == jm.tokenizer.bpe.vocab
    tree, jcfg = jhf.load_whisper_checkpoint(entry, dtype=np.float32)
    jp = JPipeline(tree, jcfg.with_dtype(jnp.float32), jm.tokenizer,
                   language="en")
    t = np.arange(16000 * 4) / 16000
    audio = (0.3 * np.sin(2 * np.pi * 220 * t)
             * (0.5 + 0.5 * np.sign(np.sin(2 * np.pi * 0.7 * t)))
             ).astype(np.float32)
    # greedy only: the rungs at T > 0 sample, and the two packages draw
    # their noise from different generators
    opts = {"language": "en", "batch_size": 2, "temperature": [0.0]}
    ref, out = jp.transcribe(audio, **opts), tm.transcribe(audio, **opts)
    assert [(s["text"], s["start"], s["end"]) for s in out["segments"]] \
        == [(s["text"], s["start"], s["end"]) for s in ref["segments"]]
    assert tm.last_stats["batches"] >= 1
    # a path to the checkpoint works too
    monkeypatch.setenv("MWX_WEIGHTS_DIR", str(tmp_path / "empty"))
    with pytest.warns(RuntimeWarning, match="energy"):
        assert load_model(str(entry), device="cpu").cfg.name == "tiny-hf"


# ---------------------------------------------------------------------------
# Pre-tokenizer without ``regex``
# ---------------------------------------------------------------------------

def _assigned():
    return [chr(c) for c in range(sys.maxunicode + 1)
            if unicodedata.category(chr(c)) != "Cn"]


def test_pretokenizer_classes_equal_regex_on_assigned_code_points():
    """Every code point assigned in ``unicodedata``'s table falls in the
    same class (space, letter, number, other) as ``regex`` puts it, and
    splits the same in each of the pattern's contexts."""
    chars = _assigned()
    text = "".join(chars)
    for cls in (r"\s", r"\p{L}", r"\p{N}"):
        assert set(regex.findall(cls, text)) == {
            c for c in chars if regex.fullmatch(cls, c)}
    # each char alone, after a space, after a letter, between spaces
    for ctx in ("{}", " {}", "a{}", "  {} x", "'{}", "1{}1"):
        s = "\x00".join(ctx.format(c) for c in chars)
        assert pretokenize(s) == PATTERN.findall(s), ctx


_SPECIAL = list("'s'tre've'm'll'd") + [
    " ", "  ", "\t", "\n", "\r\n", "\x0b", "\x0c", "\x1c", "\x1d", "\x1e",
    "\x1f", "\x85", "\xa0", " ", "　", " ", "中", "文", "テ",
    "ス", "한", "0", "7", "٣", "½", "Ⅻ", "é", "é", "ß", "!", "?",
    ".", "-", "_", "@", "€", "\U0001f600", "A", "z", "S", "'"]


@settings(max_examples=400, deadline=None, database=None)
@given(st.lists(st.one_of(
    st.sampled_from(_SPECIAL),
    st.characters(blacklist_categories=("Cn",))), max_size=40))
def test_pretokenizer_equals_regex(pieces):
    text = "".join(pieces)
    assert pretokenize(text) == PATTERN.findall(text)


def _bpe_pair():
    """One vocab with merges for the port's BPE and the JAX package's."""
    b2u = bytes_to_unicode()
    vocab = {ch: i for i, ch in enumerate(b2u.values())}
    merges = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("i", "n"),
              ("Ġ", "a"), ("e", "r"), ("in", "g"), ("'", "s"),
              ("ä", "¸"), ("1", "2")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    return ByteLevelBPE(vocab, merges), JBPE(vocab, merges)


@settings(max_examples=200, deadline=None, database=None)
@given(st.lists(st.one_of(st.sampled_from(
    _SPECIAL + [" the", "ing", "'s", "er", "12", " a"]),
    st.characters(blacklist_categories=("Cn", "Cs"))), max_size=30))
def test_bpe_with_merges_encodes_as_jax(pieces):
    ours, ref = _bpe_pair()
    text = "".join(pieces)
    ids = ours.encode(text)
    assert ids == ref.encode(text)
    assert ours.decode(ids) == text
