"""PyTorch port: isolation from JAX and the device contract.

No file of ``manual_whisper_tpu_torch/`` nor ``chip_smoke.py`` may import
JAX, ml_dtypes, orbax, regex, tensorstore, zstandard or the JAX package
(the machine with the card has none of them); importing the port must leave
no ``jax`` in ``sys.modules``; entry points default to CUDA and raise
without it rather than carrying on on the CPU.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "manual_whisper_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "orbax", "regex", "tensorstore",
             "zstandard", "manual_whisper_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_files_exist():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for expected in ("ops/mel.py", "ops/attention.py",
                     "ops/decode_attention.py", "ops/quant.py",
                     "ops/norm.py", "ops/_build.py",
                     "models/whisper.py", "models/decode.py",
                     "models/beam.py", "models/timestamps.py",
                     "models/vad.py", "pipeline/transcribe.py", "cli.py",
                     "convert.py", "from_hf.py", "ocdbt.py", "device.py",
                     "config.py",
                     "tokenizer/bpe.py", "audio/io.py", "audio/native.py",
                     "audio/flacenc.py", "text/processor.py",
                     "serving/jobs.py", "serving/second_pass.py",
                     "serving/server.py", "eval/metrics.py",
                     "eval/synth.py", "eval/vad_eval.py",
                     "models/wav2vec2.py", "models/align.py",
                     "models/diarize.py", "training/train.py",
                     "training/optim.py", "parallel/mesh.py",
                     "parallel/dryrun.py", "parallel/launch.py",
                     "spans.py"):
        assert expected in names
    for src in ("mel.cu", "flash_attention.cu", "decode_attention.cu",
                "int8_matmul.cu", "add_layer_norm.cu"):
        assert (PORT / "csrc" / src).exists()
    for src in ("mwx_audio.cpp", "mwx_flac.cpp", "mwx_ffdec.cpp",
                "mwx_zstd.cpp"):
        assert (PORT / "native" / src).exists()


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_forbidden_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {name}"


def _run(code, cwd=ROOT, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_import_pulls_in_no_jax():
    code = ("import sys, manual_whisper_tpu_torch.pipeline, "
            "manual_whisper_tpu_torch.cli, manual_whisper_tpu_torch.serving, "
            "manual_whisper_tpu_torch.models.beam, "
            "manual_whisper_tpu_torch.models.timestamps, "
            "manual_whisper_tpu_torch.models.wav2vec2, "
            "manual_whisper_tpu_torch.models.align, "
            "manual_whisper_tpu_torch.models.diarize, "
            "manual_whisper_tpu_torch.eval.metrics, "
            "manual_whisper_tpu_torch.eval.synth, "
            "manual_whisper_tpu_torch.eval.vad_eval, "
            "manual_whisper_tpu_torch.ocdbt, "
            "manual_whisper_tpu_torch.training, "
            "manual_whisper_tpu_torch.parallel.dryrun\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "print('BAD', bad)\nsys.exit(1 if bad else 0)")
    out = _run(code)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from manual_whisper_tpu_torch.device import resolve_device
    from manual_whisper_tpu_torch.pipeline import load_model
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model("test")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_cuda_wrappers_reject_without_fallback():
    """Wrong inputs on a non-CPU device raise; nothing falls back."""
    from manual_whisper_tpu_torch.ops import _build
    x = torch.zeros(2, 3, dtype=torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        _build.require(x, "x", torch.bfloat16, (2, 3), x.device)
    with pytest.raises(ValueError, match="shape"):
        _build.require(x, "x", torch.float32, (3, 2), x.device)
    with pytest.raises(ValueError, match="contiguous"):
        _build.require(x.t(), "x", torch.float32, (3, 2), x.device)
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        _build.check(1, "k")


def test_chip_smoke_fails_without_cuda_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run("import runpy; runpy.run_path('chip_smoke.py', "
               "run_name='__main__')")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           capture_output=True, text=True, timeout=300,
                           env={k: v for k, v in os.environ.items()
                                if k != "PYTHONPATH"})
    assert alone.returncode != 0
    assert '"ok"' not in alone.stdout
