"""manual_whisper_tpu_torch — the PyTorch/CUDA port of ``manual_whisper_tpu``.

Module names mirror the JAX package.  This package imports ``torch`` and
``numpy`` and nothing of JAX or of ``manual_whisper_tpu``.  The Pallas
kernels of the main path are hand-written CUDA C++ for Hopper (``csrc/``,
built on first use by ``ops/_build.py``); each sits beside its plain
PyTorch version, which runs only for tensors on the CPU.

- ``audio``     — WAV, FLAC and (FFmpeg shim) compressed decode + resample,
  over the C++ sources in ``native/`` built with g++ on first use
- ``ops``       — log-mel, encoder flash attention, decode attention
- ``models``    — Whisper encoder-decoder; greedy, beam and timestamp-token
  decoders; PyanNet and energy VAD
- ``tokenizer`` — Whisper byte-level BPE + special tokens
- ``text``      — CLI cleaning, the web post-processor, Markdown output
- ``pipeline``  — VAD chunking + batched transcribe
- ``serving``   — the HTTP job server and its ``PipelineBackend``
- ``convert``   — JAX param trees (numpy) -> the port's weights
- ``from_hf``   — HF Whisper checkpoints (safetensors, shards, .bin)
"""

__version__ = "0.1.0"


def __getattr__(name):
    """whisperx-style top-level surface, imported lazily."""
    if name == "load_model":
        from .pipeline import load_model
        return load_model
    if name == "load_audio":
        from .audio import load_audio
        return load_audio
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
