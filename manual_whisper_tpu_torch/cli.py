"""Command-line transcription entry point of the PyTorch port.

Mirrors the JAX package's ``cli.py`` (reference: transcribe.py:98-247):
the same .env knobs (WHISPER_MODEL, BATCH_SIZE, BEAM_SIZE, VAD_ONSET,
VAD_OFFSET, HF_TOKEN), the same prints and the same Markdown/JSON output.
Runs on CUDA and raises without it.  Word alignment and (with HF_TOKEN)
speaker diarization run on the same device after the transcription; when
either fails the CLI goes on without it, with the JAX CLI's lines.

    python -m manual_whisper_tpu_torch.cli recording.m4a

On a host with several GPUs it runs on every one of them, as the JAX CLI
meshes every chip (``parallel/launch.py``): one process a GPU, started by
this one (or by ``torchrun``), each loading the model with the same
``load_model(..., mesh="auto")`` call.  Rank 0 prints, transcribes
through ``launch.Leader`` (every rank runs the transcription's share of
its mesh), aligns, diarizes and writes the files; the other ranks follow.
``MWX_AUTO_MESH=false`` keeps to one GPU.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import time
from pathlib import Path

from . import config
from .audio import (UnsupportedFormatError, decodable_suffixes,
                    load_audio)
from .device import device_label, resolve_device
from .parallel.launch import Leader, follow, start_world
from .pipeline import load_model
from .text import INITIAL_PROMPT, clean_result_segments, format_transcript

SAMPLE_RATE = 16000
MODULE = "manual_whisper_tpu_torch.cli"


def _load(model_size: str, dev, compute_type: str):
    """The pipeline every rank loads, with the same call."""
    return load_model(
        model_size, dev, compute_type=compute_type, language="zh",
        asr_options={"initial_prompt": INITIAL_PROMPT,
                     "beam_size": config.get_int("BEAM_SIZE", 1),
                     # bf16 per-position scales of the int8 cross K/V
                     "ckv_scale_bf16":
                         config.get_env("MWX_CKV_SCALE", "f32") == "bf16"},
        vad_options={
            "vad_onset": config.get_float("VAD_ONSET", 0.5),
            "vad_offset": config.get_float("VAD_OFFSET", 0.363),
        })


def transcribe_audio(audio_file: str, hf_token=None, model_size=None,
                     batch_size=None, device=None,
                     compute_type="bfloat16", world=None):
    """Pipeline orchestration (reference: transcribe_audio,
    transcribe.py:98-183): returns (result_dict, audio_duration_sec,
    device_label).  ``world``: rank 0's ``launch.World``, whose other
    ranks follow the transcription (None: this process alone)."""
    model_size = model_size or config.get_env("WHISPER_MODEL", "large-v3")
    batch_size = batch_size or config.get_int("BATCH_SIZE", 4)
    dev = resolve_device(device or "cuda")
    label = device_label(dev)

    print(f"🎙️ 正在转写: {audio_file}")
    print(f"📊 配置: 模型={model_size} | 设备={label} | "
          f"精度={compute_type} | 批大小={batch_size}")

    step_start = time.time()
    print(f"📝 加载 Whisper {model_size} 模型...")
    model = _load(model_size, dev, compute_type)
    if world is not None:
        model = Leader(model, world)
        print(f"   进程组: {world.size} 个进程, rank 0 主导")
    print(f"   模型加载耗时: {time.time() - step_start:.1f}s")

    print("🔊 加载音频...")
    audio = load_audio(audio_file)
    audio_duration = len(audio) / SAMPLE_RATE
    print(f"   音频时长: {audio_duration:.0f}s ({audio_duration/60:.1f}min)")

    step_start = time.time()
    print("✍️ 转写中 (可能需要几分钟)...")
    result = model.transcribe(audio, batch_size=batch_size, language="zh")
    transcribe_time = time.time() - step_start
    rtf = transcribe_time / max(audio_duration, 1e-9)
    print(f"   转写耗时: {transcribe_time:.1f}s (实时比: {rtf:.1f}x)")

    # word-level alignment (reference: whisperx.align, transcribe.py:130-131)
    step_start = time.time()
    print("🎯 对齐时间戳...")
    try:
        from .models.align import align_result
        result = align_result(result, audio, language="zh", device=dev)
        print(f"   对齐耗时: {time.time() - step_start:.1f}s")
    except Exception as exc:  # degradation ladder: keep segment timestamps
        print(f"⚠️ 对齐失败: {exc}")
        print("   保留 VAD 段级时间戳继续。")

    # diarization (reference: transcribe.py:137-151 — failure tolerant)
    if hf_token:
        step_start = time.time()
        print("👥 识别说话人...")
        try:
            from .models.diarize import DiarizationPipeline, \
                assign_word_speakers
            diarizer = DiarizationPipeline(use_auth_token=hf_token,
                                           device=dev)
            diarize_segments = diarizer(audio)
            result = assign_word_speakers(diarize_segments, result)
            print(f"   说话人分离耗时: {time.time() - step_start:.1f}s")
        except Exception as exc:
            print(f"⚠️ 说话人分离失败: {exc}")
            print("   继续生成不带说话人标签的转写稿...")
    else:
        print("⚠️ 未设置 HF_TOKEN，跳过说话人分离。请在 .env 中设置 HF_TOKEN。")

    print("🧹 清理转写文本...")
    cleaned, cleaned_count, dropped = clean_result_segments(
        result.get("segments", []))
    result["segments"] = cleaned
    if cleaned_count:
        print(f"   修复了 {cleaned_count} 处文本问题")
    if dropped:
        print(f"   删除了 {dropped} 条提示词污染片段")

    return result, audio_duration, label


def main(argv=None, device="cuda") -> int:
    """The CLI on ``argv`` (default ``sys.argv[1:]``): every GPU of the
    host (``launch.start_world``), or ``device``'s world under
    ``torchrun``."""
    argv = argv if argv is not None else sys.argv[1:]
    total_start = time.time()

    audio_file = argv[0] if argv else "New Recording 46.m4a"
    if not os.path.exists(audio_file):
        print(f"❌ 文件不存在: {audio_file}")
        return 1
    # fail on undecodable containers BEFORE the expensive model load (the
    # reference's default input is .m4a, transcribe.py:239); with ffmpeg
    # present any container it can decode is accepted, like the reference
    suffix = Path(audio_file).suffix.lower()
    if suffix and not shutil.which("ffmpeg") \
            and suffix not in decodable_suffixes():
        print(f"❌ {UnsupportedFormatError(suffix).zh}")
        return 1

    model_size = config.get_env("WHISPER_MODEL", "large-v3")
    output_file = Path(audio_file).stem + "_transcript.md"
    world = start_world(["-m", MODULE, *argv], device=device)
    with world or contextlib.nullcontext():
        if world is not None and world.rank != 0:
            follow(_load(model_size, world.device, "bfloat16"), world)
            return 0
        result, audio_duration, label = transcribe_audio(
            audio_file, config.get_env("HF_TOKEN"), model_size=model_size,
            device=device if world is None else world.device, world=world)

    total_time = time.time() - total_start
    format_transcript(result, audio_file, output_file, audio_duration,
                      total_time, model_size=model_size,
                      compute_type="bfloat16", device=label)

    print("\n🎉 转写完成!")
    print(f"⏱️ 总耗时: {total_time:.1f}s | 音频时长: {audio_duration:.0f}s "
          f"| 实时比: {total_time/max(audio_duration, 1e-9):.1f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
