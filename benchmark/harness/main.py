"""One run of one cell: set-up, the measured window, the metrics, the
output check, and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (``setup_s``, from the start of the process): the program's
modules, the weights made on the card from the seed, PyanNet from the
registry, the inputs that the mix's kind makes from the seed
(``benchmark/kinds/<kind>.py``), and a warm-up that captures every
decode bucket the traffic reaches and runs one transcription.  The window then
runs the traffic for ``--seconds``; with ``--trace 1`` the profiler
records the mix's first ``trace.requests`` requests of it.  After the
window: the counts of graph captures and kernel builds inside it (both
must be 0), the metrics, the peak memory, then the program is freed and
the output check runs against the references.  The last line of
standard output is the result; the numbers compared, each with its
limit, are the last lines of standard error and the result's last key.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "manual_whisper_tpu")


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_environment(root: Path) -> None:
    """Caches and registries inside the checkout, at fixed paths."""
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["MWX_WEIGHTS_DIR"] = str(root / ".weights")
    os.environ["MWX_ALLOW_SYNTH_WEIGHTS"] = "1"


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None,
                    help="a lower precision in the program's place, to show "
                         "that the check fails it: the name of a file "
                         "benchmark/controls/<name>.py (not part of a "
                         "benchmark run)")
    return ap.parse_args(argv)


def whisper_config(cfg: Dict, dtype):
    from manual_whisper_tpu_torch.models.whisper import WhisperConfig
    return WhisperConfig(
        name=cfg["name"], n_mels=cfg["num_mel_bins"],
        n_vocab=cfg["vocab_size"], n_audio_ctx=cfg["max_source_positions"],
        n_audio_state=cfg["d_model"],
        n_audio_head=cfg["encoder_attention_heads"],
        n_audio_layer=cfg["encoder_layers"],
        n_text_ctx=cfg["max_target_positions"], n_text_state=cfg["d_model"],
        n_text_head=cfg["decoder_attention_heads"],
        n_text_layer=cfg["decoder_layers"],
        num_languages=cfg["num_languages"], dtype=dtype)


class Program:
    """The system under test, built from the benchmark's inputs through
    the port's public entries: ``TranscribePipeline`` over the weights,
    the test tokenizer, and PyanNet from the registry.  The
    configuration's ``compute_type`` is served as the port's
    ``load_model`` serves it: the activation type of
    ``device.compute_dtype``, the weights made in that type, and with
    ``int8`` every block matmul weight quantized (``ops.quant``)."""

    def __init__(self, cell: Dict, weight_seed: int, device):
        from manual_whisper_tpu_torch.convert import (
            from_jax_pyannet, load_segmentation_params)
        from manual_whisper_tpu_torch.device import compute_dtype
        from manual_whisper_tpu_torch.models.vad import VoiceActivityDetector
        from manual_whisper_tpu_torch.ops.quant import quantize_params
        from manual_whisper_tpu_torch.pipeline import TranscribePipeline
        from manual_whisper_tpu_torch.tokenizer import make_test_tokenizer

        from . import weights
        cfg, mix = cell["config"], cell["mix"]
        self.dtype = compute_dtype(cfg["compute_type"])
        params = weights.make_whisper(cfg, weight_seed, device, self.dtype)
        if cfg["compute_type"] == "int8":
            params = quantize_params(params)
        tree = load_segmentation_params()
        if tree is None:
            raise FileNotFoundError("no PyanNet checkpoint in the registry")
        self.pipe = TranscribePipeline(
            params, whisper_config(cfg, self.dtype),
            make_test_tokenizer(cfg["num_languages"]),
            vad=VoiceActivityDetector(from_jax_pyannet(tree, device)),
            asr_options={"initial_prompt": mix["initial_prompt"],
                         "beam_size": mix["beam_size"],
                         "max_new_tokens": mix["max_new_tokens"],
                         **mix.get("asr_options", {})},
            language=mix["language"], device=device)
        self.mix = mix

    def warmup(self) -> None:
        """Capture every decode bucket of each decoder the traffic reaches
        (``warmup_temperatures``: a number is the server's temperature
        setting, a list the rungs of a ladder)."""
        for temperature in self.mix["warmup_temperatures"]:
            self.pipe.warmup(batch_size=self.mix["batch_size"],
                             language=self.mix["language"],
                             temperature=temperature)

    def transcribe(self, audio) -> dict:
        return self.pipe.transcribe(
            audio, batch_size=self.mix["batch_size"],
            language=self.mix["language"],
            temperature=list(self.mix["temperatures"]))


class Run:
    """What a metric reader sees."""

    def __init__(self, cell, window, taps, trace, prefix_len):
        self.cell, self.cfg, self.mix = cell, cell["config"], cell["mix"]
        self.done = window["done"]
        self.window_s = window["t1"] - window["t0"]
        self.t0, self.t1 = window["t0"], window["t1"]
        self.taps = taps
        self.trace = trace
        self.prefix_len = prefix_len

    def spans(self, name: str, traced_only: bool = False):
        lo, hi = self.t0, self.t1
        if traced_only:
            traced = [r for r in self.done if r["traced"]]
            if not traced:
                return []
            lo, hi = traced[0]["start"], traced[-1]["end"]
        return [s for s in self.taps.spans
                if s[0] == name and s[2] >= lo and s[3] <= hi]

    def requests(self, traced_only: bool = False):
        return [r for r in self.done if r["traced"] or not traced_only]


def result_line(correct, attempted, failed, metrics, device, breakdown,
                checks) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out, allow_nan=False)


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else 1e30


def main(argv: Optional[List[str]] = None, device_name: Optional[str] = None,
         root: Optional[Path] = None, t_start: Optional[float] = None) -> int:
    """``device_name`` "cpu" runs on the CPU (the tests' rehearsal); a
    benchmark run takes the card and refuses to run without one.
    ``t_start``: when set-up began (the process's start)."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    root = Path(root or os.getcwd()).resolve()
    set_environment(root)
    import torch

    from . import cell as cell_mod
    from . import check as check_mod
    from . import loop
    from . import taps as taps_mod
    from . import trace as trace_mod
    from reference import tokens_ref

    cell = cell_mod.find(root, args.workload)
    kind = cell_mod.kind(root, cell["mix"]["kind"])
    control = (cell_mod.control(root, args.control) if args.control
               else None)
    on_card = device_name is None
    if on_card:
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs on the card only",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            print(f"{cell['chips']} CUDA devices needed, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device(device_name)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    mix, cfg = cell["mix"], cell["config"]
    cell["weight_seed"] = loop.derived_seed(args.seed, 11)
    cell["base_vocab"], cell["num_languages"] = 256, cfg["num_languages"]
    limits = check_mod.load_limits(root, cell["name"])

    taps = taps_mod.Taps().install()
    try:
        # -- set-up -----------------------------------------------------------
        program = Program(cell, cell["weight_seed"], device)
        cell["weight_dtype"] = program.dtype
        window = kind.window(loop.Context(
            program, mix, args.seed, args.seconds, device, on_card,
            bool(args.trace), taps, t_start))
        setup_s = window["setup_s"]
        captures, builds = window["captures"], window["builds"]
        print(f"window: {window['t1'] - window['t0']:.3f} s, "
              f"{len(window['done'])} requests done, graph captures "
              f"{captures}, kernel builds {builds}", file=sys.stderr)
        tracer = window["tracer"]

        # -- metrics ----------------------------------------------------------
        trace = tracer.finish() if tracer else None
        run = Run(cell, window, taps, trace, len(tokens_ref.prefix(
            mix["initial_prompt"], mix["language"], cell["base_vocab"],
            cell["num_languages"], cfg["max_target_positions"])))
        metrics: Dict[str, Dict] = {}
        units = {m["name"]: m["unit"]
                 for m in cell["end_to_end"] + cell["per_layer"]}
        if args.trace:
            for name in cell_mod.metric_names(cell, True):
                value = cell_mod.metric_reader(root, name)(run)
                if value is not None:
                    metrics[name] = {"value": value, "unit": units[name]}
        else:
            for m in cell["end_to_end"]:
                if m["name"] == "setup_s":
                    metrics["setup_s"] = {"value": setup_s, "unit": "s"}
                else:
                    value = cell_mod.metric_reader(root, m["name"])(run)
                    if value is not None:
                        metrics[m["name"]] = {"value": value,
                                              "unit": m["unit"]}
        device_info = {"platform": "gpu" if on_card else device.type,
                       "kind": (torch.cuda.get_device_name(device) if on_card
                                else "cpu"),
                       "count": 1,
                       "memory_peak_bytes": (torch.cuda.max_memory_allocated(
                           device) if on_card else 0)}
        attempted, failed = window["attempted"], window["failed"]
        breakdown = None
        if trace is not None:
            device_info["busy_s"] = trace["busy_s"]
            device_info["window_s"] = trace["window_s"]
            breakdown = trace_mod.breakdown(trace)

    finally:
        taps.remove()

    # -- output check -----------------------------------------------------
    done, audio_of = window["done"], window["audio_of"]
    del program, run, window
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = check_mod.run_check(
        cell, done, audio_of, loop.derived_seed(args.seed, 13), device,
        root / ".weights" / "pyannote-segmentation-3.0" / "pytorch_model.bin",
        mix, control=control)
    numbers["captures_in_window"] = captures
    numbers["builds_in_window"] = builds
    limits = {**limits, "captures_in_window": 0, "builds_in_window": 0}
    correct = (check_mod.judge(numbers, limits) and captures == 0
               and builds == 0 and failed == 0)

    bad = forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    checks = check_mod.as_key({k: _finite(v) for k, v in numbers.items()},
                              limits)
    checks["captures_in_window"] = {"value": captures, "limit": 0}
    checks["builds_in_window"] = {"value": builds, "limit": 0}
    for line in check_mod.vad_lines(numbers):
        print(line, file=sys.stderr)
    for line in check_mod.report_lines(numbers, limits):
        print(line, file=sys.stderr)
    print(f"check captures_in_window = {captures} (limit 0)", file=sys.stderr)
    print(f"check builds_in_window = {builds} (limit 0)", file=sys.stderr)
    sys.stderr.flush()
    print(result_line(correct, attempted, failed,
                      metrics, device_info, breakdown, checks), flush=True)
    return 0
