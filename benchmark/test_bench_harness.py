"""CPU tests of the harness: the traffic generator, the yardstick's
arithmetic, the refusal without a card, cells added as new files only (a
configuration of each compute type, a mix of a new kind, a metric), the
output check against planted faults and its controls, and the modules a
run loads.  The card-only test (the controls at a cell's own size) is
marked ``cuda``.

    python -m pytest benchmark/test_bench_harness.py -q
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

from harness import cell as cell_mod  # noqa: E402
from harness import flops, main  # noqa: E402

TINY_CONFIG = {"d_model": 64, "encoder_layers": 2, "decoder_layers": 2,
               "encoder_attention_heads": 2, "decoder_attention_heads": 2,
               "encoder_ffn_dim": 256, "decoder_ffn_dim": 256,
               "num_hidden_layers": 2, "num_mel_bins": 80,
               "vocab_size": 2000, "max_source_positions": 150,
               "max_target_positions": 64}
TINY_LIMITS = {"vad_prob_gap_p999": 3e-3, "window_mismatch": 0,
               "token_logit_gap": 0.05, "avg_logprob_gap": 0.05,
               "forbidden_tokens": 0, "missing_windows": 0}
NEW_METRIC = '''"""Windows a recording gives (a metric added as a new file)."""


def read(run):
    reqs = [r for r in run.done if "stats" in r["record"]]
    return sum(r["record"]["stats"]["windows"] for r in reqs) / len(reqs)
'''
NEW_KIND = '''"""Clips: one recording length, each clip sent twice in a row (a mix
kind added as a new file)."""

import numpy as np

from harness import loop


def inputs(mix, seed, seconds):
    rng = np.random.default_rng([seed, 4])
    return [{"input": i // 2, "seconds": float(mix["clip_s"]),
             "seed": int(rng.integers(2**31)) if i % 2 == 0 else None}
            for i in range(2 * mix["clips"])]


def window(ctx):
    reqs = inputs(ctx.mix, ctx.seed, ctx.seconds)
    audio = {r["input"]: ctx.speech(r["seconds"], r["seed"])
             for r in reqs if r["seed"] is not None}
    ctx.warm_up()
    return ctx.measure(lambda tracer: loop.closed_loop(
        ctx.program.transcribe, reqs, audio.__getitem__, ctx.seconds,
        ctx.taps, tracer, 1), audio_of=audio.__getitem__)
'''


def _digest(path: Path) -> str:
    h = hashlib.sha256()
    for p in sorted(path.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(path)).encode() + p.read_bytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A checkout with cells added as new files only: configurations in
    bfloat16, float32 and int8, a traffic mix of the existing kind and one
    of a new kind, a per-layer metric, the cells' limits, and their entries
    in BENCHMARK.json."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in (".weights", "manual_whisper_tpu_torch"):
        (root / name).symlink_to(ROOT / name)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = json.loads((HERE / "configs" / "whisper-large-v3.bf16.json")
                      .read_text())
    for name, compute_type in (("tiny.test", "bfloat16"),
                               ("tiny.f32", "float32"),
                               ("tiny.int8", "int8")):
        cfg = dict(base, **TINY_CONFIG, name=name, compute_type=compute_type)
        (root / f"benchmark/configs/{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"benchmark/configs/{name}.json",
                                 "reduced": [], "why": "test"})
    mix = json.loads((HERE / "traffic" / "meeting.json").read_text())
    mix.update(lengths_s=[20, 30], batch_size=4, warmup_s=6)
    (root / "benchmark/traffic/tiny.json").write_text(
        json.dumps(mix, ensure_ascii=False))
    clips = dict(mix, kind="clips", clip_s=12, clips=2)
    del clips["lengths_s"]
    (root / "benchmark/traffic/tinyclips.json").write_text(
        json.dumps(clips, ensure_ascii=False))
    (root / "benchmark/kinds/clips.py").write_text(NEW_KIND)
    (root / "benchmark/metrics/windows_per_request.tiny.py").write_text(
        NEW_METRIC)
    cells = [("tiny.meeting", "tiny.test", "tiny"),
             ("tiny.f32.meeting", "tiny.f32", "tiny"),
             ("tiny.int8.meeting", "tiny.int8", "tiny"),
             ("tiny.clips", "tiny.test", "tinyclips")]
    for name, config, traffic in cells:
        (root / f"benchmark/limits/{name}.json").write_text(
            json.dumps({"limits": TINY_LIMITS}))
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "turbo.meeting" in m.get("workloads", []):
            m["workloads"] += [c[0] for c in cells]
    bench["per_layer"].append({
        "name": "windows_per_request.tiny", "unit": "windows",
        "better": "lower", "source": "program_counter", "layer": "test",
        "moves": "audio_s_per_s",
        "workloads": ["tiny.meeting", "tiny.clips"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(root, capsys, *extra, seed=3000000001, trace=0,
         workload="tiny.meeting"):
    rc = main.main(["--workload", workload, "--seed", str(seed),
                    "--seconds", "1", "--trace", str(trace), *extra],
                   device_name="cpu", root=root)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    return json.loads(out.out.strip().splitlines()[-1]), out.err


# -- traffic --------------------------------------------------------------

def test_recordings_deterministic_per_seed():
    kind = cell_mod.kind(ROOT, "recordings")
    mix = json.loads((HERE / "traffic" / "meeting.json").read_text())
    a, b = kind.inputs(mix, 2**31 + 5, 45), kind.inputs(mix, 2**31 + 5, 45)
    c = kind.inputs(mix, 2**31 + 6, 45)
    assert a == b and a != c
    # every seed the same set of lengths, in its own order
    assert sorted(r["seconds"] for r in a) == sorted(r["seconds"] for r in c)


def test_every_mix_names_a_kind():
    for path in (HERE / "traffic").glob("*.json"):
        kind = json.loads(path.read_text())["kind"]
        assert (HERE / "kinds" / f"{kind}.py").is_file(), path.name


# -- arithmetic -------------------------------------------------------------

LARGE_V3 = json.loads((HERE / "configs" / "whisper-large-v3.bf16.json")
                      .read_text())


def test_flash_attention_bound_by_hand():
    # 4 * 16 rows * 20 heads * 1500^2 * 64 = 1.8432e11 FLOP at 989e12 is
    # 1.8637e-4 s; its bytes, 4 * 16 * 20 * 1500 * 64 * 2 = 1.2288e8 at
    # 3.35e12, 3.668e-5 s: bound by the operations
    assert flops.flash_attention_bound_s(16, 20, 1500, 64) == pytest.approx(
        1.8432e11 / 989e12)


def test_cross_attention_bound_by_hand():
    # K and V: 2 * 16 * 20 * 1500 * 64 bf16 values, q and out 2 * 16 * 20
    # * 64: 122,961,920 bytes at 3.35e12 = 3.6705e-5 s; the operations,
    # 1.2288e8 at 67e12, 1.83e-6 s: bound by the bytes
    assert flops.cross_attention_bound_s(16, 20, 1500, 64) == pytest.approx(
        122_961_920 / 3.35e12)


def test_model_flops_by_hand():
    # encoder: convs 2*3000*128*1280*3 + 2*1500*1280^2*3 = 1.76947e10;
    # a block 2*1500*(4*1280^2 + 2*1280*5120) + 4*1500^2*1280
    # = 7.05024e10, 32 of them 2.256077e12
    assert flops.encoder_flops(LARGE_V3) == pytest.approx(
        1.769472e10 + 32 * 7.05024e10)
    # one served token after the first adds a step: 32 layers of
    # 2*(6*1280^2 + 2*1280*5120) + 4*(p+1)*1280 + 4*1500*1280, and the
    # logits 2*1280*51866
    p = 193
    step = 32 * (2 * (6 * 1280**2 + 2 * 1280 * 5120) + 4 * (p + 1) * 1280
                 + 4 * 1500 * 1280) + 2 * 1280 * 51866
    assert (flops.decoder_row_flops(LARGE_V3, p, 2)
            - flops.decoder_row_flops(LARGE_V3, p, 1)) == pytest.approx(step)
    assert flops.model_flops(LARGE_V3, p, [1, 2]) == pytest.approx(
        2 * flops.encoder_flops(LARGE_V3)
        + flops.decoder_row_flops(LARGE_V3, p, 1)
        + flops.decoder_row_flops(LARGE_V3, p, 2))


def test_roofline_reader_by_hand():
    """The K2 reader: one traced encode of 16 rows, 32 launches taking
    20 ms of device time: 32 * 1.8637e-4 s / 0.02 s = 29.82 %."""
    read = cell_mod.metric_reader(ROOT, "flash_attention_roofline.meeting")

    class FakeRun:
        cfg = LARGE_V3
        trace = {"device_s_by_name": {"flash_kernel<64>": 0.02, "x": 1.0},
                 "launches_by_name": {"flash_kernel<64>": 32, "x": 9}}

        def spans(self, name, traced_only=False):
            return [("encode", "t", 0.0, 1.0, {"rows": 16})] * (
                name == "encode")

    assert read(FakeRun()) == pytest.approx(
        100 * 32 * 1.8432e11 / 989e12 / 0.02)


def test_mfu_reader_by_hand():
    """One traced window of 2 s holding one real window that served 3
    tokens and ended on end-of-text (4 positions)."""
    read = cell_mod.metric_reader(ROOT, "mfu.meeting")

    class FakeRun:
        cfg, mix, prefix_len = LARGE_V3, {"max_new_tokens": 224}, 193
        trace = {"window_s": 2.0}

        def requests(self, traced_only=False):
            return [{"record": {"batches": [[(0.0, 30.0)]],
                                "results": {0: [([1, 2, 3], -1.0)]}}}]

    work = flops.model_flops(LARGE_V3, 193, [4])
    assert read(FakeRun()) == pytest.approx(100 * work / (2.0 * 989e12))


class _Event:
    def __init__(self, name, start, dur, cuda, annotation=False):
        from torch.autograd import DeviceType
        self._n, self._s, self._d, self._a = name, start, dur, annotation
        self._t = DeviceType.CUDA if cuda else DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._t

    def is_user_annotation(self):
        return self._a


def test_trace_reduce_by_hand():
    """Busy time is the union of device intervals inside the window;
    annotations' device copies are no work; the idle gap of 4 ms is
    filed under the innermost host span covering it."""
    from harness import trace
    ms = 1_000_000
    events = [_Event("mwx.window", 0, 10 * ms, False),
              _Event("mwx.transcribe", 0, 10 * ms, False),
              _Event("mwx.vad", 3 * ms, 5 * ms, False),
              _Event("mwx.decode", 0, 10 * ms, True, annotation=True),
              _Event("k1", 1 * ms, 2 * ms, True),
              _Event("k2", 2 * ms, 1 * ms, True),      # overlaps k1
              _Event("k1", 7 * ms, 2 * ms, True),
              _Event("k3", 11 * ms, 2 * ms, True)]     # after the window
    r = trace.reduce(events)
    assert r["window_s"] == pytest.approx(0.010)
    assert r["busy_s"] == pytest.approx(0.004)
    assert r["device_s_by_name"] == pytest.approx({"k1": 0.004, "k2": 0.001})
    assert r["gaps"][0] == ("host:vad", pytest.approx(0.004))
    assert trace.kernel_seconds(r, lambda n: n == "k1") == (
        pytest.approx(0.004), 2)


# -- refusals ---------------------------------------------------------------

def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = main.main(["--workload", "v3.meeting", "--seed", "1",
                    "--seconds", "1", "--trace", "0"], root=ROOT)
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_bare_directory_refused(tmp_path):
    """A directory holding only BENCHMARK.json and benchmark/ has no program
    to run: no result, a non-zero exit."""
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "v3.meeting",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "manual_whisper_tpu_torch_x", sys)
    assert "manual_whisper_tpu" not in main.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in main.forbidden_loaded()


# -- a cell added as new files ----------------------------------------------

def test_new_cell_from_new_files(tiny_root, capsys):
    before = _digest(HERE)
    result, err = _run(tiny_root, capsys, trace=1)
    assert result["correct"], err[-3000:]
    assert result["metrics"]["windows_per_request.tiny"]["value"] > 0
    # the cell's span readers report; the trace's find nothing on the CPU
    assert "decode_ms_per_token_row.meeting" in result["metrics"]
    assert "mfu.meeting" not in result["metrics"]
    assert list(result)[-1] == "checks"
    assert _digest(HERE) == before
    result, _ = _run(tiny_root, capsys, seed=5)
    assert result["correct"]
    assert set(result["metrics"]) == {"audio_s_per_s", "setup_s"}


@pytest.mark.parametrize("workload,dtype,quantized", [
    ("tiny.f32.meeting", torch.float32, False),
    ("tiny.int8.meeting", torch.bfloat16, True)])
def test_compute_type_from_config_file(workload, dtype, quantized,
                                       tiny_root, capsys, monkeypatch):
    """A configuration file's compute type reaches the program as the
    port's load_model serves it, and the run checks out correct."""
    built = []
    orig = main.Program.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        built.append(self)
    monkeypatch.setattr(main.Program, "__init__", init)
    result, err = _run(tiny_root, capsys, workload=workload, seed=21)
    assert result["correct"], err[-3000:]
    from manual_whisper_tpu_torch.ops.quant import is_quantized
    pipe = built[0].pipe
    assert pipe.cfg.dtype == dtype
    assert is_quantized(
        pipe.params["decoder"]["blocks"][0]["mlp"]["fc1_w"]) == quantized


def test_new_kind_from_new_files(tiny_root, capsys):
    """A mix of a kind that only a new file defines runs: each clip sent
    twice, every request checked out."""
    result, err = _run(tiny_root, capsys, workload="tiny.clips", seed=17,
                       trace=1)
    assert result["correct"] and result["failed"] == 0, err[-3000:]
    assert result["attempted"] >= 1
    assert result["metrics"]["windows_per_request.tiny"]["value"] > 0


def test_run_loads_no_jax(tiny_root):
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from harness import main\n"
            "rc = main.main(['--workload', 'tiny.meeting', '--seed', '9',"
            " '--seconds', '1', '--trace', '0'], device_name='cpu',"
            " root=%r)\n"
            "print('LOADED', main.forbidden_loaded(), rc)\n"
            % (str(HERE), str(ROOT), str(tiny_root)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert "LOADED [] 0" in proc.stdout, proc.stderr[-2000:]


# -- planted faults ----------------------------------------------------------

def _fault_token(monkeypatch):
    """A served token altered where it is produced (the sixth)."""
    from manual_whisper_tpu_torch.models import decode
    orig = decode.GreedyPick.step

    def step(self, logits, st):
        out, tok = orig(self, logits, st)
        return out, torch.where(st.i == 5, (tok + 7) % 200, tok)
    monkeypatch.setattr(decode.GreedyPick, "step", step)


def _fault_unchanged(monkeypatch):
    """Decode steps that return their state unchanged."""
    from manual_whisper_tpu_torch.models import decode
    monkeypatch.setattr(decode, "decode_chunk", lambda *a, **k: None)


def _fault_half_batch(monkeypatch):
    """Half of each batch left out: its rows encoded from silence."""
    from manual_whisper_tpu_torch.pipeline import transcribe as tr
    orig = tr.TranscribePipeline._encode_windows

    def encode(self, windows):
        windows = windows.copy()
        windows[len(windows) // 2:] = 0.0
        return orig(self, windows)
    monkeypatch.setattr(tr.TranscribePipeline, "_encode_windows", encode)


def _fault_vad(monkeypatch):
    """Speech probabilities altered where they are produced."""
    from manual_whisper_tpu_torch.models import vad
    orig = vad.powerset_to_speech_prob
    monkeypatch.setattr(vad, "powerset_to_speech_prob",
                        lambda lp: orig(lp) * 0.97)


@pytest.mark.parametrize("fault", [_fault_token, _fault_unchanged,
                                   _fault_half_batch, _fault_vad])
def test_fault_is_not_correct(fault, tiny_root, capsys, monkeypatch):
    fault(monkeypatch)
    result, _ = _run(tiny_root, capsys, seed=11)
    assert result["correct"] is False
    assert any(c.get("limit") is not None and c["value"] > c["limit"]
               for c in result["checks"].values())


@pytest.mark.parametrize("control,fails", [
    ("vad_tf32", {"vad_prob_gap_p999"}),
    ("fp8", {"token_logit_gap", "avg_logprob_gap"})])
def test_control_module_swaps_one_part(control, fails, tiny_root, capsys):
    """A control stands in for one part only: the other part's numbers
    read as the program's own (on the CPU TF32 is no lower precision, so
    the VAD control reads the reference exactly)."""
    ok, _ = _run(tiny_root, capsys, seed=11)
    result, _ = _run(tiny_root, capsys, "--control", control, seed=11)
    c, base = result["checks"], ok["checks"]
    others = {"vad_prob_gap_p999", "token_logit_gap", "avg_logprob_gap"} - fails
    for name in others:
        assert c[name]["value"] == base[name]["value"], name
    if control == "vad_tf32":
        assert c["vad_prob_gap_p999"]["value"] == 0.0
    else:
        assert any(c[n]["value"] != base[n]["value"] for n in fails)


# -- the controls, on the card ----------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("control,part", [
    ("vad_tf32", {"vad_prob_gap_p999", "window_mismatch"}),
    ("fp8", {"token_logit_gap", "avg_logprob_gap"})])
@pytest.mark.parametrize("cell", ["v3.meeting", "turbo.meeting"])
def test_control_is_not_correct(cell, control, part):
    """A lower precision in one part's place, at the cell's own size:
    ``correct`` comes out false through a number of that part, and the
    other part's numbers stay within their limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147489001", "--seconds", "10", "--trace", "0", "--control",
         control], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    print(cell, control, json.dumps(result["checks"]))
    assert result["correct"] is False
    over = {k for k, c in result["checks"].items()
            if c.get("limit") is not None and c["value"] > c["limit"]}
    assert over and over <= part, over
