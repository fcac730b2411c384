"""PyTorch port: the CLI and the job server on every device of the host
(``parallel/launch.py``), on the CPU.

- ``world_size_wanted`` against the JAX ``_auto_mesh``'s mesh size, with
  ``jax.device_count`` standing in for the device count, over the three
  knobs (``MWX_AUTO_MESH``, ``MWX_MODEL_PARALLEL``, ``MWX_DATA_PARALLEL``);
- a 2-process gloo world joined from the environment as under
  ``torchrun``, each rank running ``cli.main`` on the ``test`` config in a
  directory of its own: rank 0 writes the Markdown, which equals one
  process's apart from the timing and device lines, and the JSON, whose
  segments have one process's text and times, and the other rank writes
  and prints nothing;
- a 2-process gloo world that rank 0 starts (``start_world`` with a world
  size), where ``PipelineBackend(device="cpu")`` leads: a job and a
  second-pass clip on two threads of rank 0 at once both equal one
  process's results, and the follower ran both calls and exits when rank
  0 leaves; a follower that raises makes rank 0 fail within the world's
  timeout.

Each world runs in about 10-20 s here: two interpreters importing torch,
one torch thread each.  The CLI world runs at ``BATCH_SIZE=16``: at 16 the
data-parallel mesh's batch buckets (2, 4, 8, 16) are one process's, so
sampled rungs draw the same noise (at the default 4 a one-row tail is two
rows on a 2-rank mesh and draws other noise, ROADMAP Queue C item 4).
"""

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from cpu_budget import one_torch_thread  # noqa: F401
from manual_whisper_tpu_torch import config as tconfig
from manual_whisper_tpu_torch.parallel import launch

from test_torch_pipeline import _markdown_without_run_lines, _wav_fixture

ROOT = Path(__file__).resolve().parent.parent
WORLD_TIMEOUT = 120


# ---------------------------------------------------------------------------
# How many processes: the JAX _auto_mesh rule
# ---------------------------------------------------------------------------

KNOBS = [(auto, mp, cap) for auto in ("true", "false")
         for mp in ("1", "2", "3") for cap in ("", "1", "2")]


@pytest.mark.parametrize("devices", [0, 1, 2, 4, 6, 8])
@pytest.mark.parametrize("auto,mp,cap", KNOBS,
                         ids=lambda v: v or "nocap")
def test_world_size_matches_jax_auto_mesh(monkeypatch, devices, auto, mp,
                                          cap):
    import jax
    import manual_whisper_tpu.parallel as jparallel
    from manual_whisper_tpu import config as jconfig
    from manual_whisper_tpu.pipeline import transcribe as jtranscribe
    monkeypatch.setenv("MWX_AUTO_MESH", auto)
    monkeypatch.setenv("MWX_MODEL_PARALLEL", mp)
    if cap:
        monkeypatch.setenv("MWX_DATA_PARALLEL", cap)
    else:
        monkeypatch.delenv("MWX_DATA_PARALLEL", raising=False)
    jconfig.clear_env_cache()
    tconfig.clear_env_cache()
    made = []
    monkeypatch.setattr(jax, "device_count", lambda: devices)
    monkeypatch.setattr(jparallel, "make_mesh",
                        lambda n, model_parallel=1: made.append(n) or n)
    want = 1 if jtranscribe._auto_mesh() is None else made[0]
    monkeypatch.setattr(launch.torch.cuda, "device_count", lambda: devices)
    assert launch.world_size_wanted() == want
    assert launch.world_size_wanted("cpu") == 1


def test_no_world_without_a_second_device(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.setattr(launch.torch.cuda, "device_count", lambda: 1)
    assert launch.start_world(["-c", "pass"]) is None
    assert launch.start_world(["-c", "pass"], device="cpu") is None


# ---------------------------------------------------------------------------
# The CLI in a world joined from the environment (as under torchrun)
# ---------------------------------------------------------------------------

def _world_env(tmp_path, **extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT),
               WORLD_SIZE="2", **{launch.STORE_ENV: str(tmp_path / "store"),
                                  launch.DEVICE_ENV: "cpu"}, **extra)
    env.pop("HF_TOKEN", None)
    return env


def test_cli_world_writes_one_processs_markdown(tmp_path, monkeypatch,
                                               capsys):
    from manual_whisper_tpu_torch import cli
    wav = tmp_path / "meeting.wav"
    _wav_fixture(wav)
    monkeypatch.setenv("WHISPER_MODEL", "test")
    monkeypatch.setenv("BATCH_SIZE", "16")
    monkeypatch.delenv("HF_TOKEN", raising=False)
    tconfig.clear_env_cache()
    alone = tmp_path / "alone"
    alone.mkdir()
    monkeypatch.chdir(alone)
    assert cli.main([str(wav)], device="cpu") == 0
    assert "📊 配置: 模型=test | 设备=cpu" in capsys.readouterr().out

    code = ("import sys; from manual_whisper_tpu_torch import cli; "
            f"sys.exit(cli.main([{str(wav)!r}], device='cpu'))")
    procs, dirs = [], []
    t0 = time.monotonic()
    for rank in range(2):
        d = tmp_path / f"rank{rank}"
        d.mkdir()
        dirs.append(d)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=d,
            env=_world_env(tmp_path, RANK=str(rank), LOCAL_RANK=str(rank)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=WORLD_TIMEOUT) for p in procs]
    seconds = time.monotonic() - t0
    assert [p.returncode for p in procs] == [0, 0], outs
    assert seconds < WORLD_TIMEOUT
    assert _markdown_without_run_lines(dirs[0] / "meeting_transcript.md") \
        == _markdown_without_run_lines(alone / "meeting_transcript.md")
    # the JSON's segments: the same text and times (each rank's share of
    # a batch rounds its bf16 logprobs apart from the whole batch's)
    got, want = (json.loads((d / "meeting_transcript.json").read_text())
                 for d in (dirs[0], alone))
    assert got["language"] == want["language"]
    assert _keys(got) == _keys(want) and got["segments"]
    assert list(dirs[1].iterdir()) == []
    assert "✍️ 转写中" in outs[0][0] and outs[1][0] == ""


# ---------------------------------------------------------------------------
# The job backend in a world that rank 0 starts
# ---------------------------------------------------------------------------

WORLD_SCRIPT = textwrap.dedent('''
    """Rank 0 leads PipelineBackend; rank 1 follows (``fail``: it raises)."""
    import json
    import sys
    import threading

    sys.path.insert(0, {root!r})
    from manual_whisper_tpu_torch.audio import load_audio
    from manual_whisper_tpu_torch.parallel.launch import (Leader, follow,
                                                          start_world)
    from manual_whisper_tpu_torch.serving.jobs import PipelineBackend

    out, mode, wav, clip = sys.argv[1:5]


    def follower(backend, world):
        if mode == "fail":
            def planted(*a, **k):
                raise RuntimeError("planted follower failure")
            backend.model.transcribe = planted
        print(json.dumps({{"rank": world.rank,
                          "followed": follow(backend.model, world)}}),
              flush=True)


    def leader(backend, world):
        backend.model = Leader(backend.model, world)
        got, errors = {{}}, []

        def job():
            try:
                got["job"] = backend.transcribe(wav, "zh", lambda p, m: None)
            except BaseException as exc:
                errors.append(exc)

        def second_pass():
            try:
                got["clip"] = backend.transcribe_clip(load_audio(clip), "zh",
                                                      0.6, 0.42)
            except BaseException as exc:
                errors.append(exc)
        threads = [threading.Thread(target=job, name="job-worker")]
        if mode != "fail":
            threads.append(threading.Thread(target=second_pass,
                                            name="second-pass"))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            print(f"RANK0 RAISED: {{errors[0]!r}}", flush=True)
            raise errors[0]
        with open(out, "w") as f:
            json.dump({{"calls": backend.model.calls, "results": got}}, f)


    world = start_world([__file__, *sys.argv[1:]], device="cpu",
                        world_size=2, timeout=60)
    with world:
        backend = PipelineBackend(model_name="test", device=world.device)
        (leader if world.rank == 0 else follower)(backend, world)
''')


def _keys(result):
    return [(s["text"], s["start"], s["end"]) for s in result["segments"]]


def _run_world(tmp_path, mode):
    from manual_whisper_tpu_torch.audio import write_wav
    from test_torch_pipeline import _synth_file
    wav, clip = tmp_path / "job.wav", tmp_path / "clip.wav"
    write_wav(wav, _synth_file(7, n_utts=4)[0], 16000)
    write_wav(clip, _synth_file(5, n_utts=1)[0], 16000)
    script = tmp_path / "world.py"
    script.write_text(WORLD_SCRIPT.format(root=str(ROOT)))
    out = tmp_path / f"{mode}.json"
    env = dict(os.environ, OMP_NUM_THREADS="1", WHISPER_MODEL="test")
    env.pop("HF_TOKEN", None)
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, str(script), str(out), mode, str(wav), str(clip)],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=WORLD_TIMEOUT)
    return proc, out, time.monotonic() - t0, wav, clip


def test_backend_world_matches_one_process(tmp_path, monkeypatch):
    from manual_whisper_tpu_torch.audio import load_audio
    from manual_whisper_tpu_torch.serving.jobs import PipelineBackend
    proc, out, seconds, wav, clip = _run_world(tmp_path, "ok")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert seconds < WORLD_TIMEOUT
    got = json.loads(out.read_text())
    followers = [json.loads(ln) for ln in proc.stdout.splitlines()
                 if ln.startswith('{"rank"')]
    assert followers == [{"rank": 1, "followed": 2}] and got["calls"] == 2
    monkeypatch.setenv("WHISPER_MODEL", "test")
    tconfig.clear_env_cache()
    alone = PipelineBackend(model_name="test", device="cpu")
    job = alone.transcribe(str(wav), "zh", lambda p, m: None)
    second = alone.transcribe_clip(load_audio(clip), "zh", 0.6, 0.42)
    assert job["segments"] and second["segments"]
    assert _keys(got["results"]["job"]) == _keys(job)
    assert _keys(got["results"]["clip"]) == _keys(second)


def test_failing_follower_fails_rank0(tmp_path):
    proc, out, seconds, _, _ = _run_world(tmp_path, "fail")
    assert proc.returncode != 0
    assert seconds < WORLD_TIMEOUT
    assert "planted follower failure" in proc.stderr
    assert ("RANK0 RAISED" in proc.stdout
            or "world: rank 1 exited with code" in proc.stderr)
    assert not out.exists()
