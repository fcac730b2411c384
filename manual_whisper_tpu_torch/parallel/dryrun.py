"""Multi-process dry run of the mesh path (the port's counterpart of the
root ``__graft_entry__.dryrun_multichip``).

    python -m manual_whisper_tpu_torch.parallel.dryrun 2
    python -m manual_whisper_tpu_torch.parallel.dryrun 4 --meshes 2x2
    torchrun --nproc-per-node N -m manual_whisper_tpu_torch.parallel.dryrun

With a count it starts that many processes on the CPU, joined by gloo
over a file store, one torch thread each, and waits for them (``spawn``,
with a timeout); under ``torchrun`` each process takes the GPU of its
local rank and NCCL.  Each mesh of ``--meshes`` (``DxM``: D data ranks, M
model ranks; default the JAX dry run's layout, M = 2 where the world is
even) runs, on the ``test`` config:

- **inference**: ``load_model(mesh=...)`` transcribes the JAX dry run's
  12 s of amplitude-modulated tone at batch 2 x D in chunks of 1.5 s;
  the segments must equal one process's (``mesh=None``) by the JAX dry
  run's rule: times exact, text within 1 % of characters (and every rank
  returns the same result).  ``--modes`` adds int8 weights, the
  timestamp-token mode, beam search (5 beams) and a sampled ladder (the
  quality gate set so that every row climbs every rung).
- **training**: one AdamW step (lr 1e-3) on a batch of 2 x D rows whose
  label counts differ, with params and moments sharded as the rules say,
  against one process's step on the same global batch.

Every rank prints one JSON line a check; rank 0 writes them all to
``--report``.  Any failed check raises, and the run exits non-zero.
"""

from __future__ import annotations

import argparse
import datetime
import difflib
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import (DATA_AXIS, MODEL_AXIS, axis_size, make_mesh,
                   shard_batch, shard_params)

# the sharded train step against one process's, f32: the loss's relative
# error; the moments' largest error over their leaf's largest magnitude
# (after one step mu is 0.1 g and nu 0.001 g^2, so this holds the
# gradients); the params' largest abs error where |g| >= WELL_POSED_GRAD.
# Adam's first update is lr * g / (|g| + eps): where |g| is near eps (1e-8)
# a gradient's rounding in the last bits moves the update by a good part
# of lr (1e-3), so those elements are not compared.
TRAIN_TOL = {"loss": 1e-5, "moments": 1e-5, "params": 1e-6}
WELL_POSED_GRAD = 1e-6
# mode: (asr_options, compute_type, the temperature ladder).  Random
# weights fail every quality gate, so the greedy modes turn the gates off:
# every row is greedy-decided, and its text must be exact (at f32; bf16
# activations, which int8 runs, round a tensor-parallel product's partial
# sums, so int8 is exact at data parallelism only).  The sampled mode
# retries every row at T = 0.2; its text must be exact outside a tail batch
# that the mesh pads to more rows than one process does (the noise is
# drawn for the batch's rows, so there it differs, as in JAX).
NO_GATES = {"log_prob_threshold": None, "compression_ratio_threshold": None}
MODES = {"greedy": (NO_GATES, "float32", 0.0),
         "int8": (NO_GATES, "int8", 0.0),
         "timestamps": ({"without_timestamps": False}, "float32", 0.0),
         "beam": ({**NO_GATES, "beam_size": 5}, "float32", 0.0),
         "sampled": ({"log_prob_threshold": 0.0}, "float32", (0.0, 0.2))}


def dryrun_audio() -> np.ndarray:
    """The JAX dry run's audio: 12 s of a 220 Hz tone gated at 0.7 Hz."""
    sr = 16000
    t = np.arange(sr * 12) / sr
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            * (0.5 + 0.5 * np.sign(np.sin(2 * np.pi * 0.7 * t)))
            ).astype(np.float32)


def segment_diff(expected: dict, got: dict) -> dict:
    """The JAX dry run's comparison: segment times, then the characters
    that differ over the file's text (difflib's edit ratio)."""
    key = [(s["text"], s["start"], s["end"]) for s in expected["segments"]]
    got_key = [(s["text"], s["start"], s["end"]) for s in got["segments"]]
    ref_text = "".join(t for t, _, _ in key)
    got_text = "".join(t for t, _, _ in got_key)
    ratio = difflib.SequenceMatcher(None, ref_text, got_text).ratio()
    return {"segments": len(key),
            "times_equal": ([(s, e) for _, s, e in key]
                            == [(s, e) for _, s, e in got_key]),
            "text_equal": ref_text == got_text,
            "chars": len(ref_text),
            "chars_differing": round((1.0 - ratio)
                                     * max(len(ref_text), len(got_text)))}


def check_inference(mesh, device: torch.device, mode: str) -> dict:
    from ..pipeline import load_model
    asr, compute_type, temperature = MODES[mode]
    dp = axis_size(mesh, DATA_AXIS)
    audio = dryrun_audio()
    kw = dict(device=device, language="zh", compute_type=compute_type,
              asr_options=asr)
    run = dict(batch_size=2 * dp, language="zh", chunk_size=1.5,
               temperature=temperature)
    expected = load_model("test", mesh=None, **kw).transcribe(audio, **run)
    sharded = load_model("test", mesh=mesh, **kw)
    got = sharded.transcribe(audio, **run)
    q_w = sharded.params["encoder"]["blocks"][0]["attn"]["q_w"]
    width = (q_w["q"] if isinstance(q_w, dict) else q_w).shape[-1]
    line = {"check": "inference", "mode": mode, **segment_diff(expected, got),
            "text_equal_outside_tail": _text_outside_tail(
                expected, got, sharded.last_stats["windows"], 2 * dp, dp),
            "data_parallel": sharded.data_parallel,
            "q_w_local_width": width,
            "rows": sharded.last_stats["rows"],
            "beam_calls": sharded.last_stats["beam_calls"],
            "rung_rows": sharded.last_stats["rung_rows"]}
    results = [None] * dist.get_world_size()
    dist.all_gather_object(results, got["segments"])
    line["ranks_agree"] = all(r == results[0] for r in results)
    d = sharded.cfg.n_audio_state
    line["ok"] = bool(
        line["segments"] and line["times_equal"] and line["ranks_agree"]
        and line["text_equal" if temperature == 0.0
                 else "text_equal_outside_tail"]
        and width == d // axis_size(mesh, MODEL_AXIS)
        and (line["beam_calls"] > 0) == (asr.get("beam_size", 1) > 1))
    return line


def _text_outside_tail(expected: dict, got: dict, windows: int,
                       batch_size: int, dp: int) -> bool:
    """Texts equal over the segments of every batch both runs decode at
    the same rows (all but a tail batch the mesh pads to more rows; the
    segments map to windows one to one when none was dropped)."""
    from ..pipeline.chunking import _bucket_for
    tail = windows % batch_size
    skip = (tail if tail and _bucket_for(tail, batch_size, dp)
            != _bucket_for(tail, batch_size) else 0)
    a, b = expected["segments"], got["segments"]
    if skip and len(a) != windows:
        return False
    return ([s["text"] for s in a[:len(a) - skip]]
            == [s["text"] for s in b[:len(b) - skip]])


def train_batch(rows: int, cfg, seed: int = 0):
    """A seeded batch of ``rows`` whose label counts differ row to row."""
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((rows, cfg.n_mels, 2 * cfg.n_audio_ctx)
                              ).astype(np.float32)
    tokens = rng.integers(0, cfg.n_vocab, (rows, 12)).astype(np.int64)
    mask = np.zeros((rows, 12), np.float32)
    for r in range(rows):
        mask[r, 1:2 + (5 * r + 3) % 11] = 1.0
    return tuple(torch.from_numpy(x) for x in (mel, tokens, mask))


def max_leaf_err(a, b, relative: bool = False) -> float:
    from ..training.optim import tree_leaves
    return max(float((x.float() - y.float()).abs().max()
                     / (y.float().abs().max().clamp_min(1e-30)
                        if relative else 1.0))
               for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


def well_posed_param_err(params, want, mu_want) -> Tuple[float, float]:
    """(largest abs error, share of elements compared) of params after
    one AdamW step, over the elements whose gradient (10 mu) is at least
    WELL_POSED_GRAD."""
    from ..training.optim import tree_leaves
    err, kept, total = 0.0, 0, 0
    for x, y, m in zip(tree_leaves(params), tree_leaves(want),
                       tree_leaves(mu_want), strict=True):
        well = 10.0 * m.abs() >= WELL_POSED_GRAD
        kept, total = kept + int(well.sum()), total + well.numel()
        if well.any():
            err = max(err, float((x - y).abs()[well].max()))
    return err, kept / total


def check_train(mesh, device: torch.device) -> dict:
    from ..models.whisper import MODEL_CONFIGS, init_params
    from ..training import adamw, init_train_state, make_train_step
    from ..training.optim import tree_leaves
    cfg = MODEL_CONFIGS["test"]
    dp = axis_size(mesh, DATA_AXIS)
    batch = tuple(x.to(device) for x in train_batch(2 * dp, cfg))
    optimizer = adamw(1e-3)

    ref = init_train_state(init_params(cfg, device, seed=0), optimizer)
    ref, ref_loss = make_train_step(cfg, optimizer)(ref, *batch)

    state = init_train_state(
        shard_params(init_params(cfg, device, seed=0), mesh), optimizer)
    state, loss = make_train_step(cfg, optimizer, mesh=mesh)(
        state, *shard_batch(batch, mesh))
    mu_want = shard_params(ref.opt_state.mu, mesh)
    params_err, compared = well_posed_param_err(
        state.params, shard_params(ref.params, mesh), mu_want)
    errs = {"loss": abs(float(loss) - float(ref_loss))
            / max(abs(float(ref_loss)), 1e-12),
            "moments": max(
                max_leaf_err(state.opt_state.mu, mu_want, relative=True),
                max_leaf_err(state.opt_state.nu,
                             shard_params(ref.opt_state.nu, mesh),
                             relative=True)),
            "params": params_err}
    q_w = state.params["encoder"]["blocks"][0]["attn"]["q_w"]
    mu = state.opt_state.mu["encoder"]["blocks"][0]["attn"]["q_w"]
    same_shards = all(
        m.shape == p.shape and m.device == p.device
        for m, p in zip(tree_leaves(state.opt_state.mu),
                        tree_leaves(state.params), strict=True))
    line = {"check": "train", "loss": float(loss),
            "loss_one_process": float(ref_loss), "errors": errs,
            "tol": TRAIN_TOL, "params_compared": compared, "q_w_local": list(q_w.shape),
            "mu_local": list(mu.shape), "moments_on_param_shards":
            same_shards}
    line["ok"] = bool(np.isfinite(float(loss)) and same_shards
                      and all(errs[k] <= TRAIN_TOL[k] for k in errs))
    return line


def parse_meshes(text: Optional[str], world: int) -> List[Tuple[int, int]]:
    if not text:
        mp = 2 if world % 2 == 0 and world >= 2 else 1
        return [(world // mp, mp)]
    return [tuple(int(v) for v in m.split("x")) for m in text.split(",")]


def run(meshes: Sequence[Tuple[int, int]], modes: Sequence[str],
        device: torch.device, report: Optional[str]) -> List[dict]:
    """Every check on every mesh, in this process of the world."""
    lines = []
    for dp, mp in meshes:
        mesh = make_mesh(dp * mp, model_parallel=mp)
        layout = {"data": dp, "model": mp}
        for mode in modes:
            if mp > 1 and MODES[mode][1] != "float32":
                continue               # bf16 activations: see MODES
            t0 = time.perf_counter()
            lines.append({"mesh": layout,
                          **check_inference(mesh, device, mode),
                          "seconds": time.perf_counter() - t0})
            print(json.dumps(lines[-1]), flush=True)
        t0 = time.perf_counter()
        lines.append({"mesh": layout, **check_train(mesh, device),
                      "seconds": time.perf_counter() - t0})
        print(json.dumps(lines[-1]), flush=True)
    if report and dist.get_rank() == 0:
        with open(report, "w", encoding="utf-8") as f:
            json.dump(lines, f)
    failed = [ln for ln in lines if not ln["ok"]]
    if failed:
        raise AssertionError(f"dry run checks failed: {failed}")
    return lines


def worker(rank: int, world: int, store: str, args) -> None:
    """One CPU process of a ``spawn``ed gloo world."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=args.timeout))
    try:
        run(parse_meshes(args.meshes, world), args.modes.split(","),
            torch.device("cpu"), args.report)
    finally:
        dist.destroy_process_group()


def spawn(n: int, meshes: Optional[str] = None, modes: str = "greedy",
          report: Optional[str] = None, timeout: float = 300.0,
          workdir: Optional[str] = None,
          env: Optional[Dict[str, str]] = None) -> None:
    """Run the dry run in ``n`` CPU processes joined by gloo over a file
    store in ``workdir`` (default a temporary directory), with ``env``
    added to the environment; raises when one fails or the world outlives
    ``timeout`` seconds (then every process is killed)."""
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        store = os.path.join(tmp, "store")
        cmd = [sys.executable, "-m", "manual_whisper_tpu_torch.parallel.dryrun",
               "--worker-of", str(n),
               "--store", store, "--modes", modes,
               "--timeout", str(int(timeout))]
        if meshes:
            cmd += ["--meshes", meshes]
        if report:
            cmd += ["--report", report]
        env = {**os.environ, **(env or {}), "OMP_NUM_THREADS": "1"}
        # the package's parent directory, so ``-m`` finds the package
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env,
                                  cwd=root) for r in range(n)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in procs]
        if any(codes):
            raise RuntimeError(f"dry run processes exited with {codes}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int,
                    help="CPU processes to spawn (omit under torchrun)")
    ap.add_argument("--meshes", default=None, metavar="DxM[,DxM]")
    ap.add_argument("--modes", default="greedy",
                    help=f"inference modes, of {sorted(MODES)}")
    ap.add_argument("--report", default=None)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--worker-of", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker_of is not None:
        worker(args.rank, args.worker_of, args.store, args)
        return 0
    if args.n is not None:
        spawn(args.n, args.meshes, args.modes, args.report, args.timeout)
        return 0
    # under torchrun: one GPU a process, NCCL, float32 without TF32
    if not torch.cuda.is_available():
        raise SystemExit("dryrun: give a process count for the CPU, or run "
                         "under torchrun on GPUs")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    local = int(os.environ["LOCAL_RANK"])
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", timeout=datetime.timedelta(
        seconds=args.timeout))
    try:
        run(parse_meshes(args.meshes, dist.get_world_size()),
            args.modes.split(","), torch.device("cuda", local), args.report)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
