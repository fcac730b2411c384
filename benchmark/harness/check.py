"""What decides ``correct``: the program's output in the window against the
plain references, once the window has closed and the program is freed.

From the requests the window finished, a sample drawn from the seed, the
longest recording always in it.  For each sampled recording:

- ``vad_prob_gap_p999``: the 99.9th percentile over frames of the gap
  between the program's speech probabilities and the reference
  PyanNet's (float32, TF32 off), the largest over the recordings.  Not
  the widest gap: at a few frames of a few recordings PyanNet turns a
  rounding-sized difference (the reference's own float32 sinc filters)
  into 0.07-0.23, where the program's float32 and float64 agree;
- ``window_mismatch``: windows the program dispatched that differ from
  the windows its own probabilities give under pyannote's hysteresis and
  WhisperX's merge (exact: limit 0);
- ``token_logit_gap``: for every token served in every window of the
  recording, how far the reference Whisper's logit of that token lies
  below its best logit among the tokens greedy decoding may pick, the
  reference run teacher-forced over the prompt and the served tokens;
- ``avg_logprob_gap``: for every window, the gap between the average
  log-probability the program reports for its served tokens (the quality
  gate of the fallback ladder) and the reference's, over the same masked
  softmax and the same count (tokens + 1);
- ``forbidden_tokens``: served tokens that greedy decoding may not pick
  (exact: limit 0);
- ``missing_windows``: windows dispatched without served tokens (limit 0).

Limits come from ``benchmark/limits/<cell>.json``.  A ``control``
(``benchmark/controls/<name>.py``) puts a lower precision in the
program's place for one part: with ``speech_probs(model, audio, device)``
its speech probabilities stand for the program's; with ``products()``
the reference Whisper run under it stands for the program's decoder, read
at each position of the same prompts and served tokens (the token it puts
first, and its average log-probability of the served ones).

Beside the numbers, ``vad_by_recording`` gives each sampled recording's
probability gap to the reference (its 99.9th percentile and its widest),
and to the reference in TF32, so that a run whose gap is wide shows which
recording it was and whether the program's probabilities were TF32's.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from reference import pyannet_ref, tokens_ref, whisper_ref

from . import weights as weights_mod

NUMBERS = ("vad_prob_gap_p999", "window_mismatch", "token_logit_gap",
           "avg_logprob_gap", "forbidden_tokens", "missing_windows")


def sample(done: List[Dict], rng: np.random.Generator, count: int
           ) -> List[Dict]:
    """``count`` distinct finished recordings, the longest first."""
    distinct: Dict[int, Dict] = {}
    for req in done:
        distinct.setdefault(req["input"], req)
    reqs = sorted(distinct.values(), key=lambda r: -r["seconds"])
    if not reqs:
        return []
    rest = reqs[1:]
    picks = rng.choice(len(rest), size=min(count - 1, len(rest)),
                       replace=False) if rest and count > 1 else []
    return [reqs[0]] + [rest[i] for i in sorted(picks)]


def served_rows(req: Dict) -> List[tuple]:
    """(start, end, (tokens, avg_logprob)) of each window the request
    dispatched, in dispatch order; None where nothing was served."""
    rec = req["record"]
    rows = []
    for i, windows in enumerate(rec["batches"]):
        res = rec["results"].get(i)
        for j, (s, e) in enumerate(windows):
            rows.append((s, e, None if res is None or j >= len(res)
                         else res[j]))
    return rows


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in NUMBERS)


def run_check(cell: Dict, done: List[Dict], audio_of, seed: int,
              device, vad_path: Path, mix: Dict,
              control=None, rows_per_block: int = 4
              ) -> Dict[str, float]:
    """The numbers compared, over a sample of the finished requests.
    ``audio_of(input)`` gives a request's audio (the benchmark's input,
    made again from the seed)."""
    cfg = cell["config"]
    rng = np.random.default_rng([seed, 7])
    picks = sample(done, rng, mix["check"]["recordings"])
    numbers = {k: 0.0 for k in NUMBERS}
    numbers["served_tokens"] = 0
    numbers["recordings_checked"] = len(picks)
    numbers["vad_by_recording"] = []
    if not picks:
        numbers["missing_windows"] = float("inf")
        return numbers
    vad = pyannet_ref.load(str(vad_path), device)
    base, langs = cell["base_vocab"], cell["num_languages"]
    ctx = cfg["max_target_positions"]
    prefix = tokens_ref.prefix(mix["initial_prompt"], mix["language"], base,
                               langs, ctx)
    p = len(prefix)
    max_new = min(mix["max_new_tokens"], ctx - p - 1)
    eot = tokens_ref.specials(base, langs)["eot"]
    masks = {first: torch.from_numpy(tokens_ref.allowed(
        cfg["vocab_size"], base, first)).to(device) for first in (True, False)}
    window_samples = cfg["max_source_positions"] * 2 * 160
    chunk_s = window_samples / 16000.0
    w = weights_mod.make_whisper(cfg, cell["weight_seed"], device,
                                 cell["weight_dtype"])
    lower_probs = getattr(control, "speech_probs", None)
    lower_products = getattr(control, "products", None)
    todo = []
    for req in picks:
        audio = audio_of(req["input"])
        rec = req["record"]
        ref_p, frame = pyannet_ref.speech_probs(vad, audio, device)
        if lower_probs is not None:
            rec = dict(rec, probs=lower_probs(vad, audio, device).astype(
                np.float32))
        prog_p = rec["probs"]
        if prog_p is None or len(prog_p) != len(ref_p):
            gap = widest = gap_tf32 = float("inf")
        else:
            diff = np.abs(prog_p.astype(np.float64) - ref_p)
            gap, widest = float(np.quantile(diff, 0.999)), float(diff.max())
            gap_tf32 = float(np.quantile(np.abs(
                prog_p.astype(np.float64) - pyannet_ref.speech_probs(
                    vad, audio, device, tf32=True)[0]), 0.999))
        numbers["vad_prob_gap_p999"] = max(numbers["vad_prob_gap_p999"], gap)
        numbers["vad_by_recording"].append(
            {"input": req["input"], "seconds": req["seconds"],
             "traced": req["traced"], "gap": gap, "widest": widest,
             "gap_to_tf32_reference": gap_tf32})
        rows = served_rows(req)
        got = [(s, e) for s, e, _ in rows]
        if prog_p is not None:
            want = pyannet_ref.windows_of(prog_p, rec["frame"],
                                          len(audio) / 16000.0, chunk_s)
            numbers["window_mismatch"] += sum(
                1 for a, b in zip(got, want)
                if abs(a[0] - b[0]) > 1e-9 or abs(a[1] - b[1]) > 1e-9
            ) + abs(len(got) - len(want))
        for s, e, served in rows:
            if served is None:
                numbers["missing_windows"] += 1
                continue
            toks, avg_lp = served
            seq = list(toks) + ([eot] if len(toks) < max_new else [])
            todo.append((pyannet_ref.pad_window(audio, s, e, window_samples),
                         prefix + seq, avg_lp, len(toks) + 1))
    for lo in range(0, len(todo), rows_per_block):
        block = todo[lo:lo + rows_per_block]
        wins = torch.from_numpy(np.stack([b[0] for b in block])).to(device)
        seqs = [b[1] for b in block]
        logits = whisper_ref.window_logits(w, cfg, wins, seqs, p - 1)
        lower = [None] * len(block)
        if lower_products is not None:
            with lower_products():
                lower = whisper_ref.window_logits(w, cfg, wins, seqs, p - 1)
        for (_, seq, avg_lp, denom), lg, lg8 in zip(block, logits, lower):
            served = torch.tensor(seq[p:], device=device)
            allowed = masks[False].expand(len(served), -1).clone()
            allowed[0] = masks[True]
            masked = lg.masked_fill(~allowed, float("-inf"))
            best = masked.amax(dim=-1)
            ok = allowed.gather(1, served[:, None])[:, 0]
            ref_lp = masked.log_softmax(dim=-1).gather(
                1, served[:, None])[:, 0].double().sum() / denom
            picked = served
            if lg8 is not None:
                # the control in the program's place: its first token
                # at each position, its log-probability of the served
                # ones
                m8 = lg8.masked_fill(~allowed, float("-inf"))
                picked = m8.argmax(dim=-1)
                avg_lp = float(m8.log_softmax(dim=-1).gather(
                    1, served[:, None])[:, 0].double().sum() / denom)
            chosen = lg.gather(1, picked[:, None])[:, 0]
            numbers["avg_logprob_gap"] = max(numbers["avg_logprob_gap"],
                                             abs(float(ref_lp) - avg_lp))
            numbers["forbidden_tokens"] += int((~ok).sum())
            gap = (best - chosen)[ok]
            if len(gap):
                numbers["token_logit_gap"] = max(numbers["token_logit_gap"],
                                                 float(gap.max()))
            numbers["served_tokens"] += len(served)
        del logits
    del w
    return numbers


def load_limits(root: Path, cell_name: str) -> Dict[str, float]:
    import json
    path = root / "benchmark" / "limits" / f"{cell_name}.json"
    return json.loads(path.read_text())["limits"]


def report_lines(numbers: Dict[str, float], limits: Dict[str, float]
                 ) -> List[str]:
    lines = []
    for k in NUMBERS:
        lines.append(f"check {k} = {numbers[k]!r} (limit {limits[k]!r})")
    lines.append(f"check served_tokens = {numbers['served_tokens']} over "
                 f"{numbers['recordings_checked']} recordings")
    return lines


def vad_lines(numbers: Dict) -> List[str]:
    return [f"vad recording {r['input']} ({r['seconds']:g} s, traced "
            f"{r['traced']}): gap p99.9 {r['gap']!r}, widest "
            f"{r['widest']!r}, p99.9 to the TF32 reference "
            f"{r['gap_to_tf32_reference']!r}"
            for r in numbers["vad_by_recording"]]


def as_key(numbers: Dict[str, float], limits: Dict[str, float]
           ) -> Dict[str, Optional[Dict]]:
    out = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    out["served_tokens"] = {"value": numbers["served_tokens"]}
    return out
