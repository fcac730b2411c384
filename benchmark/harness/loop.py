"""What a mix kind (``benchmark/kinds/<kind>.py``) is given to build its
inputs, warm up and run its window, and the closed loop that the
``recordings`` kind drives.

A kind's ``window(ctx)`` returns the window's record: ``done`` (each
finished request: its input id, ``seconds``, ``start``, ``end``, the
taps' ``record`` and whether it was ``traced``), ``failed``,
``attempted``, ``t0``, ``t1``, and from ``ctx.measure`` the set-up time,
the graph captures and kernel builds inside the window, the tracer, and
``audio_of`` (a request's audio, for the output check).
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Dict, List

import numpy as np


def derived_seed(seed: int, *tag: int) -> int:
    return int(np.random.default_rng([seed, *tag]).integers(2**62))


class Context:
    def __init__(self, program, mix: Dict, seed: int, seconds: float,
                 device, on_card: bool, trace: bool, taps, t_start: float):
        self.program, self.mix, self.seed = program, mix, seed
        self.seconds, self.device, self.on_card = seconds, device, on_card
        self.trace, self.taps, self.t_start = trace, taps, t_start

    def speech(self, seconds: float, seed: int):
        """Synthetic speech of the mix's ``speech`` parameters, rendered
        on the device."""
        from . import audio
        return audio.synthetic_speech(seconds, seed, self.device,
                                      self.mix["speech"])

    def warm_up(self) -> None:
        """Every decode bucket the mix reaches captured, then one whole
        transcription of ``warmup_s`` seconds."""
        self.program.warmup()
        self.program.transcribe(self.speech(
            self.mix["warmup_s"], derived_seed(self.seed, 5)))

    def measure(self, run: Callable, **extra) -> Dict:
        """Set-up ends here; ``run(tracer)`` is the measured window."""
        tracer = None
        if self.trace and self.on_card:
            from . import trace as trace_mod
            trace_mod.warm_up()
            tracer = trace_mod.DeviceTrace()
        setup_s = time.perf_counter() - self.t_start
        taps = self.taps
        taps.clear()
        taps.annotate = tracer is not None
        captures0, builds0 = taps.captures, taps.builds()
        window = run(tracer)
        window["captures"] = taps.captures - captures0
        window["builds"] = taps.builds() - builds0
        taps.annotate = False
        window.update(setup_s=setup_s, tracer=tracer, **extra)
        return window


def closed_loop(call: Callable, reqs: List[Dict], audio_of: Callable,
                seconds: float, taps, tracer, n_trace: int) -> Dict:
    """``call(audio)`` on the requests in turn, starting over when they
    are done, until ``seconds`` have passed; the window ends when the
    last request started before then completes.  With a tracer, the
    first ``n_trace`` requests are traced."""
    n_trace = n_trace if tracer else 0
    done, failed, attempted = [], 0, 0
    if n_trace:
        tracer.start()
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds:
        req = reqs[k % len(reqs)]
        k += 1
        attempted += 1
        start = time.perf_counter()
        n_before = len(taps.requests)
        try:
            call(audio_of(req["input"]))
        except Exception as exc:           # counted, and the loop goes on
            print(f"request failed: {exc!r}", file=sys.stderr)
            failed += 1
            continue
        end = time.perf_counter()
        done.append({**req, "start": start, "end": end,
                     "record": taps.requests[n_before],
                     "traced": attempted <= n_trace})
        if n_trace and attempted == n_trace:
            tracer.stop()
    if tracer and tracer.active:
        tracer.stop()
    return {"done": done, "failed": failed, "attempted": attempted,
            "t0": t0, "t1": time.perf_counter()}
