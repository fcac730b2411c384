"""The ``recordings`` kind of traffic mix: a closed loop of whole
recordings, one after another through ``TranscribePipeline.transcribe``.

Mix parameters: ``lengths_s``, the set of recording lengths, each made
once in set-up from the seed (``speech``: the synthetic speech's
parameters) and taken in the seed's order, starting over when the set is
done; ``warmup_s``, the length of the warm-up recording.  Every seed gets
the same lengths in its own order, and its own speech, so that seeds
change what is said and not how much.  The window ends when the last
recording started before ``--seconds`` completes.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from harness import loop


def inputs(mix: Dict, seed: int, seconds: float) -> List[Dict]:
    """The recordings made in set-up: input id, length, content seed."""
    lengths = mix["lengths_s"]
    order = np.random.default_rng([seed, 1]).permutation(len(lengths))
    return [{"input": i, "seconds": float(lengths[k]),
             "seed": int(np.random.default_rng([seed, 2, i]).integers(2**31))}
            for i, k in enumerate(order)]


def window(ctx: "loop.Context") -> Dict:
    """Set-up of the inputs, the warm-up, then the measured window."""
    recs = inputs(ctx.mix, ctx.seed, ctx.seconds)
    audio = {r["input"]: ctx.speech(r["seconds"], r["seed"]) for r in recs}
    ctx.warm_up()
    return ctx.measure(lambda tracer: loop.closed_loop(
        ctx.program.transcribe, recs, audio.__getitem__, ctx.seconds,
        ctx.taps, tracer, ctx.mix["trace"]["requests"]),
        audio_of=audio.__getitem__)
