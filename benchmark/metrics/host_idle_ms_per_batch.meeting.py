"""The host phases of ``pipeline/transcribe.py`` and ``models/decode.py``
that leave the card idle: the idle gaps of 0.1 ms and more in the traced
window whose innermost covering host span is one of the program's
(``manual_whisper_tpu_torch.spans.SPANS``, the root
``pipeline.transcribe`` left out), in ms per batch of the traced
requests.  None without a trace, or where the program has no spans.

The reading is the traced run's, and the tracer inflates it: under the
profiler each ``cudaGraphLaunch`` of a replayed chunk takes tens of ms of
host time (a fraction of a ms untraced), and the card idles meanwhile,
so most of it is labelled ``decode.replay``.  Compare it between runs
that are traced alike; the untraced spans in ``last_stats["spans"]`` say
what an untraced run's host phases take."""

ROOT = "pipeline.transcribe"


def read(run):
    if run.trace is None:
        return None
    try:
        from manual_whisper_tpu_torch.spans import SPANS
    except ImportError:
        return None
    stats = [r["record"]["stats"] for r in run.requests(traced_only=True)
             if "stats" in r["record"]]
    batches = sum(s["batches"] for s in stats)
    if not batches:
        return None
    idle = run.trace["idle_by_label"]
    idle_s = sum(idle.get(f"host:{name}", 0.0) for name, _ in SPANS
                 if name != ROOT)
    return 1e3 * idle_s / batches
