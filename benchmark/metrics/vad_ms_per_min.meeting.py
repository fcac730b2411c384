"""``models/vad.py``: the VAD's time (PyanNet blocks, binarization and
merging: ``last_stats["vad_s"]``, on the calling thread's clock) per
minute of audio, over the recordings of the window."""


def read(run):
    reqs = [r for r in run.done if "stats" in r["record"]]
    if not reqs:
        return None
    vad_s = sum(r["record"]["stats"]["vad_s"] for r in reqs)
    return 1e3 * vad_s / (sum(r["seconds"] for r in reqs) / 60.0)
