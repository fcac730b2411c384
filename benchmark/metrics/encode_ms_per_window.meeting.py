"""``ops/mel.py`` (K1) and the encoder of ``models/whisper.py`` (K2 and its
products): ``last_stats["encode_s"]`` (each batch's encode up to an event
after it) per real window, over the recordings of the window."""


def read(run):
    reqs = [r for r in run.done if "stats" in r["record"]]
    windows = sum(r["record"]["stats"]["windows"] for r in reqs)
    if not windows:
        return None
    return 1e3 * sum(r["record"]["stats"]["encode_s"] for r in reqs) / windows
