"""``pipeline/chunking.py`` and ``pipeline/transcribe.py``: the host's
preparation of the windows before the encoder, per real window, over the
window's requests: the program's spans ``chunks.batch`` (windows cut and
padded), ``encode.prep`` (float to int16) and ``encode.upload`` (the copy
to the card and back to float).  None where the program keeps no spans
(``last_stats["spans"]``)."""

PHASES = ("chunks.batch", "encode.prep", "encode.upload")


def read(run):
    stats = [r["record"]["stats"] for r in run.done
             if "spans" in r["record"].get("stats", {})]
    windows = sum(s["windows"] for s in stats)
    if not windows:
        return None
    prep_s = sum(role.get(name, (0.0,))[0] for s in stats
                 for role in s["spans"].values() for name in PHASES)
    return 1e3 * prep_s / windows
