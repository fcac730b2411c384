"""``models/decode.py`` ladder and segment assembly: the host's own work
in the program's ``finalize.batch`` span (a batch's ladder and its
segments), on whichever thread ran it (the fetch worker, or the calling
thread on the serial path), per real window, over the window's requests.
The ``finalize.wait`` spans inside it are taken off: there the thread
waits for the card to finish the loop whose results it reads, which is
the decode's time, not the ladder's.  A retry rung's decode loop stays
in.  None where the program keeps no spans (``last_stats["spans"]``)."""


def _seconds(stats, name):
    return sum(role.get(name, (0.0,))[0] for role in stats["spans"].values())


def read(run):
    stats = [r["record"]["stats"] for r in run.done
             if "spans" in r["record"].get("stats", {})]
    windows = sum(s["windows"] for s in stats)
    if not windows:
        return None
    own_s = sum(_seconds(s, "finalize.batch") - _seconds(s, "finalize.wait")
                for s in stats)
    return 1e3 * own_s / windows
