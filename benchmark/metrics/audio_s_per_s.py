"""Audio seconds of the recordings completed in the window, over the
window's length (host clock): the rate at which meetings get transcribed."""


def read(run):
    if not run.done:
        return None
    return sum(r["seconds"] for r in run.done) / run.window_s
