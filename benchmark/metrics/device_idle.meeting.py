"""The device: the share of the traced window in which no operation ran on
the card (1 - the union of device intervals over the window), in
percent."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
