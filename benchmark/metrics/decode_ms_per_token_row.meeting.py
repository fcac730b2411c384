"""``models/decode.py`` and ``models/graphs.py``: the benchmark's own span
around each ``BatchDecoder.decode_submit`` (cross K/V, prefill, and the
replayed chunks up to the loop's last finish check, which waits for the
card) per token row (rows of the batch x positions the loop ran), over
the window."""


def read(run):
    spans = run.spans("decode")
    rows = sum(s[4]["rows"] * s[4]["steps"] for s in spans)
    if not rows:
        return None
    return 1e3 * sum(s[3] - s[2] for s in spans) / rows
