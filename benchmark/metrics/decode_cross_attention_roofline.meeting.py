"""``csrc/decode_attention.cu``'s cross-attention split (K4) in the traced
requests: the least time its launches could take (harness/flops.py: K and
V of rows x 1500 positions x 1280 read once per decode step and layer)
over its device time in the trace, in percent.  K4 is the split kernel
that pulls its partial results (template flag ``false``); K3, the
self-attention, pushes them (``true``)."""

from harness import flops, trace


def _is_k4(name):
    return "split_kernel" in name and "false>" in name


def read(run):
    if run.trace is None:
        return None
    cfg = run.cfg
    heads = cfg["decoder_attention_heads"]
    dh = cfg["d_model"] // heads
    bound = sum(
        (s[4]["steps"] - 1) * cfg["decoder_layers"]
        * flops.cross_attention_bound_s(s[4]["rows"], heads,
                                        cfg["max_source_positions"], dh)
        for s in run.spans("decode", traced_only=True))
    secs, launches = trace.kernel_seconds(run.trace, _is_k4)
    if not launches or not bound:
        return None
    return 100.0 * bound / secs
