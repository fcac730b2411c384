"""``csrc/flash_attention.cu`` (K2, encoder self-attention) in the traced
requests: the least time its launches could take (harness/flops.py, one
launch a layer of each encode at its rows) over its device time in the
trace, in percent."""

from harness import flops, trace


def read(run):
    if run.trace is None:
        return None
    cfg = run.cfg
    heads = cfg["encoder_attention_heads"]
    dh = cfg["d_model"] // heads
    bound = sum(cfg["encoder_layers"] * flops.flash_attention_bound_s(
        s[4]["rows"], heads, cfg["max_source_positions"], dh)
        for s in run.spans("encode", traced_only=True))
    secs, launches = trace.kernel_seconds(
        run.trace, lambda n: "flash_kernel" in n and "f32" not in n)
    if not launches or not bound:
        return None
    return 100.0 * bound / secs
