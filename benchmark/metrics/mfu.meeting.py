"""The whole model step's share of the card's bf16 peak in the traced
requests: the FLOPs that their real windows and served tokens need
(encoder, cross K/V, prefill, decode steps, logits; harness/flops.py)
over the traced window's length x 989 TFLOP/s, in percent."""

from harness import flops


def read(run):
    if run.trace is None:
        return None
    served = []
    for r in run.requests(traced_only=True):
        rec = r["record"]
        for i, windows in enumerate(rec["batches"]):
            toks = rec["results"].get(i, [])
            max_new = min(run.mix["max_new_tokens"],
                          run.cfg["max_target_positions"] - run.prefix_len - 1)
            served += [len(t) + (len(t) < max_new) for t, _ in toks]
    if not served:
        return None
    work = flops.model_flops(run.cfg, run.prefix_len, served)
    return 100.0 * work / (run.trace["window_s"] * flops.BF16_FLOPS)
