"""``models/decode.py`` and ``models/graphs.py``: the program's own
``decode.loop`` span (``BatchDecoder.decode_submit``: cross K/V, prefill,
the replayed chunks and their finish checks, the result copies) on the
dispatch thread, per token row (rows of the batch x positions the loop
ran), over the window's requests.  None where the program keeps no spans
(``last_stats["spans"]``).

It assumes one rung, as the meeting mix runs: ``token_rows`` counts the
rows of every loop, retries too, while a retry on the fetch worker is
not in the dispatch thread's span, so with retries it would read low."""


def read(run):
    stats = [r["record"]["stats"] for r in run.done
             if "spans" in r["record"].get("stats", {})]
    rows = sum(s["token_rows"] for s in stats)
    if not rows:
        return None
    loop_s = sum(s["spans"].get("dispatch", {}).get("decode.loop", (0.0,))[0]
                 for s in stats)
    return 1e3 * loop_s / rows
