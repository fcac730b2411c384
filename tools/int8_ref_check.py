"""The int8 cell's served tokens against the int8 model itself: one
benchmark run of an int8 cell, whose output check is made twice, first
as the benchmark makes it (the float32 reference over the unquantized
weights, ``benchmark/reference/whisper_ref.py``), then with the int8
model (``benchmark/reference/int8_ref.py``: int8 block weights and int8
cross K/V, in float32) in the reference's place.

    python3 tools/int8_ref_check.py --workload v3int8.meeting \\
        --seed <n> --seconds 45 --trace 1

Run from the root of a checkout, on the card.  The run is the
benchmark's own (``benchmark/harness/main.py``, unchanged): the same
program, window, sample of recordings and numbers; only the second
check's reference differs, teacher-forced over the same served windows in
blocks of 4 rows.  Before the result line it prints one JSON line
``{"int8_ref_check": {...}}``: the second check's numbers beside the
first's and their limits, and with ``--trace 1`` the traced request's K5
and K6 launches in the device trace beside the program's own count of
them (``last_stats["kernel_shapes"]``).
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

from harness import check, kernel_shapes, main, trace  # noqa: E402
from reference import int8_ref, whisper_ref  # noqa: E402


class Int8Reference:
    """``whisper_ref`` as ``harness.check`` uses it, with the int8 model's
    logits: the weights it is given rounded as the program's int8 serves
    them (once per set of weights)."""

    def __init__(self):
        self._w = None
        self._wq = None

    def __getattr__(self, name):
        return getattr(whisper_ref, name)

    def window_logits(self, w, cfg, windows, sequences, first):
        if self._w is not w:
            self._w, self._wq = w, int8_ref.dequantize_params(w)
        return int8_ref.window_logits(self._wq, cfg, windows, sequences,
                                      first)


def traced_launches(result, done) -> dict:
    """K5's and K6's launches in the trace and in the traced requests'
    counts."""
    counted = dict.fromkeys(kernel_shapes.TRACE_NAMES, 0)
    for req in done:
        if req["traced"]:
            for name, _, n in req["record"]["stats"]["kernel_shapes"]:
                counted[name] = counted.get(name, 0) + n
    out = {}
    for name, pattern in kernel_shapes.TRACE_NAMES.items():
        secs, n = trace.kernel_seconds(result, pattern.search)
        out[name] = {"trace": n, "counted": counted[name],
                     "device_s": secs}
    return out


def run(argv, root: Path = ROOT, device_name=None) -> int:
    """One benchmark run (``harness.main.main``'s arguments) with the
    second check; ``device_name`` "cpu" rehearses it on the CPU."""
    finished = {}
    finish = trace.DeviceTrace.finish

    def keep(self):
        finished["result"] = finish(self)
        return finished["result"]

    run_check = check.run_check

    def both(cell, done, *a, control=None, **kw):
        numbers = run_check(cell, done, *a, control=control, **kw)
        if control is None:
            check.whisper_ref = Int8Reference()
            try:
                int8 = run_check(cell, done, *a, control=None, **kw)
            finally:
                check.whisper_ref = whisper_ref
            limits = check.load_limits(root, cell["name"])
            line = {"workload": cell["name"], "limits": limits,
                    "float32_reference": {k: numbers[k]
                                          for k in check.NUMBERS},
                    "int8_reference": {k: int8[k] for k in check.NUMBERS},
                    "served_tokens": int8["served_tokens"],
                    "recordings_checked": int8["recordings_checked"]}
            if "result" in finished:
                line["launches"] = traced_launches(finished["result"], done)
            print(json.dumps({"int8_ref_check": line}), flush=True)
        return numbers

    trace.DeviceTrace.finish = keep
    check.run_check = both
    try:
        return main.main(argv, device_name=device_name, root=root)
    finally:
        trace.DeviceTrace.finish = finish
        check.run_check = run_check


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(run(sys.argv[1:]))
