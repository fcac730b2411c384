"""The program's own count of K5's and K6's launches by shape
(``last_stats["kernel_shapes"]``: ``[kernel, [dims], launches]`` rows,
replays included), and a kernel's share of its roofline over the traced
requests: the least time of its counted launches over the device time of
its kernels in the trace.  The bounds of a launch are the readers'
(``benchmark/metrics/*int8*roofline*``)."""

from __future__ import annotations

import re
from typing import Callable, Optional, Tuple

from . import trace

# the device trace's kernels of each counted kernel (its demangled names)
TRACE_NAMES = {
    "int8_matmul": re.compile(r"(?:^|[\s:])(?:matvec_kernel|tile_kernel)<"),
    "decode_cross_attention_int8":
        re.compile(r"(?:^|[\s:])cross_int8_kernel<"),
}


def counted(run, kernel: str, launch_bound_s: Callable[..., float]
            ) -> Optional[Tuple[int, float]]:
    """(launches, least seconds) of ``kernel`` in the traced requests'
    counts, or None where a request has no count."""
    launches, bound = 0, 0.0
    for r in run.requests(traced_only=True):
        rows = r["record"].get("stats", {}).get("kernel_shapes")
        if rows is None:
            return None
        for name, shape, n in rows:
            if name == kernel:
                launches += n
                bound += n * launch_bound_s(*shape)
    return launches, bound


def roofline(run, kernel: str, launch_bound_s: Callable[..., float]
             ) -> Optional[float]:
    """``kernel``'s share of its roofline in the traced requests, in
    percent; None without a trace, a count, or a launch."""
    if run.trace is None:
        return None
    found = counted(run, kernel, launch_bound_s)
    secs, _ = trace.kernel_seconds(run.trace, TRACE_NAMES[kernel].search)
    if found is None or not found[0] or not secs:
        return None
    return 100.0 * found[1] / secs
