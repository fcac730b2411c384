"""``csrc/decode_attention.cu``'s cross-attention over int8 K/V (K5, every
replayed decode step's cross-attention with int8 cross K/V) in the traced
requests: the least time its launches could take over its device time in
the trace, in percent (``harness/kernel_shapes.py``).

The launches and their shapes are the program's own count
(``last_stats["kernel_shapes"]``, the ``decode_cross_attention_int8``
rows: (rows, heads, cross positions, head dim, scale dtype) and launches,
replays included).  A launch's bound is the larger of 4 b h n dh
operations at the float32 rate (the kernel's softmax and sums) and its
bytes at the HBM rate: the int8 codes of K and V 2 b h n dh, their scales
2 b h n x the scale's bytes, q read and the bf16 output written 4 b h dh
(harness/flops.py's peaks).  The device time is that of
``cross_int8_kernel``.  None without a trace, or where the program keeps
no such count."""

from harness import flops, kernel_shapes

SCALE_BYTES = {"float32": 4, "bfloat16": 2}


def launch_bound_s(b, h, n, dh, scale):
    return flops.bound_s(4.0 * b * h * n * dh,
                         2.0 * b * h * n * dh
                         + 2.0 * b * h * n * SCALE_BYTES[scale]
                         + 4.0 * b * h * dh, flops.F32_FLOPS)


def read(run):
    return kernel_shapes.roofline(run, "decode_cross_attention_int8",
                                  launch_bound_s)
