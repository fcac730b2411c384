"""``csrc/int8_matmul.cu`` (K6, every int8 block matmul: the matvec at
M <= 8, the tile product above) in the traced requests: the least time
its launches could take over its device time in the trace, in percent
(``harness/kernel_shapes.py``).

The launches and their shapes are the program's own count
(``last_stats["kernel_shapes"]``, the ``int8_matmul`` rows: (M, K, N) and
launches, replays included).  A launch's bound is the larger of 2 M K N
operations at the bf16 tensor-core rate and its bytes at the HBM rate:
the int8 codes K N, the float32 scales 4 N, x 2 M K and the bf16 output
2 M N, each read or written once (harness/flops.py's peaks).  The device
time is that of ``matvec_kernel`` and ``tile_kernel``.  None without a
trace, or where the program keeps no such count."""

from harness import flops, kernel_shapes


def launch_bound_s(m, k, n):
    return flops.bound_s(2.0 * m * k * n,
                         k * n + 4.0 * n + 2.0 * m * k + 2.0 * m * n,
                         flops.BF16_FLOPS)


def read(run):
    return kernel_shapes.roofline(run, "int8_matmul", launch_bound_s)
