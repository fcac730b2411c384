"""The benchmark harness of ``manual_whisper_tpu_torch``: finds a cell of
``BENCHMARK.json`` by name, makes its inputs from the seed, drives the
program, reduces spans, counters and the device trace to metrics, and
judges the program's output against the plain references in
``benchmark/reference``."""
