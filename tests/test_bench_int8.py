"""The int8 configuration of the benchmark on the CPU, at a small size:
the int8 model's plain reference (``benchmark/reference/int8_ref.py``)
against the port's int8 model, the reference's isolation, the int4
control, and the two readers of the int8 kernels' rooflines.

The port's int8 model is int8 block weights (``ops.quant``) with int8
cross K/V (``precompute_cross_kv(..., quantize=True)``): its encoder
states, prefill logits and three cached decode steps are held to the
reference's full teacher-forced forward, at float32 and at bf16
activations; the same comparison must fail when the port's weights are
rounded to int4.

    python -m pytest tests/test_bench_int8.py -q
"""

import collections
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness import audio as audio_mod  # noqa: E402
from harness import cell as cell_mod  # noqa: E402
from harness import flops, kernel_shapes, weights  # noqa: E402
from harness.main import whisper_config  # noqa: E402
from reference import int8_ref, tokens_ref, whisper_ref  # noqa: E402

from manual_whisper_tpu_torch import spans  # noqa: E402
from manual_whisper_tpu_torch.models.whisper import (  # noqa: E402
    StepLengths, decode_step, decoder_forward, encode, init_kv_cache,
    precompute_cross_kv, quantize_cross_kv)
from manual_whisper_tpu_torch.ops.quant import (  # noqa: E402
    quantize_params, quantize_weight)

TINY = {"name": "tiny.int8", "d_model": 64, "encoder_layers": 2,
        "decoder_layers": 2, "encoder_attention_heads": 2,
        "decoder_attention_heads": 2, "encoder_ffn_dim": 256,
        "decoder_ffn_dim": 256, "num_mel_bins": 80, "vocab_size": 2000,
        "max_source_positions": 150, "max_target_positions": 64,
        "num_languages": 100, "compute_type": "int8"}
PROMPT = "中文会议讨论记录，保持原意与术语准确。"
STEPS = 3
ROWS = 2

# Tolerances of the port's int8 model against int8_ref, by the port's
# activation type: (encoder states, logits), max abs.
# - float32: the same roundings of the same weights and cross K/V, so only
#   the order of the sums differs (seen: states 2e-6, logits 2e-5, the
#   latter where a cross-K/V code lies at a half and the two orders round
#   it to either side: one code step of one position);
# - bfloat16: the port rounds every activation to bf16 (2^-9 relative) and
#   sums in its own order (seen: states 0.031, about 4 ulps of states up to
#   4; logits 0.0044).
# Rounding the weights to int4 instead reads states 0.57-0.64 and logits
# 0.14-0.20 (seeds 1-3, either activation type), over every limit here.
TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (0.1, 0.02)}
SEEDS = (1, 2)


def _int4(w):
    """A port weight [K, N] as symmetric per-output-channel int4 codes in
    the port's ``{q, s}`` form (scale absmax / 7)."""
    w32 = w.float()
    s = torch.clamp_min(w32.abs().amax(dim=0) / 7.0, 1e-10)
    return {"q": torch.clamp(torch.round(w32 / s), -7, 7).to(torch.int8),
            "s": s}


def _int4_params(w):
    def block(blk):
        return {name: ({k: (_int4(v) if k in int8_ref.BLOCK_WEIGHTS else v)
                        for k, v in sub.items()}
                       if isinstance(sub, dict) else sub)
                for name, sub in blk.items()}
    return {part: {**w[part], "blocks": [block(b) for b in w[part]["blocks"]]}
            for part in ("encoder", "decoder")}


def _inputs(seed):
    samples = TINY["max_source_positions"] * 2 * 160
    audio = audio_mod.synthetic_speech(ROWS * samples / 16000, seed, "cpu")
    win = torch.from_numpy(audio.reshape(ROWS, samples).copy())
    mel = whisper_ref.log_mel(whisper_ref.pcm16(win), TINY["num_mel_bins"])
    prefix = tokens_ref.prefix(PROMPT, "zh", 256, 100,
                               TINY["max_target_positions"])
    served = np.random.default_rng([seed, 3]).integers(0, 256, STEPS)
    return mel, prefix, prefix + [int(t) for t in served]


def _reference(w, mel, seq, p):
    """int8_ref: encoder states and the teacher-forced logits of positions
    p - 1 .. p + STEPS - 1 (the prefill's last and each step's)."""
    wq = int8_ref.dequantize_params(w)
    with whisper_ref.no_tf32():
        xa = whisper_ref.encoder(wq, mel, TINY["encoder_attention_heads"])
        toks = torch.tensor([seq] * ROWS)
        logits = int8_ref.decoder_logits(
            wq, toks, xa, TINY["decoder_attention_heads"], p - 1)
    return xa, logits


def _port(params, dtype, mel, seq, p):
    """The port: encoder, int8 cross K/V, prefill through the self cache,
    then STEPS cached decode steps fed the sequence's tokens."""
    cfg = whisper_config(TINY, dtype)
    xa = encode(params, mel, cfg)
    cross = precompute_cross_kv(params, xa, cfg, quantize=True)
    cache = init_kv_cache(cfg, ROWS, p + STEPS, torch.device("cpu"))
    prefill, _ = decoder_forward(params, torch.tensor([seq[:p]] * ROWS),
                                 None, cfg, kv_cache=cache, cross_kv=cross)
    out = [prefill[:, -1]]
    emb = params["decoder"]["tok_emb"].float()
    cross_len = torch.tensor([TINY["max_source_positions"]],
                             dtype=torch.int32)
    for j in range(STEPS):
        lengths = StepLengths(torch.tensor([p + j], dtype=torch.int32),
                              cross_len)
        out.append(decode_step(params, torch.tensor([seq[p + j]] * ROWS),
                               lengths, cache, cross, cfg, emb))
    return xa.float(), torch.stack(out, 1).float()


def _gaps(seed, dtype, quantize):
    w = weights.make_whisper(TINY, seed, "cpu", dtype)
    mel, prefix, seq = _inputs(seed)
    p = len(prefix)
    xa_ref, ref = _reference(w, mel, seq, p)
    xa, port = _port(quantize(w), dtype, mel, seq, p)
    return (float((xa - xa_ref).abs().max()),
            [float((port[:, j] - ref[:, j]).abs().max())
             for j in range(STEPS + 1)])


# -- the reference's roundings against the port's -----------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 64), (64, 256), (256, 64)])
def test_quantizer_matches_port(shape, dtype):
    """int8_ref's per-output-channel quantizer gives the port's codes and
    scales bit for bit, also at values planted on half code steps."""
    gen = torch.Generator().manual_seed(shape[0] + shape[1])
    w = (torch.randn(shape, generator=gen) / shape[0] ** 0.5).to(dtype)
    w[0, :4] = torch.tensor([0.5, -0.5, 1.5, -2.5]).to(dtype) * (
        w[:, :4].float().abs().amax(0) / 127.0).to(dtype)
    ref, port = int8_ref.quantize_weight(w), quantize_weight(w)
    assert torch.equal(ref["q"], port["q"])
    assert torch.equal(ref["s"], port["s"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_kv_rounding_matches_port(dtype):
    """int8_ref's rounding of cross K/V per (row, head, position) equals
    the port's codes times its float32 scales."""
    gen = torch.Generator().manual_seed(7)
    k, v = (torch.randn((2, 3, 50, 16), generator=gen).to(dtype)
            for _ in range(2))
    k_q, k_s, v_q, v_s = quantize_cross_kv(k, v)
    for x, q, s in ((k, k_q, k_s), (v, v_q, v_s)):
        assert torch.equal(int8_ref.quantize_rows(x.float()),
                           q.float() * s[..., None])


# -- the port's int8 model against the reference -------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_int8_matches_int8_ref(dtype, seed):
    """Encoder states, the prefill's last logits and three cached decode
    steps' logits within TOL of int8_ref's full teacher-forced forward."""
    enc_tol, logit_tol = TOL[dtype]
    enc, logits = _gaps(seed, dtype, quantize_params)
    assert enc < enc_tol
    assert max(logits) < logit_tol, logits


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_weights_fail_the_comparison(dtype, seed):
    """The port's weights rounded to int4, one precision below int8: the
    same comparison reads beyond both tolerances, so they are tight
    enough to see it."""
    enc_tol, logit_tol = TOL[dtype]
    enc, logits = _gaps(seed, dtype, _int4_params)
    assert enc > 2 * enc_tol
    assert max(logits) > 2 * logit_tol, logits


def test_dequantized_weights_leave_the_rest_alone():
    """Only the block weights change; embeddings, convolutions, norms and
    biases are the very tensors given."""
    w = weights.make_whisper(TINY, 5, "cpu", torch.bfloat16)
    wq = int8_ref.dequantize_params(w)
    blk, blk_q = w["decoder"]["blocks"][1], wq["decoder"]["blocks"][1]
    assert blk_q["mlp"]["fc1_b"] is blk["mlp"]["fc1_b"]
    assert blk_q["lnx"]["g"] is blk["lnx"]["g"]
    assert wq["decoder"]["tok_emb"] is w["decoder"]["tok_emb"]
    assert wq["encoder"]["conv2_w"] is w["encoder"]["conv2_w"]
    assert blk_q["xattn"]["k_w"].dtype == torch.float32
    assert not torch.equal(blk_q["xattn"]["k_w"], blk["xattn"]["k_w"].float())


def test_int8_ref_loads_neither_port_nor_jax():
    code = ("import sys; sys.path[:0] = [%r]\n"
            "from reference import int8_ref\n"
            "bad = {m.split('.')[0] for m in sys.modules} & {'jax', "
            "'jaxlib', 'flax', 'manual_whisper_tpu', "
            "'manual_whisper_tpu_torch'}\n"
            "print('LOADED', sorted(bad))\n" % str(BENCH))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert "LOADED []" in proc.stdout, proc.stderr[-2000:]


# -- the int4 control ------------------------------------------------------

def test_int4_control_rounds_block_weights_only():
    control = cell_mod.control(ROOT, "int4")
    gen = torch.Generator().manual_seed(3)
    with control.products():
        for shape in ((64, 64), (64, 256), (256, 64)):
            w = torch.randn(shape, generator=gen)
            got = whisper_ref._q(w)
            s = w.abs().amax(dim=0) / 7.0
            assert torch.equal(got, torch.clamp(torch.round(w / s), -7, 7)
                               * s)
            assert (got / s).round().abs().max() <= 7
        for shape in ((1, 10, 64), (2, 150, 64), (64, 2000)):
            x = torch.randn(shape, generator=gen)
            assert whisper_ref._q(x) is x
    assert whisper_ref._ROUND[0] is None


# -- the readers of the int8 kernels' rooflines ------------------------------

class FakeRun:
    """One traced request: its program counts and a trace."""

    def __init__(self, shapes, device_s, traced=True):
        self._reqs = [{"traced": traced,
                       "record": {"stats": {"kernel_shapes": shapes}}},
                      {"traced": False,
                       "record": {"stats": {"kernel_shapes": shapes * 3}}}]
        self.trace = {"device_s_by_name": device_s,
                      "launches_by_name": {k: 1 for k in device_s}}

    def requests(self, traced_only=False):
        return [r for r in self._reqs if r["traced"] or not traced_only]


def test_int8_matmul_reader_by_hand():
    """Two shapes: 2 launches at M = 16, K = N = 1280 (bytes: 1638400 +
    5120 + 40960 + 40960 = 1725440 B, 5.150567e-7 s; operations 5.24e7,
    5.3e-8 s) and 1 at M = 24000, K = 1280, N = 5120 (operations
    3.1457e11, 3.18068e-4 s; bytes 313774080 B, 9.3664e-5 s), in 0.5 ms
    of K6's two kernels."""
    read = cell_mod.metric_reader(ROOT, "int8_matmul_roofline.meeting")
    shapes = [["int8_matmul", [16, 1280, 1280], 2],
              ["int8_matmul", [24000, 1280, 5120], 1],
              ["decode_cross_attention_int8", [16, 20, 1500, 64, "float32"],
               5]]
    device_s = {"void (anonymous namespace)::matvec_kernel<64, 2, 4>(x)":
                1e-4,
                "void (anonymous namespace)::tile_kernel<Cfg>(CUtensorMap)":
                4e-4,
                "void gemv2T_kernel_val<int>(y)": 9.0,
                "void (anonymous namespace)::cross_int8_kernel<64, float>()":
                7.0}
    assert 2.0 * 24000 * 1280 * 5120 / 989e12 > 313774080 / 3.35e12
    bound = 2 * 1725440 / 3.35e12 + 2.0 * 24000 * 1280 * 5120 / 989e12
    assert read(FakeRun(shapes, device_s)) == pytest.approx(
        100 * bound / 5e-4)
    assert read(FakeRun(shapes, {"void gemv2T_kernel_val<int>(y)": 1.0})) \
        is None


def test_cross_int8_reader_by_hand():
    """K5 at 16 rows, 20 heads, 1500 positions, dh 64: with f32 scales
    61440000 + 3840000 + 81920 = 65361920 B (1.95110e-5 s, over the
    1.834e-6 s of its operations at the float32 rate: bound by bytes),
    with bf16 scales 63441920 B; 3 launches of each in 1 ms."""
    read = cell_mod.metric_reader(
        ROOT, "decode_cross_attention_int8_roofline.meeting")
    shapes = [["decode_cross_attention_int8", [16, 20, 1500, 64, "float32"],
               3],
              ["decode_cross_attention_int8", [16, 20, 1500, 64, "bfloat16"],
               3],
              ["int8_matmul", [16, 1280, 1280], 100]]
    device_s = {"void (anonymous namespace)::cross_int8_kernel<64, float>()":
                6e-4,
                "void (anonymous namespace)::cross_int8_kernel<64, bf16>()":
                4e-4,
                "void (anonymous namespace)::split_kernel<64, C, false>()":
                3.0}
    ops = 4.0 * 16 * 20 * 1500 * 64
    assert flops.bound_s(ops, 65361920, 67e12) == 65361920 / 3.35e12
    assert read(FakeRun(shapes, device_s)) == pytest.approx(
        100 * 3 * (65361920 + 63441920) / 3.35e12 / 1e-3)


# a kernel in a CUDA source: "__global__ void [__launch_bounds__(...)]
# name(", with the line before it (its template head, if any)
_GLOBAL = re.compile(r"^(.*)\n__global__\s+void\s+"
                     r"(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(",
                     re.M)


def test_k6_kernels_match_the_trace_reader():
    """Every ``__global__`` kernel of K6's source is a template whose
    demangled name the roofline reader's pattern finds in a trace
    (``harness/kernel_shapes.py`` ``TRACE_NAMES["int8_matmul"]``): a K6
    kernel under another name would drop out of the reader's device
    time, and ``int8_matmul_roofline`` would read too high."""
    src = (ROOT / "manual_whisper_tpu_torch" / "csrc"
           / "int8_matmul.cu").read_text()
    found = _GLOBAL.findall(src)
    assert len(found) == src.count("__global__") >= 2
    assert {name for _, name in found} >= {"matvec_kernel", "tile_kernel"}
    pattern = kernel_shapes.TRACE_NAMES["int8_matmul"]
    for head, name in found:
        assert head.startswith("template <"), name
        assert pattern.search(f"void (anonymous namespace)::{name}<64>(x)")
        assert pattern.search(f"{name}<64>(x)")
        assert not pattern.search(f"void (anonymous namespace)::x{name}<64>")


def _functions(src: str) -> dict:
    """{name: body} of the functions defined in a C++ source, comments left
    out (a name defined more than once, as an overload or a lambda, keeps
    its bodies together)."""
    src = re.sub(r"//[^\n]*|/\*.*?\*/", "", src, flags=re.S)
    out = {}
    for found in re.finditer(r"\b(\w+)\s*\(", src):
        name = found.group(1)
        if name in ("if", "for", "while", "switch", "return", "sizeof",
                    "constexpr"):
            continue
        depth, i = 1, found.end()
        while depth and i < len(src):         # past the parameter list
            depth += {"(": 1, ")": -1}.get(src[i], 0)
            i += 1
        head = re.match(r"\s*(?:const\s*)?(?:->\s*[\w:<>]+\s*)?\{", src[i:])
        if not head:
            continue
        depth, j = 1, i + head.end()
        while depth and j < len(src):
            depth += {"{": 1, "}": -1}.get(src[j], 0)
            j += 1
        out[name] = out.get(name, "") + src[i + head.end():j]
    return out


def test_k5_kernels_match_the_trace_reader():
    """Every ``__global__`` kernel that K5's entry point
    ``mwx_decode_attention_int8`` reaches, through the functions its body
    calls, is a template whose demangled name the roofline reader's
    pattern finds in a trace (``TRACE_NAMES["decode_cross_attention_int8"]``):
    a second K5 kernel, or K5 under another name, would drop out of the
    reader's device time, and ``decode_cross_attention_int8_roofline``
    would read too high.  K3/K4's ``split_kernel`` is not reached."""
    src = (ROOT / "manual_whisper_tpu_torch" / "csrc"
           / "decode_attention.cu").read_text()
    kernels = {name: head for head, name in _GLOBAL.findall(src)}
    assert len(kernels) == src.count("__global__") >= 2
    bodies = _functions(src)
    reached, todo = set(), ["mwx_decode_attention_int8"]
    while todo:
        name = todo.pop()
        if name in reached or name not in bodies:
            continue
        reached.add(name)
        todo += [other for other in bodies
                 if re.search(rf"\b{other}\b", bodies[name])]
    launched = reached & set(kernels)
    assert launched == {"cross_int8_kernel"}, launched
    pattern = kernel_shapes.TRACE_NAMES["decode_cross_attention_int8"]
    for name in launched:
        assert kernels[name].startswith("template <"), name
        assert pattern.search(f"void (anonymous namespace)::{name}<64, "
                              f"float, Cfg>(x)")
        assert pattern.search(f"{name}<64>(x)")
        assert not pattern.search(f"void (anonymous namespace)::x{name}<64>")
    assert not pattern.search("void (anonymous namespace)::split_kernel<64>")


@pytest.mark.parametrize("name", ["int8_matmul_roofline.meeting",
                                  "decode_cross_attention_int8_roofline"
                                  ".meeting"])
def test_int8_readers_silent_without_counts(name):
    """A program that keeps no shape counts (the stats lack the key), or a
    run without a trace, reads None and does not raise."""
    read = cell_mod.metric_reader(ROOT, name)
    run = FakeRun([], {"void (anonymous namespace)::tile_kernel<C>()": 1.0,
                       "void (anonymous namespace)::cross_int8_kernel<C>()":
                       1.0})
    for req in run._reqs:
        del req["record"]["stats"]["kernel_shapes"]
    assert read(run) is None
    run.trace = None
    assert read(run) is None


# -- the port's launch count by (kernel, shape) -------------------------

def test_shape_counts_follow_captures_and_replays():
    """``spans.count`` on a capturing thread goes into the capture's record
    only, not into the launch sink the thread is bound to; each replay
    (``spans.add``) adds the record to the replaying thread's sink; an
    unbound thread's launches and replays reach no sink."""
    k6, k5 = ("int8_matmul", (16, 1280, 1280)), (
        "decode_cross_attention_int8", (16, 20, 1500, 64, "float32"))
    sink, outer = collections.Counter(), collections.Counter()
    with spans.bind({}, "dispatch", outer), spans.recording() as record:
        for _ in range(8):
            spans.count(*k6)
        spans.count(*k5)
    assert not outer
    assert dict(record) == {k6: 8, k5: 1}
    with spans.bind({}, "dispatch", sink):
        for _ in range(3):
            spans.add(record)
        spans.count(*k6)                             # one eager launch
    spans.add(record)                                # unbound: no sink
    spans.count(*k5)
    assert dict(sink) == {k6: 25, k5: 3}
    assert spans.launch_rows(sink) == [
        ["decode_cross_attention_int8", [16, 20, 1500, 64, "float32"], 3],
        ["int8_matmul", [16, 1280, 1280], 25]]


def test_bf16_record_adds_no_shapes():
    """A bf16 step's capture records its own kernels by shape (K3, K4,
    ``add_layer_norm``) and no K5 or K6 row, so its replays give the int8
    readers (``harness/kernel_shapes.py``, rows picked by name) no
    launch."""
    rows = (("decode_self_attention", (320, 417, 64)),
            ("decode_cross_attention", (320, 1500, 64)),
            ("add_layer_norm", (16, 1280)))
    with spans.recording() as record:
        for row in rows:
            spans.count(*row)
    sink = collections.Counter()
    with spans.bind({}, "dispatch", sink):
        spans.add(record)
    assert dict(sink) == dict.fromkeys(rows, 1)
    run = FakeRun(spans.launch_rows(sink), {})
    for kernel in kernel_shapes.TRACE_NAMES:
        assert kernel_shapes.counted(run, kernel, lambda *dims: 1.0) == (
            0, 0.0)


def test_pipeline_reports_kernel_shapes():
    """``last_stats["kernel_shapes"]`` is the request's sink as JSON-able
    rows: empty on the CPU, where the plain versions run and count
    nothing."""
    from manual_whisper_tpu_torch.pipeline import load_model
    model = load_model("test", device="cpu", compute_type="int8",
                       asr_options={"int8_cross_kv": True})
    t = np.arange(16000 * 4) / 16000
    audio = (0.3 * np.sin(2 * np.pi * 220 * t)
             * (0.5 + 0.5 * np.sign(np.sin(2 * np.pi * 0.7 * t))))
    model.transcribe(audio.astype(np.float32), batch_size=2, language="zh")
    stats = model.last_stats
    assert stats["kernel_shapes"] == []
    json.dumps(stats)
