"""Batched Whisper decoding (port of the JAX ``models/decode.py``).

- ``DecodeLoop``: cross K/V and prefill over the prompt, then single-token
  steps over a preallocated KV cache, the whole batch in lockstep;
  finished rows emit EOT and stop counting.  Returns tokens, summed
  logprobs, lengths and the no-speech probability at the SOT slot, all on
  the device.  The steps run as chunks of FINISH_CHECK_EVERY
  (``decode_chunk``) over static buffers, with the position, step index
  and temperature on the device; on CUDA each chunk is a captured CUDA
  graph, replayed (``models/graphs.py``: the counterpart of JAX
  ``greedy_decode_jit``'s compiled ``lax.while_loop``), on the CPU it runs
  eagerly.  The host checks between chunks that every row has finished.
  The token choice is the loop's ``pick``: ``GreedyPick`` (greedy and
  sampled), or ``timestamps.TimestampRules`` (the timestamp-token mode).
- ``BatchDecoder``: prompt building, one loop per shape and kind (greedy,
  ``beam.BeamLoop`` for ``beam_size > 1`` at T = 0, timestamp rules), the
  quality gates (compression ratio, avg logprob, no-speech) and the
  temperature fallback ladder on the host.

Tokens are drawn as JAX draws them: Gumbel noise at every step, then the
sampled or the greedy token by the device temperature, so one captured
chunk serves every rung.  The noise comes from a ``torch.Generator``
seeded by ``opts.seed + 1000003 * rng_tag`` before each loop: the same
seed gives the same tokens, captured or eager, but not JAX's tokens
(other random numbers).  Beam search and the timestamp rules draw none.

``int8_cross_kv`` quantizes the cross K/V to int8 per layer (scales in
bf16 with ``ckv_scale_bf16``); the decode steps then read it through K5
instead of K4.  There is no ``fused_attention`` option: on a CUDA device
the greedy and timestamp steps always run the K3/K4/K5 kernels, on the
CPU their plain versions; the beam step's attentions are plain products
on both, as the JAX beam's einsums are.

With a mesh (``parallel/mesh.py``) a ``BatchDecoder`` decodes the rank's
rows of each batch (the data dim's contiguous block) on the rank's weight
shards (the model dim), and gathers every loop's results over the data
dim, so each rank holds the whole batch's results, as the JAX controller
does.  Sampled noise is drawn for the whole batch and each rank takes its
rows, so a sampled rung draws what one process would.  Retry buckets are
multiples of the data-parallel size, as in JAX.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, all_true, axis_group,
                             axis_rank, axis_size, gather_rows, local_rows)
from ..spans import span
from ..tokenizer import WhisperTokenizer
from .graphs import ChunkGraphs
from .whisper import (Params, StepLengths, WhisperConfig, alloc_cross_kv,
                      decode_step, decoder_forward, init_kv_cache,
                      local_heads, precompute_cross_kv)

# steps between checks that every row has finished: each check waits for
# the device, and extra steps after the last EOT change no output
# (finished rows emit EOT with logprob 0 and no length)
FINISH_CHECK_EVERY = 16


@dataclasses.dataclass(frozen=True)
class DecodingOptions:
    """Mirrors the option surface the reference exercises
    (initial_prompt: transcribe.py:111; temperature: replicateClient.js:43;
    language/task: transcribe.py:112/123)."""

    language: str = "zh"
    task: str = "transcribe"
    temperatures: Tuple[float, ...] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
    initial_prompt: Optional[str] = None
    max_new_tokens: int = 224
    beam_size: int = 1
    length_penalty: float = 1.0
    int8_cross_kv: bool = False
    ckv_scale_bf16: bool = False
    suppress_blank: bool = True
    suppress_non_speech: bool = True
    suppress_tokens: Optional[Tuple[int, ...]] = None
    without_timestamps: bool = True
    compression_ratio_threshold: Optional[float] = 2.4
    log_prob_threshold: Optional[float] = -1.0
    no_speech_threshold: Optional[float] = 0.6
    seed: int = 0


def build_suppress_mask(tokenizer: WhisperTokenizer, cfg: WhisperConfig,
                        opts: DecodingOptions) -> np.ndarray:
    """Additive -inf mask [n_vocab] applied at every step."""
    sp = tokenizer.special
    mask = np.zeros(cfg.n_vocab, np.float32)
    suppress = {sp.sot, sp.sot_prev, sp.sot_lm, sp.no_speech}
    suppress.update(tokenizer.all_language_tokens)
    suppress.add(sp.translate)
    suppress.add(sp.transcribe)
    if opts.suppress_non_speech:
        suppress.update(tokenizer.non_speech_tokens())
    suppress.update(opts.suppress_tokens or ())
    suppress.add(sp.no_timestamps)   # never a valid generation
    if opts.without_timestamps:
        mask[sp.timestamp_begin:] = -np.inf
    for t in suppress:
        if t < cfg.n_vocab:
            mask[t] = -np.inf
    return mask


def build_blank_mask(tokenizer: WhisperTokenizer, cfg: WhisperConfig
                     ) -> np.ndarray:
    """First-step mask: suppress blank/space and EOT (OpenAI suppress_blank)."""
    mask = np.zeros(cfg.n_vocab, np.float32)
    space = tokenizer.encode(" ")
    if len(space) == 1:
        mask[space[0]] = -np.inf
    mask[tokenizer.special.eot] = -np.inf
    return mask


def _sample(logits: torch.Tensor, temperature: torch.Tensor,
            gen: torch.Generator,
            rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Greedy where ``temperature`` (a device f32 scalar) is 0, else a
    Gumbel-max draw at that temperature; the noise is drawn either way
    (JAX ``sample``), so one captured chunk serves every rung.  ``rows``
    (start, total): the logits are rows [start, start + B) of a batch of
    ``total``, and the noise is drawn for all of them."""
    greedy = logits.argmax(dim=-1)
    shape = logits.shape if rows is None else (rows[1],) + logits.shape[1:]
    u = torch.rand(shape, generator=gen, device=logits.device)
    if rows is not None:
        u = u[rows[0]:rows[0] + logits.shape[0]]
    u = u * (1.0 - 1e-9) + 1e-9                          # [1e-9, 1)
    gumbel = -torch.log(-torch.log(u))
    sampled = (logits / temperature.clamp_min(1e-6) + gumbel).argmax(dim=-1)
    return torch.where(temperature > 0, sampled, greedy)


def _logprob_of(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(1, tok[:, None])[:, 0]


class DecodeOutput:
    """Results of one decode loop: ``tokens`` [B, max_new] int64
    (EOT-filled), ``sum_logprob`` [B] f32, ``lengths`` [B] int32 (counts
    the EOT step), ``no_speech`` [B] f32, and ``steps``, the decode
    positions run (prefill token + steps).  A loop's ``run`` returns them
    on the device; ``to_host`` copies them to the host.  On CUDA those are
    pinned buffers filled by copies enqueued on the current stream, with
    an event recorded after them: reading a result waits for that event
    and nothing else (not for work enqueued after it)."""

    def __init__(self, tokens: torch.Tensor, sum_logprob: torch.Tensor,
                 lengths: torch.Tensor, no_speech: torch.Tensor, steps: int,
                 ready: Optional["torch.cuda.Event"] = None):
        self._tensors = (tokens, sum_logprob, lengths, no_speech)
        self.steps = steps
        self._ready = ready

    def _get(self, i: int) -> torch.Tensor:
        ready = self._ready
        if ready is not None:
            ready.synchronize()
            self._ready = None
        return self._tensors[i]

    tokens = property(lambda self: self._get(0))
    sum_logprob = property(lambda self: self._get(1))
    lengths = property(lambda self: self._get(2))
    no_speech = property(lambda self: self._get(3))

    def to_host(self) -> "DecodeOutput":
        """Host copies of the results.  On the CPU the loop's results are
        copies already and are returned as they are."""
        if self._tensors[0].device.type != "cuda":
            return self
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in self._tensors)
        for dst, src in zip(host, self._tensors):
            dst.copy_(src, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return DecodeOutput(*host, self.steps, ready=ready)


@dataclasses.dataclass
class LoopState:
    """What the decode steps read and write, all on the device."""
    tok: torch.Tensor             # [B] int64, the last token
    tokens: torch.Tensor          # [B, max_new] int64
    finished: torch.Tensor        # [B] bool
    lengths: torch.Tensor         # [B] int32
    sum_lp: torch.Tensor          # [B] f32
    i: torch.Tensor               # [1] int32, the tokens slot of the next step
    pos: torch.Tensor             # [1] int32, its cache slot (prefix + i - 1)
    temperature: torch.Tensor     # [] f32

    @classmethod
    def zeros(cls, batch: int, max_new: int,
              device: torch.device) -> "LoopState":
        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)
        return cls(z(batch, torch.long), z((batch, max_new), torch.long),
                   z(batch, torch.bool), z(batch, torch.int32),
                   z(batch, torch.float32), z(1, torch.int32),
                   z(1, torch.int32), z((), torch.float32))


class GreedyPick:
    """Token choice of JAX ``greedy_decode_jit``: the suppress mask at every
    step (and the blank mask at the first), then ``_sample`` at the
    loop's device temperature from ``gen`` (over ``rows`` of a larger
    batch, as ``_sample`` takes them, on a data-parallel rank)."""

    def __init__(self, suppress_mask: torch.Tensor, blank_mask: torch.Tensor,
                 gen: torch.Generator,
                 rows: Optional[Tuple[int, int]] = None):
        self.suppress, self.blank, self.gen = suppress_mask, blank_mask, gen
        self.rows = rows

    def first(self, logits: torch.Tensor, st: "LoopState"):
        """Prefill logits [B, V] -> (first token, its logprob)."""
        first = logits + self.suppress + self.blank
        tok = _sample(first, st.temperature, self.gen, self.rows)
        return tok, _logprob_of(first, tok)

    def step(self, logits: torch.Tensor, st: "LoopState"):
        """Step logits -> (the logits the logprob is read from, token)."""
        logits = logits + self.suppress
        return logits, _sample(logits, st.temperature, self.gen, self.rows)

    def advance(self, st: "LoopState", nxt: torch.Tensor) -> None:
        """State of the choice itself, before ``st.tok`` becomes ``nxt``."""


def decode_chunk(params: Params, st: LoopState, cache, cross_kv,
                 cross_len: torch.Tensor, pick, tok_emb_f32: torch.Tensor,
                 eot: int, cfg: WhisperConfig, n_steps: int,
                 group=None) -> None:
    """``n_steps`` decode steps over ``st`` in place (the body of JAX
    ``greedy_decode_jit``'s while loop, unrolled n times; with a
    ``timestamps.TimestampRules`` pick, ``greedy_timestamps_jit``'s).
    ``pick`` chooses each token; ``group`` is the model group of
    tensor-parallel shards.  Reads and writes only the
    tensors it is given, with no host value per step, so on CUDA its
    capture replays at any position; on the CPU it runs as it stands.
    Finished rows emit EOT with logprob 0 and no length."""
    lengths = StepLengths(st.pos, cross_len)
    for _ in range(n_steps):
        logits, nxt = pick.step(
            decode_step(params, st.tok, lengths, cache, cross_kv, cfg,
                        tok_emb_f32, group), st)
        nxt = torch.where(st.finished, torch.full_like(nxt, eot), nxt)
        lp = torch.where(st.finished, torch.zeros_like(st.sum_lp),
                         _logprob_of(logits, nxt))
        pick.advance(st, nxt)
        st.tokens.index_copy_(1, st.i.long(), nxt[:, None])
        st.lengths += (~st.finished).to(torch.int32)
        st.finished |= nxt == eot
        st.sum_lp += lp
        st.tok.copy_(nxt)
        st.i += 1
        st.pos += 1


class ChunkedLoop:
    """What ``DecodeLoop`` and ``beam.BeamLoop`` share: steps in chunks of
    FINISH_CHECK_EVERY over static buffers, captured as CUDA graphs when a
    graph pool is given (else run eagerly), and the host's check between
    chunks that every row has finished (on every rank of a model group,
    whose chunks run collectives together).  A subclass sets ``params``,
    ``group`` (the model group of tensor-parallel shards, or None), ``p``,
    ``max_new`` and ``state`` (with device ``i`` and ``pos``) and defines
    ``_chunk(n)``."""

    def _capture(self, device: torch.device, gen, graphs_pool) -> None:
        self.graphs = None
        if graphs_pool is not None:
            self.graphs = ChunkGraphs(device, gen, graphs_pool)
            for n in self.chunk_lengths():
                self.graphs.capture(n, self._chunk, self._rewind)

    def chunk_lengths(self) -> List[int]:
        """Step counts of the chunks a loop runs (before an early stop)."""
        steps = self.max_new - 1
        full = [FINISH_CHECK_EVERY] if steps >= FINISH_CHECK_EVERY else []
        return full + ([steps % FINISH_CHECK_EVERY]
                       if steps % FINISH_CHECK_EVERY else [])

    def _rewind(self) -> None:
        self.state.i.fill_(1)
        self.state.pos.fill_(self.p)

    def run_chunk(self, n: int) -> None:
        with span("decode.replay"):
            if self.graphs is None:
                self._chunk(n)
            else:
                self.graphs.replay(n)

    def _run_chunks(self, finished: torch.Tensor) -> int:
        """The chunks after the first token, checking before each that not
        every row has ``finished`` (at steps 1, 17, 33, ...: the eager
        loop's checks).  Returns the positions run."""
        self._rewind()
        i = 1
        while i < self.max_new:
            with span("decode.finish_check"):
                if all_true(finished, self.group):
                    break
            n = min(FINISH_CHECK_EVERY, self.max_new - i)
            self.run_chunk(n)
            i += n
        return i


class DecodeLoop(ChunkedLoop):
    """Prefill + decode loop over static buffers for one shape: ``rows``
    batch rows, ``ta`` cross positions, a prompt of ``p`` tokens,
    ``max_new`` tokens, one cross-K/V kind (bf16, or int8 with ``scale_dtype``
    scales), one token choice ``pick`` (``GreedyPick``, or
    ``timestamps.TimestampRules``).  The buffers: the self cache (per layer
    [B, H, p + max_new, dh]), the cross K/V and the ``LoopState``; each run
    overwrites all it reads.

    With ``graphs_pool`` (a CUDA graph memory pool, which BatchDecoder
    passes on CUDA) the chunks of FINISH_CHECK_EVERY steps and the shorter
    last chunk, (max_new - 1) % FINISH_CHECK_EVERY steps, are captured
    when the loop is built and replayed after; without it
    ``decode_chunk`` runs eagerly.  Cross K/V and prefill run eagerly,
    once a loop.  ``group``: the model group of tensor-parallel shards."""

    def __init__(self, params: Params, cfg: WhisperConfig, rows: int,
                 ta: int, p: int, max_new: int, quantize: bool,
                 scale_dtype: torch.dtype, pick, eot: int,
                 device: torch.device, graphs_pool=None, group=None):
        self.params, self.cfg, self.group = params, cfg, group
        self.p, self.max_new = p, max_new
        self.quantize, self.scale_dtype = quantize, scale_dtype
        self.pick, self.eot = pick, eot
        heads = local_heads(params, "decoder", cfg)
        self.cache = init_kv_cache(cfg, rows, p + max_new, device, heads=heads)
        self.cross = alloc_cross_kv(cfg, rows, ta, device, quantize,
                                    scale_dtype, heads=heads)
        self.state = LoopState.zeros(rows, max_new, device)
        self.cross_len = torch.full((1,), ta, dtype=torch.int32,
                                    device=device)
        self.tok_emb_f32 = params["decoder"]["tok_emb"].float()
        self._capture(device, pick.gen, graphs_pool)

    def _chunk(self, n: int) -> None:
        decode_chunk(self.params, self.state, self.cache, self.cross,
                     self.cross_len, self.pick, self.tok_emb_f32, self.eot,
                     self.cfg, n, self.group)

    def run(self, xa: torch.Tensor, prefix: List[int], temperature: float,
            sot_index: int = 0, no_speech_token: int = 0) -> DecodeOutput:
        """Cross K/V, prefill, first token, then the chunks, checking
        between them that every row has finished (at steps 1, 17, 33, ...:
        the eager loop's checks).  Returns copies of the results."""
        b, p, st = xa.shape[0], len(prefix), self.state
        with span("decode.cross_kv"):
            precompute_cross_kv(self.params, xa, self.cfg,
                                quantize=self.quantize,
                                scale_dtype=self.scale_dtype, out=self.cross,
                                group=self.group)
        with span("decode.prepare"):
            prefix_b = torch.tensor(prefix, dtype=torch.long,
                                    device=xa.device).expand(b, p)
        with span("decode.prefill"):
            prefill_logits, _ = decoder_forward(self.params, prefix_b, None,
                                                self.cfg, pos_offset=0,
                                                kv_cache=self.cache,
                                                cross_kv=self.cross,
                                                group=self.group)
            st.temperature.fill_(temperature)
            tok, lp = self.pick.first(prefill_logits[:, -1, :], st)
            st.tok.copy_(tok)
            st.tokens.fill_(self.eot)
            st.tokens[:, 0] = tok
            st.finished.copy_(tok == self.eot)
            st.lengths.fill_(1)
            st.sum_lp.copy_(lp)
        i = self._run_chunks(st.finished)
        no_speech = torch.softmax(prefill_logits[:, sot_index, :], dim=-1)[
            :, no_speech_token]
        return DecodeOutput(st.tokens.clone(), st.sum_lp.clone(),
                            st.lengths.clone(), no_speech, i)


def compression_ratio(text: str) -> float:
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


@dataclasses.dataclass
class SegmentResult:
    tokens: List[int]
    text: str
    avg_logprob: float
    no_speech_prob: float
    compression_ratio: float
    temperature: float


class BatchDecoder:
    """Host side of decoding: prompt building, decode, fallback ladder.

    Owns one loop per (rows bucket, cross positions, prompt and token
    budget; the cross-K/V kind is the options'), by kind: the greedy
    ``DecodeLoop`` of every rung (``_loops``), with ``beam_size > 1`` the
    ``beam.BeamLoop`` of the T = 0 rungs (``_beam_loops``), and the
    timestamp-rule ``DecodeLoop`` (``_ts_loops``).  Each is built on first
    use as ``jax.jit`` compiles on first call: on CUDA that captures its
    chunks, all in one graph memory pool, freed with the decoder.  A
    lock keeps one decode at a time on the static buffers, so a ladder
    retry on the pipeline's fetch worker and the next batch's first rung
    on the dispatch thread take turns; a decode's results leave it as
    host copies enqueued before the lock is released, on the default
    stream every decoding thread uses, so the next decode cannot overwrite
    the buffers before the copies have run, and reading them waits only
    for the copies (``DecodeOutput``).  ``eager=True``
    runs the chunks eagerly on CUDA too, for comparison only; on the CPU
    they always run eagerly.

    With ``mesh`` every decode takes the rank's rows of a batch
    (``parallel.shard_batch``'s block of the data dim) and returns the
    whole batch's results, gathered over the data dim; the weights are
    the rank's shards.  ``data_parallel`` is the data dim's size.

    ``stats`` accumulates, for run reports: ``token_rows`` (rows x decode
    positions run, padding rows included; a beam loop counts rows x beams),
    ``rung_rows`` (rows decoded at each rung of the temperature ladder),
    ``decode_calls`` (loops run of every kind: one cross-K/V and one
    prefill each), ``decode_steps`` (single-token steps of the greedy and
    timestamp loops: K3 and K4 or K5 once a layer), ``beam_calls`` and
    ``beam_steps`` (beam loops and their steps: no K3/K4/K5, the block
    matmuls at M = rows x beams) and ``capture_s`` (host seconds spent
    capturing chunks, warm-up runs included); rows are the rank's."""

    def __init__(self, params: Params, cfg: WhisperConfig,
                 tokenizer: WhisperTokenizer, opts: DecodingOptions,
                 device: torch.device, eager: bool = False, mesh=None):
        self.params = params
        self.data_parallel = 1 if mesh is None else axis_size(mesh,
                                                              DATA_AXIS)
        self._data_rank = 0 if mesh is None else axis_rank(mesh, DATA_AXIS)
        self._data_group = None if mesh is None else axis_group(mesh,
                                                                DATA_AXIS)
        self.model_group = None if mesh is None else axis_group(mesh,
                                                                MODEL_AXIS)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.opts = opts
        self.device = device
        self.captured = device.type == "cuda" and not eager
        self._suppress = torch.from_numpy(
            build_suppress_mask(tokenizer, cfg, opts)).to(device)
        self._blank = (torch.from_numpy(build_blank_mask(tokenizer, cfg))
                       .to(device) if opts.suppress_blank
                       else torch.zeros(cfg.n_vocab, device=device))
        # timestamp mode's suppress mask and prefix, built on first use
        self._ts: Optional[Tuple[torch.Tensor, List[int]]] = None
        self._gen = torch.Generator(device=device)
        self._loops: Dict[tuple, DecodeLoop] = {}
        self._beam_loops: Dict[tuple, object] = {}
        self._ts_loops: Dict[tuple, DecodeLoop] = {}
        self._pool = None
        self._lock = threading.Lock()
        self.stats = {"token_rows": 0, "rung_rows": collections.Counter(),
                      "decode_calls": 0, "decode_steps": 0, "beam_calls": 0,
                      "beam_steps": 0, "capture_s": 0.0}

    def _prefix(self) -> Tuple[List[int], int]:
        """(prefix tokens, index of SOT within the prefix)."""
        tk = self.tokenizer
        prompt: List[int] = []
        if self.opts.initial_prompt:
            prompt = tk.prompt_sequence(self.opts.initial_prompt,
                                        max_len=self.cfg.n_text_ctx // 2 - 1)
        sot_seq = tk.sot_sequence(
            language=self.opts.language, task=self.opts.task,
            without_timestamps=self.opts.without_timestamps)
        return prompt + sot_seq, len(prompt)

    def _max_new(self, p: int) -> int:
        return min(self.opts.max_new_tokens, self.cfg.n_text_ctx - p - 1)

    def decode(self, xa: torch.Tensor, temperature: float = 0.0,
               rng_tag: int = 0) -> List[SegmentResult]:
        """Decode a batch of encoded segments xa [B, Ta, d] (the rank's
        rows with a mesh) at one temperature; returns per-segment results
        of the whole batch with quality stats."""
        return self.decode_finalize(
            self.decode_submit(xa, temperature, rng_tag=rng_tag),
            int(xa.shape[0]) * self.data_parallel, temperature)

    def _fetched(self, out: DecodeOutput) -> DecodeOutput:
        """A loop's device results of the rank's rows -> the whole batch's
        (gathered over the data dim with a mesh), copied to the host
        (``DecodeOutput.to_host``).  Called under the lock, so the copies
        are enqueued before the next loop may overwrite the buffers."""
        with span("decode.fetch"):
            g = self._data_group
            if g is not None:
                out = DecodeOutput(gather_rows(out.tokens, g),
                                   gather_rows(out.sum_logprob, g),
                                   gather_rows(out.lengths, g),
                                   gather_rows(out.no_speech, g), out.steps)
            return out.to_host()

    def decode_submit(self, xa: torch.Tensor, temperature: float = 0.0,
                      rng_tag: int = 0) -> DecodeOutput:
        """Run the decode loop; its results leave as host copies
        (``_fetched``) that ``decode_finalize`` reads.  With ``beam_size >
        1`` at T = 0 that is the beam search (JAX ``decode_submit``), else
        the greedy or sampled loop, its generator seeded with ``opts.seed +
        1000003 * rng_tag`` before the loop."""
        no_speech = self.tokenizer.special.no_speech
        beam = self.opts.beam_size > 1 and temperature == 0.0
        with span("decode.loop"), self._lock:
            with span("decode.prepare"):
                prefix, sot_index = self._prefix()
                max_new = self._max_new(len(prefix))
                rows, ta = int(xa.shape[0]), int(xa.shape[1])
                key = (rows, ta, len(prefix), max_new)
                if beam:
                    loop = self._get(self._beam_loops, key, self._make_beam)
                else:
                    loop = self._get(self._loops, key, self._make_greedy)
                    self._gen.manual_seed(self.opts.seed + 1000003 * rng_tag)
            if beam:
                out = loop.run(xa, prefix, self._blank, sot_index=sot_index,
                               no_speech_token=no_speech)
                self.stats["token_rows"] += rows * loop.beams * out.steps
                self.stats["beam_calls"] += 1
                self.stats["beam_steps"] += out.steps - 1
            else:
                out = loop.run(xa, prefix, float(temperature),
                               sot_index=sot_index, no_speech_token=no_speech)
                self.stats["token_rows"] += rows * out.steps
                self.stats["decode_steps"] += out.steps - 1
            self.stats["decode_calls"] += 1
            return self._fetched(out)

    def _get(self, loops: dict, key: tuple, make):
        """The loop of ``key`` in ``loops``, built by ``make(*key, pool)``
        on first use (on CUDA with the decoder's graph pool)."""
        if key not in loops:
            if self.captured and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            loop = make(*key, self._pool if self.captured else None)
            if loop.graphs is not None:
                self.stats["capture_s"] += loop.graphs.capture_s
            loops[key] = loop
        return loops[key]

    def _scale_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.opts.ckv_scale_bf16 else torch.float32

    def _make_greedy(self, rows, ta, p, max_new, pool) -> DecodeLoop:
        noise_rows = (None if self._data_group is None else
                      (self._data_rank * rows, self.data_parallel * rows))
        return DecodeLoop(
            self.params, self.cfg, rows, ta, p, max_new,
            self.opts.int8_cross_kv, self._scale_dtype(),
            GreedyPick(self._suppress, self._blank, self._gen, noise_rows),
            self.tokenizer.special.eot, self.device, graphs_pool=pool,
            group=self.model_group)

    def _make_beam(self, rows, ta, p, max_new, pool):
        from .beam import BeamLoop
        return BeamLoop(
            self.params, self.cfg, rows, self.opts.beam_size, ta, p, max_new,
            self.opts.int8_cross_kv, self._scale_dtype(), self._suppress,
            self.tokenizer.special.eot, self.opts.length_penalty,
            self.device, graphs_pool=pool, group=self.model_group)

    def _make_ts(self, rows, ta, p, max_new, pool) -> DecodeLoop:
        from .timestamps import TimestampRules
        sp = self.tokenizer.special
        rules = TimestampRules(self._ts[0], sp.eot, sp.timestamp_begin,
                               rows, self.device)
        return DecodeLoop(
            self.params, self.cfg, rows, ta, p, max_new,
            self.opts.int8_cross_kv, self._scale_dtype(), rules, sp.eot,
            self.device, graphs_pool=pool, group=self.model_group)

    def timestamps_submit(self, xa: torch.Tensor) -> DecodeOutput:
        """The timestamp-rule greedy loop (JAX ``timestamps_submit``): the
        SOT sequence with timestamps and no initial prompt, timestamps not
        suppressed, argmax, no fallback ladder.  Results leave as host
        copies (``_fetched``) that ``timestamps_finalize`` reads."""
        tk = self.tokenizer
        with span("decode.loop"), self._lock:
            with span("decode.prepare"):
                if self._ts is None:
                    ts_opts = dataclasses.replace(self.opts,
                                                  without_timestamps=False)
                    self._ts = (torch.from_numpy(build_suppress_mask(
                        tk, self.cfg, ts_opts)).to(self.device),
                        tk.sot_sequence(self.opts.language, self.opts.task,
                                        without_timestamps=False))
                prefix = self._ts[1]
                max_new = self._max_new(len(prefix))
                rows, ta = int(xa.shape[0]), int(xa.shape[1])
                loop = self._get(self._ts_loops,
                                 (rows, ta, len(prefix), max_new),
                                 self._make_ts)
            out = loop.run(xa, prefix, 0.0)
            self.stats["token_rows"] += rows * out.steps
            self.stats["decode_calls"] += 1
            self.stats["decode_steps"] += out.steps - 1
            return self._fetched(out)

    def timestamps_finalize(self, out: DecodeOutput,
                            chunk_starts: Sequence[float],
                            chunk_durations: Sequence[float]
                            ) -> List[List[dict]]:
        """Fetch a ``timestamps_submit`` result and cut each row into
        sub-segments at its timestamp pairs."""
        from .timestamps import split_segments_by_timestamps
        with span("finalize.wait"):
            tokens = out.tokens.cpu().numpy()
        with span("finalize.text"):
            return [split_segments_by_timestamps(
                tokens[i], self.tokenizer, float(chunk_starts[i]),
                float(chunk_durations[i])) for i in range(len(chunk_starts))]

    def decode_with_timestamps(self, xa: torch.Tensor,
                               chunk_starts: Sequence[float],
                               chunk_durations: Sequence[float]
                               ) -> List[List[dict]]:
        """Timestamp-rule greedy decode -> per-row sub-segment lists (the
        ``without_timestamps=False`` mode; ``models/timestamps.py``)."""
        return self.timestamps_finalize(self.timestamps_submit(xa),
                                        chunk_starts, chunk_durations)

    def decode_finalize(self, out: DecodeOutput, b: int,
                        temperature: float = 0.0) -> List[SegmentResult]:
        """Fetch a decode_submit result and build SegmentResults."""
        tk = self.tokenizer
        with span("finalize.wait"):
            tokens = out.tokens.cpu().numpy()
            sum_lp = out.sum_logprob.cpu().numpy()
            lengths = out.lengths.cpu().numpy()
            no_speech = out.no_speech.cpu().numpy()
        results = []
        with span("finalize.text"):
            for i in range(b):
                toks = [int(t) for t in tokens[i] if t != tk.special.eot]
                text = tk.decode(toks).strip()
                # lengths counts the EOT-emitting step; a row truncated at
                # max_new without EOT gets the +1 explicitly
                # (faster-whisper's gating scale)
                denom = int(lengths[i]) + (1 if len(toks) == tokens.shape[1]
                                           else 0)
                avg_lp = float(sum_lp[i] / max(denom, 1))
                results.append(SegmentResult(
                    tokens=toks, text=text, avg_logprob=avg_lp,
                    no_speech_prob=float(no_speech[i]),
                    compression_ratio=compression_ratio(text),
                    temperature=temperature))
        return results

    def _needs_fallback(self, r: SegmentResult) -> bool:
        o = self.opts
        if (o.compression_ratio_threshold is not None
                and r.compression_ratio > o.compression_ratio_threshold):
            return True
        if (o.log_prob_threshold is not None
                and r.avg_logprob < o.log_prob_threshold):
            return True
        return False

    def decode_with_fallback(self, xa: torch.Tensor,
                             first: Optional[DecodeOutput] = None,
                             n_valid: Optional[int] = None,
                             rng_tag: int = 0) -> List[SegmentResult]:
        """faster-whisper style temperature ladder: retry failing segments
        at increasing temperature; keep the first passing result.
        ``first`` takes an already-run ``decode_submit`` result for the
        first rung.  ``n_valid`` limits the gates to the real rows (the
        zero-audio padding rows always fail).  Retry sub-batches are padded
        up to the chunk batcher's power-of-two buckets, multiples of the
        data-parallel size.  With a mesh ``xa`` holds the rank's rows, and
        ``n_valid``, the gates and the retries are over the whole batch:
        a retry's rows are taken from the whole batch's xa (gathered once,
        at the first retry), and the rank decodes its block of them."""
        from ..pipeline.chunking import _bucket_for
        temps = self.opts.temperatures or (0.0,)
        dp = self.data_parallel
        if first is None:
            first = self.decode_submit(xa, temps[0], rng_tag=rng_tag * 16)
        b = int(xa.shape[0]) * dp
        results = self.decode_finalize(first, b, temps[0])
        with self._lock:
            self.stats["rung_rows"][0] += int(xa.shape[0])
        n_valid = b if n_valid is None else n_valid
        pending = [i for i, r in enumerate(results[:n_valid])
                   if self._needs_fallback(r)]
        xa_all = None
        for rung, temp in enumerate(temps[1:], start=1):
            if not pending:
                break
            with span("finalize.retry"):
                if xa_all is None:
                    xa_all = gather_rows(xa, self._data_group)
                rows = _bucket_for(len(pending), b, dp)
                idx = pending + [pending[0]] * (rows - len(pending))
                sub = local_rows(
                    xa_all[torch.tensor(idx, device=xa.device)], dp,
                    self._data_rank)
                with self._lock:
                    self.stats["rung_rows"][rung] += rows // dp
                retried = self.decode(
                    sub, temperature=temp,
                    rng_tag=rng_tag * 16 + rung)[:len(pending)]
                still = []
                for j, i in enumerate(pending):
                    results[i] = retried[j]
                    if self._needs_fallback(retried[j]):
                        still.append(i)
                pending = still
        return results

    def is_no_speech(self, r: SegmentResult) -> bool:
        """Silence gate (OpenAI semantics: no-speech prob high AND logprob
        low => treat as silence)."""
        o = self.opts
        return (o.no_speech_threshold is not None
                and r.no_speech_prob > o.no_speech_threshold
                and (o.log_prob_threshold is None
                     or r.avg_logprob < o.log_prob_threshold))
