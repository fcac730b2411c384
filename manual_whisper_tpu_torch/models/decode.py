"""Batched greedy Whisper decoding (port of the JAX ``models/decode.py``).

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
- ``BatchDecoder``: prompt building, one ``DecodeLoop`` per shape, the
  quality gates (compression ratio, avg logprob, no-speech) and the
  temperature fallback ladder on the host.

Tokens are drawn as JAX draws them: Gumbel noise at every step, then the
sampled or the greedy token by the device temperature, so one captured
chunk serves every rung.  The noise comes from a ``torch.Generator``
seeded by ``opts.seed + 1000003 * rng_tag`` before each loop: the same
seed gives the same tokens, captured or eager, but not JAX's tokens
(other random numbers).

``int8_cross_kv`` quantizes the cross K/V to int8 per layer (scales in
bf16 with ``ckv_scale_bf16``); the decode steps then read it through K5
instead of K4.  Not ported yet: ``beam_size > 1`` and timestamp-token
decoding raise ``NotImplementedError``.  There is no ``fused_attention``
option: on a CUDA device the decode steps always run the K3/K4/K5
kernels, on the CPU their plain versions.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..tokenizer import WhisperTokenizer
from .graphs import ChunkGraphs
from .whisper import (Params, StepLengths, WhisperConfig, alloc_cross_kv,
                      decode_step, decoder_forward, init_kv_cache,
                      precompute_cross_kv)

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
            gen: torch.Generator) -> torch.Tensor:
    """Greedy where ``temperature`` (a device f32 scalar) is 0, else a
    Gumbel-max draw at that temperature; the noise is drawn either way
    (JAX ``sample``), so one captured chunk serves every rung."""
    greedy = logits.argmax(dim=-1)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = u * (1.0 - 1e-9) + 1e-9                          # [1e-9, 1)
    gumbel = -torch.log(-torch.log(u))
    sampled = (logits / temperature.clamp_min(1e-6) + gumbel).argmax(dim=-1)
    return torch.where(temperature > 0, sampled, greedy)


def _logprob_of(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(1, tok[:, None])[:, 0]


@dataclasses.dataclass
class DecodeOutput:
    """Device results of one decode loop (``DecodeLoop.run``)."""
    tokens: torch.Tensor          # [B, max_new] int64, EOT-filled
    sum_logprob: torch.Tensor     # [B] f32
    lengths: torch.Tensor         # [B] int32 (counts the EOT step)
    no_speech: torch.Tensor       # [B] f32
    steps: int                    # decode positions run (prefill token + steps)


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


def decode_chunk(params: Params, st: LoopState, cache, cross_kv,
                 cross_len: torch.Tensor, suppress_mask: torch.Tensor,
                 tok_emb_f32: torch.Tensor, gen: torch.Generator, eot: int,
                 cfg: WhisperConfig, n_steps: int) -> None:
    """``n_steps`` decode steps over ``st`` in place (the body of JAX
    ``greedy_decode_jit``'s while loop, unrolled n times).  Reads and
    writes only the tensors it is given, with no host value per step, so
    on CUDA its capture replays at any position; on the CPU it runs as it
    stands.  Finished rows emit EOT with logprob 0 and no length."""
    lengths = StepLengths(st.pos, cross_len)
    for _ in range(n_steps):
        logits = decode_step(params, st.tok, lengths, cache, cross_kv, cfg,
                             tok_emb_f32) + suppress_mask
        nxt = _sample(logits, st.temperature, gen)
        nxt = torch.where(st.finished, torch.full_like(nxt, eot), nxt)
        lp = torch.where(st.finished, torch.zeros_like(st.sum_lp),
                         _logprob_of(logits, nxt))
        st.tokens.index_copy_(1, st.i.long(), nxt[:, None])
        st.lengths += (~st.finished).to(torch.int32)
        st.finished |= nxt == eot
        st.sum_lp += lp
        st.tok.copy_(nxt)
        st.i += 1
        st.pos += 1


class DecodeLoop:
    """Prefill + decode loop over static buffers for one shape: ``rows``
    batch rows, ``ta`` cross positions, a prompt of ``p`` tokens,
    ``max_new`` tokens, one cross-K/V kind (bf16, or int8 with ``scale_dtype``
    scales).  The buffers: the self cache (per layer [B, H, p + max_new,
    dh]), the cross K/V and the ``LoopState``; each run overwrites all it
    reads.

    With ``graphs_pool`` (a CUDA graph memory pool, which BatchDecoder
    passes on CUDA) the chunks of FINISH_CHECK_EVERY steps and the shorter
    last chunk, (max_new - 1) % FINISH_CHECK_EVERY steps, are captured
    when the loop is built and replayed after; without it
    ``decode_chunk`` runs eagerly.  Cross K/V and prefill run eagerly,
    once a loop."""

    def __init__(self, params: Params, cfg: WhisperConfig, rows: int,
                 ta: int, p: int, max_new: int, quantize: bool,
                 scale_dtype: torch.dtype, suppress_mask: torch.Tensor,
                 eot: int, gen: torch.Generator, device: torch.device,
                 graphs_pool=None):
        self.params, self.cfg = params, cfg
        self.p, self.max_new = p, max_new
        self.quantize, self.scale_dtype = quantize, scale_dtype
        self.suppress, self.eot, self.gen = suppress_mask, eot, gen
        self.cache = init_kv_cache(cfg, rows, p + max_new, device)
        self.cross = alloc_cross_kv(cfg, rows, ta, device, quantize,
                                    scale_dtype)
        self.state = LoopState.zeros(rows, max_new, device)
        self.cross_len = torch.full((1,), ta, dtype=torch.int32,
                                    device=device)
        self.tok_emb_f32 = params["decoder"]["tok_emb"].float()
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

    def _chunk(self, n: int) -> None:
        decode_chunk(self.params, self.state, self.cache, self.cross,
                     self.cross_len, self.suppress, self.tok_emb_f32,
                     self.gen, self.eot, self.cfg, n)

    def run_chunk(self, n: int) -> None:
        if self.graphs is None:
            self._chunk(n)
        else:
            self.graphs.replay(n)

    def run(self, xa: torch.Tensor, prefix: List[int],
            blank_mask: torch.Tensor, temperature: float,
            sot_index: int = 0, no_speech_token: int = 0) -> DecodeOutput:
        """Cross K/V, prefill, first token, then the chunks, checking
        between them that every row has finished (at steps 1, 17, 33, ...:
        the eager loop's checks).  Returns copies of the results."""
        b, p, st = xa.shape[0], len(prefix), self.state
        precompute_cross_kv(self.params, xa, self.cfg, quantize=self.quantize,
                            scale_dtype=self.scale_dtype, out=self.cross)
        prefix_b = torch.tensor(prefix, dtype=torch.long,
                                device=xa.device).expand(b, p)
        prefill_logits, _ = decoder_forward(self.params, prefix_b, None,
                                            self.cfg, pos_offset=0,
                                            kv_cache=self.cache,
                                            cross_kv=self.cross)
        st.temperature.fill_(temperature)
        first = prefill_logits[:, -1, :] + self.suppress + blank_mask
        tok = _sample(first, st.temperature, self.gen)
        st.tok.copy_(tok)
        st.tokens.fill_(self.eot)
        st.tokens[:, 0] = tok
        st.finished.copy_(tok == self.eot)
        st.lengths.fill_(1)
        st.sum_lp.copy_(_logprob_of(first, tok))
        self._rewind()
        i = 1
        while i < self.max_new and not bool(st.finished.all()):
            n = min(FINISH_CHECK_EVERY, self.max_new - i)
            self.run_chunk(n)
            i += n
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

    Owns one ``DecodeLoop`` per (rows bucket, cross positions, prompt and
    token budget; the cross-K/V kind is the options'), built on first use
    as ``jax.jit`` compiles on first call: on CUDA that captures its
    chunks, all in one graph memory pool, freed with the decoder.  A
    lock keeps one decode at a time on the static buffers; a decode's
    results leave it as copies enqueued before the lock is released, on
    the default stream every decoding thread uses, so the next decode
    cannot overwrite the buffers before the copies have run.  ``eager=True``
    runs the chunks eagerly on CUDA too, for comparison only; on the CPU
    they always run eagerly.

    ``stats`` accumulates, for run reports: ``token_rows`` (rows x decode
    positions run, padding rows included), ``rung_rows`` (rows decoded at
    each rung of the temperature ladder), ``decode_calls`` (decode loops
    run: one cross-K/V and one prefill each), ``decode_steps``
    (single-token steps run over all loops) and ``capture_s`` (host
    seconds spent capturing chunks, warm-up runs included)."""

    def __init__(self, params: Params, cfg: WhisperConfig,
                 tokenizer: WhisperTokenizer, opts: DecodingOptions,
                 device: torch.device, eager: bool = False):
        if opts.beam_size > 1:
            raise NotImplementedError(
                "beam_size > 1 is not ported yet (ROADMAP Queue A item 6)")
        if not opts.without_timestamps:
            raise NotImplementedError(
                "timestamp-token decoding is not ported yet (ROADMAP Queue "
                "A item 6)")
        self.params = params
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
        self._gen = torch.Generator(device=device)
        self._loops: Dict[tuple, DecodeLoop] = {}
        self._pool = None
        self._lock = threading.Lock()
        self.stats = {"token_rows": 0, "rung_rows": collections.Counter(),
                      "decode_calls": 0, "decode_steps": 0, "capture_s": 0.0}

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

    def decode(self, xa: torch.Tensor, temperature: float = 0.0,
               rng_tag: int = 0) -> List[SegmentResult]:
        """Decode a batch of encoded segments xa [B, Ta, d] at one
        temperature; returns per-segment results with quality stats."""
        return self.decode_finalize(
            self.decode_submit(xa, temperature, rng_tag=rng_tag),
            int(xa.shape[0]), temperature)

    def decode_submit(self, xa: torch.Tensor, temperature: float = 0.0,
                      rng_tag: int = 0) -> DecodeOutput:
        """Run the decode loop; results stay on the device until
        ``decode_finalize``.  The sampling generator is seeded with
        ``opts.seed + 1000003 * rng_tag`` before the loop."""
        prefix, sot_index = self._prefix()
        max_new = min(self.opts.max_new_tokens,
                      self.cfg.n_text_ctx - len(prefix) - 1)
        rows, ta = int(xa.shape[0]), int(xa.shape[1])
        with self._lock:
            loop = self._loop(rows, ta, len(prefix), max_new)
            self._gen.manual_seed(self.opts.seed + 1000003 * rng_tag)
            out = loop.run(xa, prefix, self._blank, float(temperature),
                           sot_index=sot_index,
                           no_speech_token=self.tokenizer.special.no_speech)
            self.stats["token_rows"] += rows * out.steps
            self.stats["decode_calls"] += 1
            self.stats["decode_steps"] += out.steps - 1
        return out

    def _loop(self, rows: int, ta: int, p: int, max_new: int) -> DecodeLoop:
        key = (rows, ta, p, max_new)
        if key not in self._loops:
            if self.captured and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            loop = DecodeLoop(
                self.params, self.cfg, rows, ta, p, max_new,
                self.opts.int8_cross_kv,
                torch.bfloat16 if self.opts.ckv_scale_bf16
                else torch.float32, self._suppress,
                self.tokenizer.special.eot, self._gen, self.device,
                graphs_pool=self._pool)
            if loop.graphs is not None:
                self.stats["capture_s"] += loop.graphs.capture_s
            self._loops[key] = loop
        return self._loops[key]

    def decode_finalize(self, out: DecodeOutput, b: int,
                        temperature: float = 0.0) -> List[SegmentResult]:
        """Fetch a decode_submit result and build SegmentResults."""
        tk = self.tokenizer
        tokens = out.tokens.cpu().numpy()
        sum_lp = out.sum_logprob.cpu().numpy()
        lengths = out.lengths.cpu().numpy()
        no_speech = out.no_speech.cpu().numpy()
        results = []
        for i in range(b):
            toks = [int(t) for t in tokens[i] if t != tk.special.eot]
            text = tk.decode(toks).strip()
            # lengths counts the EOT-emitting step; a row truncated at
            # max_new without EOT gets the +1 explicitly (faster-whisper's
            # gating scale)
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
        up to the chunk batcher's power-of-two buckets."""
        from ..pipeline.chunking import _bucket_for
        temps = self.opts.temperatures or (0.0,)
        if first is None:
            first = self.decode_submit(xa, temps[0], rng_tag=rng_tag * 16)
        results = self.decode_finalize(first, int(xa.shape[0]), temps[0])
        self.stats["rung_rows"][0] += int(xa.shape[0])
        n_valid = int(xa.shape[0]) if n_valid is None else n_valid
        pending = [i for i, r in enumerate(results[:n_valid])
                   if self._needs_fallback(r)]
        for rung, temp in enumerate(temps[1:], start=1):
            if not pending:
                break
            rows = _bucket_for(len(pending), int(xa.shape[0]))
            idx = pending + [pending[0]] * (rows - len(pending))
            sub = xa[torch.tensor(idx, device=xa.device)]
            self.stats["rung_rows"][rung] += rows
            retried = self.decode(sub, temperature=temp,
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
