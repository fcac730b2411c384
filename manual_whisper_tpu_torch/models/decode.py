"""Batched greedy Whisper decoding (port of the JAX ``models/decode.py``).

- ``greedy_decode``: prefill over the prompt, then single-token steps over
  a preallocated KV cache, the whole batch in lockstep; finished rows emit
  EOT and stop counting.  Returns tokens, summed logprobs, lengths and the
  no-speech probability at the SOT slot, all on the device.
- ``BatchDecoder``: prompt building, the quality gates (compression ratio,
  avg logprob, no-speech) and the temperature fallback ladder on the host.

At temperature > 0 tokens are drawn with the Gumbel trick from a
``torch.Generator`` seeded by ``opts.seed + 1000003 * rng_tag``: the same
seed gives the same tokens, but not JAX's tokens (other random numbers).

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
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..tokenizer import WhisperTokenizer
from .whisper import (Params, StepLengths, WhisperConfig, decode_step,
                      decoder_forward, init_kv_cache, precompute_cross_kv)

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


def _sample(logits: torch.Tensor, temperature: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    if temperature <= 0:
        return logits.argmax(dim=-1)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = u * (1.0 - 1e-9) + 1e-9                          # [1e-9, 1)
    gumbel = -torch.log(-torch.log(u))
    return (logits / max(temperature, 1e-6) + gumbel).argmax(dim=-1)


def _logprob_of(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(1, tok[:, None])[:, 0]


@dataclasses.dataclass
class DecodeOutput:
    """Device results of one ``greedy_decode`` call."""
    tokens: torch.Tensor          # [B, max_new] int64, EOT-filled
    sum_logprob: torch.Tensor     # [B] f32
    lengths: torch.Tensor         # [B] int32 (counts the EOT step)
    no_speech: torch.Tensor       # [B] f32
    steps: int                    # decode positions run (prefill token + steps)


def greedy_decode(params: Params, xa: torch.Tensor, prefix: List[int],
                  suppress_mask: torch.Tensor, blank_mask: torch.Tensor,
                  temperature: float, gen: Optional[torch.Generator],
                  eot: int, cfg: WhisperConfig, max_new: int,
                  sot_index: int = 0, no_speech_token: int = 0,
                  int8_cross_kv: bool = False, ckv_scale_bf16: bool = False
                  ) -> DecodeOutput:
    """Prefill + decode loop over encoder states xa [B, Ta, d] with a
    prompt shared by the batch (JAX ``greedy_decode_jit``)."""
    b, ta = xa.shape[0], xa.shape[1]
    p = len(prefix)
    dev = xa.device
    cross_kv = precompute_cross_kv(
        params, xa, cfg, quantize=int8_cross_kv,
        scale_dtype=torch.bfloat16 if ckv_scale_bf16 else torch.float32)
    cache = init_kv_cache(cfg, b, p + max_new, dev)
    prefix_b = torch.tensor(prefix, dtype=torch.long, device=dev).expand(b, p)
    prefill_logits, cache = decoder_forward(params, prefix_b, None, cfg,
                                            pos_offset=0, kv_cache=cache,
                                            cross_kv=cross_kv)
    first = prefill_logits[:, -1, :] + suppress_mask + blank_mask
    tok = _sample(first, temperature, gen)
    sum_lp = _logprob_of(first, tok)
    tokens = torch.full((b, max_new), eot, dtype=torch.long, device=dev)
    tokens[:, 0] = tok
    finished = tok == eot
    lengths = torch.ones(b, dtype=torch.int32, device=dev)

    # device-side positions: step i reads slice [p+i-1] (no host->device
    # copy per step); the cross length is fixed for the batch
    positions = torch.arange(p + max_new, dtype=torch.int32, device=dev)
    cross_len = torch.full((1,), ta, dtype=torch.int32, device=dev)
    tok_emb_f32 = params["decoder"]["tok_emb"].float()
    i = 1
    while i < max_new:
        if (i - 1) % FINISH_CHECK_EVERY == 0 and bool(finished.all()):
            break
        pos = p + i - 1
        logits = decode_step(params, tok, pos,
                             StepLengths(positions[pos:pos + 1], cross_len),
                             cache, cross_kv, cfg, tok_emb_f32)
        logits = logits + suppress_mask
        nxt = _sample(logits, temperature, gen)
        nxt = torch.where(finished, torch.full_like(nxt, eot), nxt)
        lp = torch.where(finished, torch.zeros_like(sum_lp),
                         _logprob_of(logits, nxt))
        tokens[:, i] = nxt
        lengths += (~finished).to(torch.int32)
        finished = finished | (nxt == eot)
        sum_lp = sum_lp + lp
        tok = nxt
        i += 1

    no_speech = torch.softmax(prefill_logits[:, sot_index, :], dim=-1)[
        :, no_speech_token]
    return DecodeOutput(tokens, sum_lp, lengths, no_speech, i)


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

    ``stats`` accumulates, for run reports: ``token_rows`` (rows x decode
    positions run, padding rows included), ``rung_rows`` (rows decoded at
    each rung of the temperature ladder), ``decode_calls`` (decode loops
    run: one cross-K/V and one prefill each) and ``decode_steps``
    (single-token steps run over all loops)."""

    def __init__(self, params: Params, cfg: WhisperConfig,
                 tokenizer: WhisperTokenizer, opts: DecodingOptions,
                 device: torch.device):
        if opts.beam_size > 1:
            raise NotImplementedError(
                "beam_size > 1 is not ported yet (ROADMAP Queue A item 9)")
        if not opts.without_timestamps:
            raise NotImplementedError(
                "timestamp-token decoding is not ported yet (ROADMAP Queue "
                "A item 9)")
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.opts = opts
        self.device = device
        self._suppress = torch.from_numpy(
            build_suppress_mask(tokenizer, cfg, opts)).to(device)
        self._blank = (torch.from_numpy(build_blank_mask(tokenizer, cfg))
                       .to(device) if opts.suppress_blank
                       else torch.zeros(cfg.n_vocab, device=device))
        self.stats = {"token_rows": 0, "rung_rows": collections.Counter(),
                      "decode_calls": 0, "decode_steps": 0}

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
        ``decode_finalize``."""
        prefix, sot_index = self._prefix()
        max_new = min(self.opts.max_new_tokens,
                      self.cfg.n_text_ctx - len(prefix) - 1)
        gen = None
        if temperature > 0:
            gen = torch.Generator(device=xa.device)
            gen.manual_seed(self.opts.seed + 1000003 * rng_tag)
        out = greedy_decode(
            self.params, xa, prefix, self._suppress, self._blank,
            float(temperature), gen, self.tokenizer.special.eot, self.cfg,
            max_new, sot_index=sot_index,
            no_speech_token=self.tokenizer.special.no_speech,
            int8_cross_kv=self.opts.int8_cross_kv,
            ckv_scale_bf16=self.opts.ckv_scale_bf16)
        self.stats["token_rows"] += int(xa.shape[0]) * out.steps
        self.stats["decode_calls"] += 1
        self.stats["decode_steps"] += out.steps - 1
        return out

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
