"""Timestamp-token decoding, the ``without_timestamps=False`` mode (port of
the JAX ``models/timestamps.py``).

OpenAI Whisper's timestamp rules, applied at every step of the greedy
loop:

1. the first generated token must be a timestamp (at most
   ``max_initial_index`` steps of 20 ms: 1.0 s);
2. timestamps come in pairs: after a lone timestamp following text the
   next token must be a timestamp (or EOT); after a closing pair it must
   be text;
3. timestamps never decrease, and a closing timestamp inside a segment
   or right after a pair is strictly greater than the last one;
4. when the total probability mass on timestamps exceeds the best text
   token, a timestamp is forced.

JAX ``greedy_timestamps_jit`` is the greedy while loop with these rules
and argmax.  Here ``TimestampRules`` is the token choice of a
``decode.DecodeLoop`` (its ``pick``): the rules read only device state,
the last token, the one before it and the last timestamp, so the loop's
chunks are captured and replayed as the greedy ones are, running the same
decode step (K3, K4 or K5, and K6 with int8 weights).  The cache holds
prompt + max_new slots (K3 takes any length; the JAX fused path rounds it
to 128).  ``split_segments_by_timestamps`` then cuts a 30 s window into
sub-segments at the decoded pairs, on the host.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..tokenizer import WhisperTokenizer

NEG = -1e30


class TimestampRules:
    """Token choice of JAX ``greedy_timestamps_jit`` for a loop of ``rows``
    rows: the suppress mask (which must not mask the timestamps), the
    four rules, argmax.  Holds the rows' ``prev`` (the token before the
    last) and ``last_ts`` (the last timestamp) on the device."""

    gen = None          # draws no random numbers

    def __init__(self, suppress_mask: torch.Tensor, eot: int,
                 ts_begin: int, rows: int, device: torch.device,
                 max_initial_index: int = 50):
        self.suppress, self.eot, self.ts_begin = suppress_mask, eot, ts_begin
        self.max_initial_index = max_initial_index
        ids = torch.arange(suppress_mask.shape[0], device=device)
        self.ids = ids
        self.is_ts = ids >= ts_begin
        zero = torch.zeros((), device=device)
        neg = torch.full((), NEG, device=device)
        # additive masks: after a lone timestamp only timestamps and EOT;
        # after a closed pair no timestamp
        self.text_mask = torch.where(self.is_ts | (ids == eot), zero, neg)
        self.ts_mask = torch.where(self.is_ts, neg, zero)
        self.prev = torch.zeros(rows, dtype=torch.long, device=device)
        self.last_ts = torch.zeros(rows, dtype=torch.long, device=device)

    def first(self, logits: torch.Tensor, st):
        """Prefill logits [B, V] -> (first token, its logprob): a timestamp
        no later than ``ts_begin + max_initial_index``."""
        first = logits + self.suppress
        first = torch.where(self.is_ts, first, NEG)
        first = torch.where(self.ids > self.ts_begin + self.max_initial_index,
                            NEG, first)
        tok = first.argmax(dim=-1)
        lp = torch.log_softmax(first, dim=-1).gather(1, tok[:, None])[:, 0]
        # the token before the first counts as a timestamp (OpenAI: a
        # sequence shorter than 2 has penultimate_was_timestamp), so text
        # follows the opening timestamp
        self.prev.fill_(self.ts_begin)
        self.last_ts.copy_(tok)
        return tok, lp

    def apply_rules(self, logits: torch.Tensor, last: torch.Tensor
                    ) -> torch.Tensor:
        """logits [B, V] after ``last`` -> the logits the four rules leave."""
        logits = logits + self.suppress
        last_is_ts = last >= self.ts_begin
        prev_is_ts = self.prev >= self.ts_begin
        lone = last_is_ts & ~prev_is_ts
        closed = last_is_ts & prev_is_ts
        logits = torch.where(lone[:, None], logits + self.text_mask, logits)
        logits = torch.where(closed[:, None], logits + self.ts_mask, logits)
        # monotonic timestamps: after a lone timestamp the closing one may
        # equal it; everywhere else the next must be strictly greater, or
        # the model can loop on zero-duration segments
        cutoff = torch.where(lone, self.last_ts, self.last_ts + 1)
        logits = logits + torch.where(
            self.is_ts & (self.ids < cutoff[:, None]), NEG, 0.0)
        logp = torch.log_softmax(logits, dim=-1)
        ts_mass = torch.logsumexp(torch.where(self.is_ts, logp, NEG), dim=-1)
        best_text = torch.where(self.is_ts, NEG, logp).amax(dim=-1)
        force_ts = ts_mass > best_text
        return torch.where(force_ts[:, None] & ~self.is_ts, NEG, logits)

    def step(self, logits: torch.Tensor, st):
        logits = self.apply_rules(logits, st.tok)
        return logits, logits.argmax(dim=-1)

    def advance(self, st, nxt: torch.Tensor) -> None:
        self.last_ts.copy_(torch.where(nxt >= self.ts_begin, nxt,
                                       self.last_ts))
        self.prev.copy_(st.tok)


def split_segments_by_timestamps(tokens: np.ndarray,
                                 tokenizer: WhisperTokenizer,
                                 chunk_start: float,
                                 chunk_duration: float) -> List[dict]:
    """Token stream with timestamp tokens -> [{text, start, end}].

    Consecutive ``<|t0|> text <|t1|>`` spans become segments offset by
    ``chunk_start``; an unterminated trailing span closes at the chunk end.
    """
    sp = tokenizer.special
    segments: List[dict] = []
    current_text: List[int] = []
    start_time = None

    def clamp(t: float) -> float:
        return min(max(t, 0.0), chunk_duration)
    for t in (int(x) for x in tokens):
        if t == sp.eot:
            break
        if t >= sp.timestamp_begin:
            ts = tokenizer.timestamp_from_token(t)
            if start_time is None or not current_text:
                start_time = ts
                current_text = []
            else:
                text = tokenizer.decode(current_text).strip()
                if text:
                    segments.append({
                        "text": text,
                        "start": round(chunk_start + clamp(start_time), 3),
                        "end": round(chunk_start + clamp(ts), 3),
                    })
                start_time = ts
                current_text = []
        elif t < sp.eot:
            current_text.append(t)
    if current_text and start_time is not None:
        text = tokenizer.decode(current_text).strip()
        if text:
            segments.append({
                "text": text,
                "start": round(chunk_start + clamp(start_time), 3),
                "end": round(chunk_start + chunk_duration, 3),
            })
    return segments
