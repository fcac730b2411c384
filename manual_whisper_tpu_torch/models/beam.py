"""Batched beam search (port of the JAX ``models/beam.py``).

The JAX search is one compiled program: prefill, then a ``lax.while_loop``
of (step, top-k, ancestry update).  Here it is a ``BeamLoop`` over static
buffers, shaped like ``decode.DecodeLoop``: cross K/V and prefill over the
B rows run eagerly once a loop, then chunks of FINISH_CHECK_EVERY beam
steps (``beam_chunk``) that read and write only device tensors; on CUDA
each chunk is a captured CUDA graph, replayed (``graphs.ChunkGraphs``), on
the CPU it runs eagerly.  The host checks between chunks that every
hypothesis has finished.

The JAX math is kept as it is:

- the cross K/V of a row is shared by its K beams (attention of K
  queries to one K/V, ``_beam_cross_attend``);
- the self cache is append-only, per layer [B, K, H, T, dh] (the port's
  [.., T, dh] order): beam k writes its step's K/V into slot k, and each
  beam carries an ancestry row ``anc[B, K, T]`` (which slot holds its
  token at time t) that folds into the attention as a one-hot contraction
  over the K parent slots (``_beam_block``);
- the attentions are plain ``torch.matmul`` products (einsums in JAX,
  which never runs the fused decode kernels for beam), so the beam step
  launches no K3, K4 or K5; its block matmuls go through ``mm``, so with
  int8 weights each launches K6 at M = B * K;
- top-k breaks ties as ``jax.lax.top_k`` does (the lower index first),
  ``argmax`` takes the first maximum as ``jnp.argmax`` does;
- finished hypotheses are set aside outside the beam every step and
  compete in the final selection by ``sum_logprob / length **
  length_penalty`` (CT2's and OpenAI's semantics).
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from .decode import ChunkedLoop, DecodeOutput
from .whisper import (Params, WhisperConfig, _layer_norm, _mlp,
                      alloc_cross_kv, decoder_forward, init_kv_cache,
                      local_heads, logits_f32, precompute_cross_kv)
from ..ops.decode_attention import attend_plain
from ..ops.quant import mm
from ..parallel.mesh import reduce_from_model
from ..spans import span

NEG_INF = -1e30


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis of float32 ``x``: the k largest
    in descending order, equal values at the lower index first (torch.topk
    promises no order among ties).  Each value is mapped to an int64 key
    that orders as the float's total order does (-0.0 below +0.0, as in
    JAX) in its high 32 bits and ranks the lower index higher in its low
    32 bits, so no two keys tie.  Returns (values, indices)."""
    bits = x.view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    low = (2 ** 32 - 1) - torch.arange(x.shape[-1], device=x.device)
    idx = (ordered * 2 ** 32 + low).topk(k, dim=-1).indices
    return x.gather(-1, idx), idx


def norm_score(cum: torch.Tensor, length: torch.Tensor,
               length_penalty: float) -> torch.Tensor:
    """Length-normalised score: cum / max(length, 1) ** length_penalty."""
    return cum / torch.clamp_min(length.float(), 1.0) ** length_penalty


def _beam_cross_attend(xq: torch.Tensor, xkv, dh: int) -> torch.Tensor:
    """Cross attention of the K beams of each row to the row's shared cross
    K/V; xq [B, K, H, dh]; xkv the layer's (k, v) [B, H, Ta, dh] or the
    int8 (k_q, k_s, v_q, v_s).  JAX ``_beam_cross_attend``: f32 scores
    (for int8, times the K scales, then 1/sqrt(dh)), f32 softmax, the
    probabilities (for int8, times the V scales) in q's dtype times V in
    q's dtype.  Returns [B, K, H, dh]."""
    xq_h = xq.transpose(1, 2)                          # [B, H, K, dh]
    if len(xkv) == 2:
        return attend_plain(xq_h, *xkv).transpose(1, 2)
    k_q, k_s, v_q, v_s = xkv
    s = xq_h.float() @ k_q.float().transpose(-1, -2)   # [B, H, K, Ta]
    s = s * k_s.float()[:, :, None, :] * dh ** -0.5
    p = torch.softmax(s, dim=-1) * v_s.float()[:, :, None, :]
    return (p.to(xq.dtype) @ v_q.to(xq.dtype)).transpose(1, 2)


def _beam_block(h, blk, ck, cv, valid, xkv, slot, oh, group=None):
    """One decoder block for beam-shaped activations h [B, K, d].

    ck/cv: the layer's self cache [B, K, H, T, dh] (H the rank's heads on
    tensor-parallel shards, whose o and fc2 outputs are reduced over
    ``group``); slot k at ``slot`` (a
    one-element int64 tensor) takes beam k's new K/V.  ``valid`` [T] bool
    marks the slots <= the step's position.  ``oh`` [B, K, J, T] f32:
    oh[b, k, j, t] = 1 iff beam k's token at time t lives in slot j (the
    lazy beam reorder).  Scores against every parent slot j, then the
    one-hot picks the ancestor's (JAX ``_beam_block``: ``bkhd,bjhdt->
    bkjht``, ``bkjht,bkjt->bkht``, ``bkjht,bjhdt->bkhd``)."""
    b, k, _ = h.shape
    n_head, dh = ck.shape[2], ck.shape[-1]

    def heads(y):                          # [B, K, d] -> [B, K, H, dh]
        return y.reshape(b, k, n_head, dh)

    att = blk["attn"]
    a_in = _layer_norm(h, blk["ln1"])
    q = heads(mm(a_in, att["q_w"]) + att["q_b"])
    ck.index_copy_(3, slot, heads(mm(a_in, att["k_w"]))[:, :, :, None]
                   .to(ck.dtype))
    cv.index_copy_(3, slot, heads(mm(a_in, att["v_w"]) + att["v_b"])
                   [:, :, :, None].to(cv.dtype))
    t = ck.shape[3]
    # [B, H, K, dh] . [B, H, J*T, dh] -> [B, H, K, J, T], f32 products
    k_f = ck.transpose(1, 2).to(torch.float32,
                                memory_format=torch.contiguous_format)
    s_all = (q.transpose(1, 2).float()
             @ k_f.reshape(b, n_head, k * t, dh).transpose(-1, -2)
             ).reshape(b, n_head, k, k, t) * dh ** -0.5
    oh_h = oh[:, None]                                 # [B, 1, K, J, T]
    scores = (s_all * oh_h).sum(3)                     # [B, H, K, T]
    scores = scores.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    probs_j = probs[:, :, :, None, :] * oh_h.to(q.dtype)   # [B, H, K, J, T]
    v_p = cv.transpose(1, 2).contiguous().reshape(b, n_head, k * t, dh)
    attn = (probs_j.reshape(b, n_head, k, k * t) @ v_p)    # [B, H, K, dh]
    attn = attn.transpose(1, 2).reshape(b, k, n_head * dh)
    h = h + (reduce_from_model(mm(attn, att["o_w"]), group) + att["o_b"])

    xat = blk["xattn"]
    x_in = _layer_norm(h, blk["lnx"])
    xq = heads(mm(x_in, xat["q_w"]) + xat["q_b"])
    xattn = _beam_cross_attend(xq, xkv, dh).reshape(b, k, n_head * dh)
    h = h + (reduce_from_model(mm(xattn, xat["o_w"]), group) + xat["o_b"])
    return h + _mlp(_layer_norm(h, blk["ln2"]), blk["mlp"], group)


def beam_step(params: Params, cfg: WhisperConfig, token: torch.Tensor,
              pos: torch.Tensor, cache, cross_kv, oh: torch.Tensor,
              valid: torch.Tensor, tok_emb_f32: torch.Tensor,
              group=None) -> torch.Tensor:
    """token [B, K] at position ``pos`` (one int32 on the device) ->
    logits [B, K, V] f32, every layer's self cache written at ``pos`` in
    place (JAX ``_beam_step``).  ``cache``: per-layer (k, v) lists of
    [B, K, H, T, dh]; ``cross_kv``: per-layer cross K/V of the B rows;
    ``oh`` [B, K, J, T], ``valid`` [T] and ``group`` as ``_beam_block``
    takes them."""
    dec = params["decoder"]
    x = dec["tok_emb"][token] + dec["pos_emb"].index_select(0, pos)
    h = x.to(cfg.dtype)                                # [B, K, d]
    slot = pos.long()
    for blk, ck, cv, xkv in zip(dec["blocks"], cache[0], cache[1],
                                cross_kv):
        h = _beam_block(h, blk, ck, cv, valid, xkv, slot, oh, group)
    return logits_f32(_layer_norm(h, dec["ln"]), tok_emb_f32)


@dataclasses.dataclass
class BeamState:
    """What the beam steps read and write, all on the device: the K
    hypotheses of each row (``tokens`` [B, K, max_new], ``last``,
    ``finished``, ``cum_lp``, ``lengths``, ancestry ``anc`` [B, K, T]), the
    best finished hypothesis set aside per row (``fin_*``), the tokens slot
    ``i`` of the next step and its cache slot ``pos`` (p + i - 1)."""
    tokens: torch.Tensor
    last: torch.Tensor
    finished: torch.Tensor
    cum_lp: torch.Tensor
    lengths: torch.Tensor
    anc: torch.Tensor
    fin_score: torch.Tensor
    fin_tokens: torch.Tensor
    fin_lp: torch.Tensor
    fin_len: torch.Tensor
    i: torch.Tensor
    pos: torch.Tensor

    @classmethod
    def zeros(cls, rows: int, beams: int, max_new: int, t: int,
              device: torch.device) -> "BeamState":
        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)
        bk = (rows, beams)
        return cls(z(bk + (max_new,), torch.long), z(bk, torch.long),
                   z(bk, torch.bool), z(bk, torch.float32),
                   z(bk, torch.int32), z(bk + (t,), torch.long),
                   z(rows, torch.float32), z((rows, max_new), torch.long),
                   z(rows, torch.float32), z(rows, torch.int32),
                   z(1, torch.int32), z(1, torch.int32))


class BeamLoop(ChunkedLoop):
    """Beam search over static buffers for one shape: ``rows`` batch rows
    of ``beams`` hypotheses, ``ta`` cross positions, a prompt of ``p``
    tokens, ``max_new`` tokens, one cross-K/V kind (bf16, or int8 with
    ``scale_dtype`` scales).  Buffers: the cross K/V of the B rows, the
    self cache (per layer [B, K, H, p + max_new, dh]) and the
    ``BeamState``; each run overwrites all it reads (the slots past the
    position are masked).  With ``graphs_pool`` the chunks of beam steps
    are captured when the loop is built and replayed after; without it
    ``beam_chunk`` runs eagerly.  Cross K/V and the B-row prefill run
    eagerly, once a loop; the prefill's cache is tiled to the K beams.
    ``group``: the model group of tensor-parallel shards."""

    def __init__(self, params: Params, cfg: WhisperConfig, rows: int,
                 beams: int, ta: int, p: int, max_new: int, quantize: bool,
                 scale_dtype: torch.dtype, suppress_mask: torch.Tensor,
                 eot: int, length_penalty: float, device: torch.device,
                 graphs_pool=None, group=None):
        self.params, self.cfg, self.group = params, cfg, group
        self.beams, self.p, self.max_new = beams, p, max_new
        self.quantize, self.scale_dtype = quantize, scale_dtype
        self.suppress, self.eot = suppress_mask, eot
        self.length_penalty = length_penalty
        t = p + max_new
        heads = local_heads(params, "decoder", cfg)
        self.cache = init_kv_cache(cfg, rows * beams, t, device, heads=heads)
        shape = (rows, beams) + self.cache[0][0].shape[1:]
        self.cache = tuple([c.view(shape) for c in layers]
                           for layers in self.cache)
        self.cross = alloc_cross_kv(cfg, rows, ta, device, quantize,
                                    scale_dtype, heads=heads)
        self.state = BeamState.zeros(rows, beams, max_new, t, device)
        self.tok_emb_f32 = params["decoder"]["tok_emb"].float()
        self.k_ids = torch.arange(beams, device=device)
        self.t_ids = torch.arange(t, device=device)
        self.frozen = torch.full((cfg.n_vocab,), NEG_INF, device=device)
        self.frozen[eot] = 0.0
        self._capture(device, None, graphs_pool)

    def _chunk(self, n: int) -> None:
        beam_chunk(self, n)

    def run(self, xa: torch.Tensor, prefix: List[int],
            blank_mask: torch.Tensor, sot_index: int = 0,
            no_speech_token: int = 0) -> DecodeOutput:
        """Cross K/V, the B-row prefill tiled to the K beams, the first top-k,
        then the chunks, checking between them that every hypothesis has
        finished; then the length-normalised selection against the set-aside
        finished hypothesis (JAX ``beam_decode_jit``).  Returns the best
        hypothesis of each row: tokens [B, max_new], summed logprob, length,
        and the no-speech probability at the SOT slot."""
        b, p, st, k = xa.shape[0], len(prefix), self.state, self.beams
        eot, lp_pow = self.eot, self.length_penalty
        with span("decode.cross_kv"):
            precompute_cross_kv(self.params, xa, self.cfg,
                                quantize=self.quantize,
                                scale_dtype=self.scale_dtype, out=self.cross,
                                group=self.group)
        with span("decode.prepare"):
            prefix_b = torch.tensor(prefix, dtype=torch.long,
                                    device=xa.device).expand(b, p)
        with span("decode.prefill"):
            pre_cache = init_kv_cache(self.cfg, b, p, xa.device,
                                      heads=self.cache[0][0].shape[2])
            prefill_logits, _ = decoder_forward(self.params, prefix_b, None,
                                                self.cfg, pos_offset=0,
                                                kv_cache=pre_cache,
                                                cross_kv=self.cross,
                                                group=self.group)
            for layers, pre in zip(self.cache, pre_cache):
                for c, c0 in zip(layers, pre):
                    c[:, :, :, :p].copy_(c0[:, None])
            del pre_cache
            first = torch.log_softmax(
                prefill_logits[:, -1, :] + self.suppress + blank_mask, dim=-1)
            top_lp, top_tok = top_k(first, k)
            st.tokens.fill_(eot)
            st.tokens[:, :, 0] = top_tok
            st.last.copy_(top_tok)
            st.finished.copy_(top_tok == eot)
            st.cum_lp.copy_(top_lp)
            st.lengths.fill_(1)
            # every slot holds the same prefill for t < p; beam k's first token
            # goes to its own slot k at t = p
            st.anc.copy_(self.k_ids[None, :, None].expand_as(st.anc))
            first_eot = first[:, eot]
            ones = torch.ones_like(st.fin_len)
            st.fin_score.copy_(torch.where(
                first_eot > NEG_INF / 2, norm_score(first_eot, ones, lp_pow),
                torch.full_like(first_eot, NEG_INF)))
            st.fin_tokens.fill_(eot)
            st.fin_lp.copy_(first_eot)
            st.fin_len.fill_(1)
        i = self._run_chunks(st.finished)

        score = norm_score(st.cum_lp, st.lengths, lp_pow)
        best = score.argmax(dim=1, keepdim=True)           # [B, 1]
        best_tokens = st.tokens.gather(
            1, best[:, :, None].expand(-1, 1, self.max_new))[:, 0]
        best_lp = st.cum_lp.gather(1, best)[:, 0]
        best_len = st.lengths.gather(1, best)[:, 0]
        fin_wins = st.fin_score > score.gather(1, best)[:, 0]
        no_speech = torch.softmax(prefill_logits[:, sot_index, :], dim=-1)[
            :, no_speech_token]
        return DecodeOutput(
            torch.where(fin_wins[:, None], st.fin_tokens, best_tokens),
            torch.where(fin_wins, st.fin_lp, best_lp),
            torch.where(fin_wins, st.fin_len, best_len), no_speech, i)


def beam_chunk(loop: BeamLoop, n_steps: int) -> None:
    """``n_steps`` beam steps over ``loop.state`` in place (the body of JAX
    ``beam_decode_jit``'s while loop, unrolled n times): step, set-aside of
    the best EOT continuation, top-k over the K x V candidates, ancestry
    update.  Reads and writes only device tensors, so on CUDA its capture
    replays at any position.  Steps after every hypothesis has finished
    change nothing: frozen hypotheses re-score as they finished, and the
    top-k keeps their order."""
    st, k, eot = loop.state, loop.beams, loop.eot
    b, max_new, t = st.tokens.shape[0], loop.max_new, st.anc.shape[2]
    vocab = loop.cfg.n_vocab
    here = loop.k_ids[None, :, None].expand(b, k, 1)
    for _ in range(n_steps):
        # beam k writes this step's K/V into its own slot k
        st.anc.index_copy_(2, st.pos.long(), here)
        oh = (st.anc[:, :, None, :] == loop.k_ids[None, None, :, None]
              ).float()                                  # [B, K, J, T]
        logits = beam_step(loop.params, loop.cfg, st.last, st.pos,
                           loop.cache, loop.cross, oh,
                           loop.t_ids <= st.pos, loop.tok_emb_f32,
                           loop.group)
        logp = torch.log_softmax(logits + loop.suppress, dim=-1)
        # finished beams: only the EOT continuation, at zero cost
        logp = torch.where(st.finished[:, :, None], loop.frozen, logp)

        # every parent's EOT continuation competes with the set-aside best
        eot_cum = st.cum_lp + logp[:, :, eot]                  # [B, K]
        eot_len = st.lengths + (~st.finished).to(torch.int32)
        eot_score = norm_score(eot_cum, eot_len, loop.length_penalty)
        k_best = eot_score.argmax(dim=1, keepdim=True)         # [B, 1]
        row_score = eot_score.amax(dim=1)
        improve = row_score > st.fin_score
        parent = st.tokens.gather(
            1, k_best[:, :, None].expand(-1, 1, max_new))[:, 0]
        st.fin_tokens.copy_(torch.where(improve[:, None], parent,
                                        st.fin_tokens))
        st.fin_lp.copy_(torch.where(improve, eot_cum.gather(1, k_best)[:, 0],
                                    st.fin_lp))
        st.fin_len.copy_(torch.where(improve, eot_len.gather(1, k_best)[:, 0],
                                     st.fin_len))
        st.fin_score.copy_(torch.where(improve, row_score, st.fin_score))

        cand = (st.cum_lp[:, :, None] + logp).reshape(b, k * vocab)
        new_cum, idx = top_k(cand, k)                          # [B, K]
        beam_idx = idx // vocab
        tok = idx % vocab
        tokens = st.tokens.gather(1, beam_idx[:, :, None].expand(
            -1, -1, max_new))
        tokens.index_copy_(2, st.i.long(), tok[:, :, None])
        st.tokens.copy_(tokens)
        finished = st.finished.gather(1, beam_idx)
        lengths = st.lengths.gather(1, beam_idx) + (~finished).to(torch.int32)
        # the cache is not re-gathered: survivors inherit their parent's
        # ancestry row
        st.anc.copy_(st.anc.gather(1, beam_idx[:, :, None].expand(-1, -1, t)))
        st.lengths.copy_(lengths)
        st.finished.copy_(finished | (tok == eot))
        st.cum_lp.copy_(new_cum)
        st.last.copy_(tok)
        st.i += 1
        st.pos += 1
