"""Minimal FLAC encoder (fixture maker for the native decoder; a copy of
the JAX package's ``audio/flacenc.py``).

``write_flac`` is the compressed-format sibling of ``io.write_wav``: it
produces spec-conformant FLAC streams so the native decoder
(``native/mwx_flac.cpp``) has a self-contained round-trip test on hosts
with neither ffmpeg nor a flac binary (the reference delegates all
compressed decode to ffmpeg, reference: transcribe.py:117, README.md:90).

Scope: 16-bit PCM, fixed block size, mono or stereo.  Per-subframe the
encoder picks CONSTANT where possible, else a caller-chosen predictor
(fixed order 0-2, a canned LPC, or VERBATIM) with single-partition Rice
residuals (raw-bits escape when Rice would blow up).  Stereo supports all
four channel assignments so every decoder decorrelation path is
exercised.  This is a test/fixture encoder: small and exact, not
rate-optimal.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["write_flac", "encode_flac"]


class _BitWriter:
    def __init__(self):
        self._bytes = bytearray()
        self._acc = 0
        self._nbits = 0

    def bits(self, value: int, n: int) -> None:
        value &= (1 << n) - 1 if n < 64 else (1 << 64) - 1
        self._acc = (self._acc << n) | value
        self._nbits += n
        while self._nbits >= 8:
            self._nbits -= 8
            self._bytes.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def sbits(self, value: int, n: int) -> None:
        self.bits(value & ((1 << n) - 1), n)

    def unary(self, q: int) -> None:
        while q >= 32:
            self.bits(0, 32)
            q -= 32
        self.bits(1, q + 1)

    def align(self) -> None:
        if self._nbits:
            self.bits(0, 8 - self._nbits)

    def getvalue(self) -> bytes:
        assert self._nbits == 0, "unaligned"
        return bytes(self._bytes)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


def _utf8_number(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = []
    bits_left = n.bit_length()
    n_bytes = 2
    while bits_left > 6 * (n_bytes - 1) + (7 - n_bytes) and n_bytes < 7:
        n_bytes += 1
    lead_bits = 7 - n_bytes
    shift = 6 * (n_bytes - 1)
    lead = (0xFF << (lead_bits + 1)) & 0xFF | (n >> shift)
    out.append(lead)
    for i in range(n_bytes - 2, -1, -1):
        out.append(0x80 | ((n >> (6 * i)) & 0x3F))
    return bytes(out)


_FIXED_COEFS = {0: [], 1: [1], 2: [2, -1]}
# Canned LPC predictor for decoder-path tests: order 2, shift 5,
# 6-bit coefficients (values chosen to be a stable low-pass-ish filter).
_LPC_ORDER, _LPC_SHIFT, _LPC_PREC, _LPC_COEFS = 2, 5, 6, [25, 6]


def _residual(x: np.ndarray, order: int, coefs, shift: int) -> np.ndarray:
    x = x.astype(np.int64)
    if order == 0:
        return x.copy()
    pred = np.zeros(len(x) - order, np.int64)
    for k, c in enumerate(coefs):
        pred += c * x[order - 1 - k: len(x) - 1 - k]
    if shift:
        pred >>= shift
    return x[order:] - pred


def _write_rice(bw: _BitWriter, res: np.ndarray) -> None:
    """Single-partition residual: Rice or raw-bits escape."""
    bw.bits(0, 2)   # method: RICE (4-bit params)
    bw.bits(0, 4)   # partition order 0
    u = (np.abs(res.astype(np.int64)) * 2 - (res < 0)).astype(np.uint64)
    best_param, best_cost = 0, None
    for param in range(15):
        cost = int(np.sum(u >> param)) + len(u) * (param + 1)
        if best_cost is None or cost < best_cost:
            best_param, best_cost = param, cost
    raw_bits = int(u.max()).bit_length() + 1 if len(u) and u.max() else 1
    raw_bits = min(max(raw_bits, 1), 31)
    if best_cost > raw_bits * len(u) + 5:
        bw.bits(0xF, 4)
        bw.bits(raw_bits, 5)
        for v in res:
            bw.sbits(int(v), raw_bits)
        return
    bw.bits(best_param, 4)
    for q, v in zip(u >> best_param, u):
        bw.unary(int(q))
        if best_param:
            bw.bits(int(v) & ((1 << best_param) - 1), best_param)


def _write_subframe(bw: _BitWriter, x: np.ndarray, bps: int,
                    predictor: str) -> None:
    bw.bits(0, 1)  # pad
    if np.all(x == x[0]):
        bw.bits(0, 6)       # CONSTANT
        bw.bits(0, 1)       # no wasted bits
        bw.sbits(int(x[0]), bps)
        return
    if predictor == "verbatim":
        bw.bits(1, 6)
        bw.bits(0, 1)
        for v in x:
            bw.sbits(int(v), bps)
        return
    if predictor == "lpc":
        order = _LPC_ORDER
        bw.bits(0x20 | (order - 1), 6)
        bw.bits(0, 1)
        for v in x[:order]:
            bw.sbits(int(v), bps)
        bw.bits(_LPC_PREC - 1, 4)
        bw.sbits(_LPC_SHIFT, 5)
        for c in _LPC_COEFS:
            bw.sbits(c, _LPC_PREC)
        res = _residual(x, order, _LPC_COEFS, _LPC_SHIFT)
        _write_rice(bw, res)
        return
    order = int(predictor[len("fixed"):]) if predictor.startswith("fixed") \
        else 1
    order = max(0, min(order, 2))
    if len(x) <= order:
        order = 0
    bw.bits(0x08 | order, 6)
    bw.bits(0, 1)
    for v in x[:order]:
        bw.sbits(int(v), bps)
    res = _residual(x, order, _FIXED_COEFS[order], 0)
    _write_rice(bw, res)


_BLOCK_SIZE_CODES = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5, 256: 8,
                     512: 9, 1024: 10, 2048: 11, 4096: 12, 8192: 13,
                     16384: 14, 32768: 15}
_STEREO_CODES = {"independent": None, "left_side": 8, "right_side": 9,
                 "mid_side": 10}


def encode_flac(audio: np.ndarray, sample_rate: int, *,
                block_size: int = 4096, predictor: str = "fixed1",
                stereo_mode: str = "independent") -> bytes:
    """Encode int16-range float (or int16) audio [n] or [n, 2] -> FLAC bytes.

    predictor: "fixed0" | "fixed1" | "fixed2" | "lpc" | "verbatim"
    stereo_mode (2-channel input): "independent" | "left_side" |
    "right_side" | "mid_side"
    """
    a = np.asarray(audio)
    if a.dtype.kind == "f":
        a = (np.clip(a, -1.0, 1.0) * 32767.0).round().astype(np.int32)
    else:
        a = a.astype(np.int32)
    if a.ndim == 1:
        a = a[:, None]
    n, channels = a.shape
    if channels not in (1, 2):
        raise ValueError("mono or stereo only")
    if stereo_mode not in _STEREO_CODES:
        raise ValueError(f"bad stereo_mode {stereo_mode!r}")
    bps = 16

    out = bytearray(b"fLaC")
    si = _BitWriter()
    si.bits(block_size, 16)        # min block size
    si.bits(block_size, 16)        # max block size
    si.bits(0, 24)                 # min frame size (unknown)
    si.bits(0, 24)                 # max frame size (unknown)
    si.bits(sample_rate, 20)
    si.bits(channels - 1, 3)
    si.bits(bps - 1, 5)
    si.bits(n, 36)
    si.bits(0, 64)                 # MD5 unknown
    si.bits(0, 64)
    body = si.getvalue()
    # metadata block header: last-block flag | type 0 (STREAMINFO) | len24
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    for frame_idx, start in enumerate(range(0, n, block_size)):
        blk = a[start: start + block_size]
        bs = len(blk)
        bw = _BitWriter()
        bw.bits(0x3FFE, 14)
        bw.bits(0, 1)              # reserved
        bw.bits(0, 1)              # fixed-blocksize stream
        bs_code = _BLOCK_SIZE_CODES.get(bs)
        bw.bits(bs_code if bs_code else 7, 4)
        bw.bits(0, 4)              # sample rate: from STREAMINFO
        stereo_code = _STEREO_CODES[stereo_mode] if channels == 2 else None
        bw.bits(stereo_code if stereo_code is not None else channels - 1, 4)
        bw.bits(4, 3)              # sample size: 16-bit
        bw.bits(0, 1)              # reserved
        for b in _utf8_number(frame_idx):
            bw.bits(b, 8)
        if not bs_code:
            bw.bits(bs - 1, 16)
        bw.align()
        header = bw.getvalue()
        bw = _BitWriter()
        for b in header:
            bw.bits(b, 8)
        bw.bits(_crc8(header), 8)

        if channels == 1 or stereo_code is None:
            for c in range(channels):
                _write_subframe(bw, blk[:, c], bps, predictor)
        else:
            left = blk[:, 0].astype(np.int64)
            right = blk[:, 1].astype(np.int64)
            side = left - right
            if stereo_mode == "left_side":
                subs = [(left, bps), (side, bps + 1)]
            elif stereo_mode == "right_side":
                subs = [(side, bps + 1), (right, bps)]
            else:  # mid_side
                mid = (left + right) >> 1
                subs = [(mid, bps), (side, bps + 1)]
            for x, sub_bps in subs:
                _write_subframe(bw, x, sub_bps, predictor)
        bw.align()
        frame = bw.getvalue()
        bw2 = _BitWriter()
        for b in frame:
            bw2.bits(b, 8)
        bw2.bits(_crc16(frame), 16)
        out += bw2.getvalue()

    return bytes(out)


def write_flac(path, audio: np.ndarray, sample_rate: int = 16000,
               **kwargs) -> None:
    Path(path).write_bytes(encode_flac(audio, sample_rate, **kwargs))
