"""FLAC encoder (pure Python/numpy): fixed predictors + rice coding.

A copy of `rvc_maker_tpu/utils/flac_enc.py`, so that the port writes the
same bytes.  Gives `--export-format flac` (reference convert.py writes
flac/ogg/m4a through soundfile, which needs libsndfile).  Spec subset chosen
for simplicity + good ratio on speech: per-frame best fixed predictor
(order 0-4, minimum-sum-of-abs-residual heuristic), one rice partition
per subframe with the standard mean-based parameter estimate,
independent channels.  Decodes bit-exactly with our native decoder
(native/src/flacdec.cpp) and any conforming FLAC decoder.
"""

from __future__ import annotations

import numpy as np

_BLOCK = 4096
_FIXED_COEFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, nbits: int):
        acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        nbits += self.nbits
        while nbits >= 8:
            nbits -= 8
            self.out.append((acc >> nbits) & 0xFF)
        self.acc = acc & ((1 << nbits) - 1)
        self.nbits = nbits

    def write_signed(self, value: int, nbits: int):
        self.write(value & ((1 << nbits) - 1), nbits)

    def write_unary(self, q: int):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)


def _residual(s: np.ndarray, order: int) -> np.ndarray:
    r = s.astype(np.int64)
    for _ in range(order):
        r = np.diff(r)           # order-n fixed predictor == nth difference
    return r


def _rice_param(resid: np.ndarray) -> int:
    if len(resid) == 0:
        return 0
    mean = float(np.mean(np.abs(resid)))
    p = 0
    while (1 << p) < mean and p < 14:
        p += 1
    return p


def _write_rice_block(bw: _BitWriter, resid: np.ndarray, param: int):
    u = np.where(resid >= 0, 2 * resid, -2 * resid - 1).astype(np.int64)
    mask = (1 << param) - 1
    for v in u.tolist():
        bw.write_unary(int(v) >> param)
        if param:
            bw.write(int(v) & mask, param)


def _encode_subframe(bw: _BitWriter, s: np.ndarray, bps: int):
    # constant short-circuit
    if np.all(s == s[0]):
        bw.write(0, 1)
        bw.write(0, 6)
        bw.write(0, 1)
        bw.write_signed(int(s[0]), bps)
        return
    best_order, best_cost, best_resid = 0, None, None
    max_order = min(4, len(s) - 1)
    for order in range(max_order + 1):
        resid = _residual(s, order)
        cost = int(np.sum(np.abs(resid)))
        if best_cost is None or cost < best_cost:
            best_order, best_cost, best_resid = order, cost, resid
    order, resid = best_order, best_resid

    bw.write(0, 1)
    bw.write(8 + order, 6)       # FIXED subframe
    bw.write(0, 1)               # no wasted bits
    for v in s[:order].tolist():
        bw.write_signed(int(v), bps)
    param = _rice_param(resid)
    bw.write(0, 2)               # rice method 0
    bw.write(0, 4)               # partition order 0
    bw.write(param, 4)
    _write_rice_block(bw, resid, param)


def _utf8_number(bw: _BitWriter, n: int):
    if n < 0x80:
        bw.write(n, 8)
        return
    octets = []
    bits = n.bit_length()
    count = 2
    while bits > 6 * (count - 1) + (7 - count):
        count += 1
    for i in range(count - 1):
        octets.append(0x80 | ((n >> (6 * i)) & 0x3F))
    lead = ((0xFF << (8 - count)) & 0xFF) | (n >> (6 * (count - 1)))
    bw.write(lead, 8)
    for o in reversed(octets):
        bw.write(o, 8)


_CRC8_TABLE = None
_CRC16_TABLE = None


def _crc_tables():
    global _CRC8_TABLE, _CRC16_TABLE
    if _CRC8_TABLE is None:
        t8 = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
            t8.append(c)
        _CRC8_TABLE = t8
        t16 = []
        for i in range(256):
            c = i << 8
            for _ in range(8):
                c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 else (c << 1) & 0xFFFF
            t16.append(c)
        _CRC16_TABLE = t16
    return _CRC8_TABLE, _CRC16_TABLE


def _crc8(data: bytes) -> int:
    t8, _ = _crc_tables()
    c = 0
    for b in data:
        c = t8[c ^ b]
    return c


def _crc16(data: bytes) -> int:
    _, t16 = _crc_tables()
    c = 0
    for b in data:
        c = t16[((c >> 8) ^ b) & 0xFF] ^ ((c << 8) & 0xFFFF)
    return c


def encode_flac(audio: np.ndarray, sr: int, bps: int = 16) -> bytes:
    """audio: float in [-1, 1], (T,) or (T, C<=2) -> FLAC stream bytes."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[:, None]
    T, C = audio.shape
    scale = float(1 << (bps - 1))
    pcm = np.clip(np.round(audio * scale), -scale, scale - 1).astype(np.int64)

    head = _BitWriter()
    head.write(1, 1)
    head.write(0, 7)
    head.write(34, 24)
    head.write(_BLOCK, 16)
    head.write(_BLOCK, 16)
    head.write(0, 24)
    head.write(0, 24)
    head.write(sr, 20)
    head.write(C - 1, 3)
    head.write(bps - 1, 5)
    head.write(T & ((1 << 36) - 1), 36)
    for _ in range(16):
        head.write(0, 8)

    bps_code = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}[bps]
    out = bytearray(b"fLaC" + head.out)
    for fno, start in enumerate(range(0, max(T, 1), _BLOCK)):
        block = pcm[start:start + _BLOCK]
        n = len(block)
        bw = _BitWriter()
        bw.write(0x3FFE, 14)
        bw.write(0, 1)
        bw.write(0, 1)           # fixed blocksize stream
        bw.write(7, 4)           # 16-bit blocksize-1 follows
        bw.write(0, 4)           # sr from streaminfo
        bw.write(C - 1, 4)       # independent channels
        bw.write(bps_code, 3)
        bw.write(0, 1)
        _utf8_number(bw, fno)
        bw.write(n - 1, 16)
        bw.align()
        header = bytes(bw.out)
        bw.write(_crc8(header), 8)
        for ch in range(C):
            _encode_subframe(bw, block[:, ch], bps)
        bw.align()
        frame = bytes(bw.out)
        bw.write(_crc16(frame), 16)
        out.extend(bw.out)
    return bytes(out)


def write_flac(path: str, audio: np.ndarray, sr: int, bps: int = 16) -> str:
    with open(path, "wb") as f:
        f.write(encode_flac(audio, sr, bps))
    return path
