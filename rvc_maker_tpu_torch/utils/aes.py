"""AES-128 in numpy (FIPS-197), for the mega.nz downloader.

The JAX package's `utils/scrapers.py` runs mega's ciphers on the
`cryptography` package, which the card's machine does not have.  This
module is the cipher itself: the S-box built from its GF(2^8)
definition, the key schedule, and the rounds as table lookups over a
(blocks, 16) uint8 state (encryption on T-tables of 32-bit column
words), so that every block of a call goes through each round at once.  CTR and CBC decryption are vectorised over their
blocks; a CBC chain is sequential within itself, and
`cbc_mac` runs many chains side by side, one lane each.

State layout: byte 4c + r of a block is row r of column c, as FIPS-197
reads its input.
"""

from __future__ import annotations

import numpy as np


def _xtime(a: np.ndarray) -> np.ndarray:
    return (((a << 1) ^ np.where(a & 0x80, 0x1B, 0)) & 0xFF).astype(np.uint8)


def _gmul(a: np.ndarray, m: int) -> np.ndarray:
    """a * m in GF(2^8) with AES's polynomial, elementwise."""
    a = a.astype(np.uint8)
    out = np.zeros_like(a)
    while m:
        if m & 1:
            out ^= a
        a = _xtime(a)
        m >>= 1
    return out


def _sbox() -> np.ndarray:
    """FIPS-197 section 5.1.1: the multiplicative inverse in GF(2^8),
    then the affine map."""
    box = np.zeros(256, np.uint8)
    p = q = 1
    while True:
        p = (p ^ (p << 1) ^ (0x1B if p & 0x80 else 0)) & 0xFF     # p * 3
        q ^= q << 1
        q ^= q << 2
        q ^= q << 4
        q &= 0xFF
        if q & 0x80:
            q ^= 0x09                                             # q / 3
        x = q
        for s in range(1, 5):
            x ^= ((q << s) | (q >> (8 - s))) & 0xFF
        box[p] = x ^ 0x63
        if p == 1:
            break
    box[0] = 0x63
    return box


SBOX = _sbox()
INV_SBOX = np.argsort(SBOX).astype(np.uint8)
_BYTES = np.arange(256, dtype=np.uint8)
# InvMixColumns' factors 9, 11, 13, 14
_DEC_TAB = np.stack([_gmul(_BYTES, m) for m in (9, 11, 13, 14)])


def _t_tables() -> np.ndarray:
    """(4, 256) uint32: T[k][b] is the column word (row 0 the high byte)
    that byte b in row k of a column adds after SubBytes and MixColumns."""
    s1, s2, s3 = (a.astype(np.uint32) for a in (SBOX, _gmul(SBOX, 2), _gmul(SBOX, 3)))
    rows = [(s2, s1, s1, s3), (s3, s2, s1, s1), (s1, s3, s2, s1), (s1, s1, s3, s2)]
    return np.stack([(a << 24) | (b << 16) | (c << 8) | d for a, b, c, d in rows])


_T = _t_tables()
_ROWS = np.arange(4)


def _round_maps():
    """Per byte j = 4c + r: the byte ShiftRows (and InvShiftRows) moves
    there, and for InvMixColumns the byte each of its four terms reads
    and the table of its factor."""
    shift, inv_shift = np.zeros(16, np.int64), np.zeros(16, np.int64)
    dec_src, dec_tab = np.zeros((16, 4), np.int64), np.zeros((16, 4), np.int64)
    dec_coef = {9: 0, 11: 1, 13: 2, 14: 3}
    for c in range(4):
        for r in range(4):
            j = 4 * c + r
            shift[j] = 4 * ((c + r) % 4) + r
            inv_shift[j] = 4 * ((c - r) % 4) + r
            for k in range(4):
                dec_src[j, k] = 4 * c + k
                dec_tab[j, k] = dec_coef[(14, 11, 13, 9)[(k - r) % 4]]
    return shift, inv_shift, dec_src, dec_tab


_SHIFT, _INV_SHIFT, _DEC_SRC, _DEC_TABI = _round_maps()


def expand_key(key: bytes) -> np.ndarray:
    """The AES-128 key schedule: (11, 16) uint8 round keys."""
    if len(key) != 16:
        raise ValueError(f"AES-128 takes a 16-byte key, not {len(key)} bytes")
    w = [list(key[4 * i:4 * i + 4]) for i in range(4)]
    rcon = 1
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = [int(SBOX[b]) for b in t[1:] + t[:1]]
            t[0] ^= rcon
            rcon = (rcon << 1) ^ (0x11B if rcon & 0x80 else 0)
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return np.array(w, np.uint8).reshape(11, 16)


class AES128:
    """One key's cipher over (n, 16) uint8 blocks."""

    def __init__(self, key: bytes):
        self.rk = expand_key(bytes(key))
        self._rk_words = self.rk.view(">u4").astype(np.uint32)      # (11, 4)

    def encrypt(self, blocks: np.ndarray) -> np.ndarray:
        """Each round: the bytes in ShiftRows order, one T-table word per
        byte, XORed per column (SubBytes, ShiftRows, MixColumns), then
        the round key."""
        s = np.asarray(blocks, np.uint8) ^ self.rk[0]
        for rnd in range(1, 10):
            x = s[:, _SHIFT].reshape(-1, 4, 4)                        # (n, column, row)
            t = _T[_ROWS, x]
            w = t[..., 0] ^ t[..., 1] ^ t[..., 2] ^ t[..., 3] ^ self._rk_words[rnd]
            s = np.ascontiguousarray(w, ">u4").view(np.uint8).reshape(-1, 16)
        return SBOX[s[:, _SHIFT]] ^ self.rk[10]

    def decrypt(self, blocks: np.ndarray) -> np.ndarray:
        s = np.asarray(blocks, np.uint8) ^ self.rk[10]
        for rnd in range(9, 0, -1):
            t = INV_SBOX[s[:, _INV_SHIFT]] ^ self.rk[rnd]
            s = _DEC_TAB[_DEC_TABI[:, 0], t[:, _DEC_SRC[:, 0]]]
            for k in range(1, 4):
                s = s ^ _DEC_TAB[_DEC_TABI[:, k], t[:, _DEC_SRC[:, k]]]
        return INV_SBOX[s[:, _INV_SHIFT]] ^ self.rk[0]


def _blocks(data: bytes) -> np.ndarray:
    if len(data) % 16:
        raise ValueError(f"{len(data)} bytes is not a whole number of 16-byte blocks")
    return np.frombuffer(bytes(data), np.uint8).reshape(-1, 16)


def cbc_decrypt(key: bytes, iv: bytes, data: bytes) -> bytes:
    """CBC decryption, all blocks at once: P_i = D(C_i) ^ C_(i-1)."""
    c = _blocks(data)
    prev = np.concatenate([np.frombuffer(bytes(iv), np.uint8)[None], c[:-1]])
    return (AES128(key).decrypt(c) ^ prev).tobytes()


def ctr_crypt(aes: AES128, counter: bytes, data: bytes, offset: int = 0) -> bytes:
    """CTR en/decryption of `data`, which starts `offset` bytes (a multiple
    of 16) into the stream of the 128-bit big-endian initial counter:
    every keystream block at once."""
    if offset % 16:
        raise ValueError("a CTR piece must start on a block boundary")
    n = len(data)
    idx = np.arange(-(-n // 16), dtype=np.uint64) + np.uint64(offset // 16)
    lo = idx + np.uint64(int.from_bytes(counter[8:], "big"))      # wraps mod 2^64
    hi = np.uint64(int.from_bytes(counter[:8], "big")) + (lo < idx).astype(np.uint64)
    ctr = np.concatenate([hi.astype(">u8").view(np.uint8).reshape(-1, 8),
                          lo.astype(">u8").view(np.uint8).reshape(-1, 8)], axis=1)
    ks = aes.encrypt(ctr).reshape(-1)[:n]
    return (np.frombuffer(bytes(data), np.uint8) ^ ks).tobytes()


def cbc_mac(aes: AES128, iv: bytes, lanes: list) -> np.ndarray:
    """The last CBC block of each lane's blocks ((n_i, 16) uint8, n_i >= 1)
    from `iv`: the chains run side by side, each step encrypting the
    lanes that still have a block.  -> (len(lanes), 16) uint8."""
    lens = np.array([len(b) for b in lanes])
    state = np.tile(np.frombuffer(bytes(iv), np.uint8), (len(lanes), 1))
    width = int(lens.max())
    padded = np.zeros((len(lanes), width, 16), np.uint8)
    for i, b in enumerate(lanes):
        padded[i, :len(b)] = b
    for step in range(width):
        live = np.flatnonzero(lens > step)
        state[live] = aes.encrypt(state[live] ^ padded[live, step])
    return state
