"""Whisper tokenizer: tiktoken-format byte-level BPE (counterpart of JAX
`speaker/whisper_tokenizer.py`).

Reads the reference's `.tiktoken` vocabulary files ("base64(bytes) rank"
lines) directly: byte-level BPE with greedy lowest-rank merges, the
Whisper special-token layout and the language table.

The JAX package pre-tokenizes with the `regex` package's pattern

    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+

which stdlib `re` cannot say: it has no \\p{L} / \\p{N} (and
`[^\\W\\d_]` takes No / Nl digits such as "²" for letters), and its
\\s also takes U+001C-U+001F, which `regex`'s \\s (the Unicode White_Space
property) does not.  `split_pieces` is a scanner over
`unicodedata.category` that splits text as that pattern's findall does.
"""

from __future__ import annotations

import base64
import string
import unicodedata
from functools import lru_cache

# language codes in whisper order (reference whisper.py:28 LANGUAGES)
LANGUAGE_CODES = [
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",
]

# the Unicode White_Space property: what `regex`'s \s matches in a str
WHITE_SPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005"
                        "\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def char_class(ch: str) -> str:
    """"s" (\\s), "L" (\\p{L}), "N" (\\p{N}) or "o" (anything else)."""
    if ch in WHITE_SPACE:
        return "s"
    cat = unicodedata.category(ch)
    return cat[0] if cat[0] in "LN" else "o"


def split_pieces(text: str) -> list[str]:
    """The pre-tokenizer's pieces: `_PAT.findall(text)` of the JAX
    package, alternative by alternative."""
    cls = [char_class(c) for c in text]
    n, i, out = len(text), 0, []

    def run(j: int, c: str) -> int:
        while j < n and cls[j] == c:
            j += 1
        return j

    while i < n:
        c = cls[i]
        con = next((p for p in CONTRACTIONS if text.startswith(p, i)), None)
        if con is not None:                                     # 's|'t|...
            end = i + len(con)
        elif c in "LNo":                                        # \p{L}+ etc.
            end = run(i, c)
        elif text[i] == " " and i + 1 < n and cls[i + 1] != "s":  # " ?" before them
            end = run(i + 1, cls[i + 1])
        else:
            end = run(i, "s")
            if end < n and end - i > 1:                         # \s+(?!\S)
                end -= 1
        out.append(text[i:end])
        i = end
    return out


class WhisperTokenizer:
    def __init__(self, vocab_path: str, *, multilingual: bool = True,
                 num_languages: int = 99, language: str = "en",
                 task: str = "transcribe"):
        self.ranks: dict[bytes, int] = {}
        with open(vocab_path, "rb") as f:
            for line in f:
                if not line.strip():
                    continue
                token_b64, rank = line.split()
                self.ranks[base64.b64decode(token_b64)] = int(rank)
        self.id_to_bytes = {v: k for k, v in self.ranks.items()}
        n = len(self.ranks)

        self.special: dict[str, int] = {}
        specials = (["<|endoftext|>", "<|startoftranscript|>"]
                    + [f"<|{c}|>" for c in LANGUAGE_CODES[:num_languages]]
                    + ["<|translate|>", "<|transcribe|>", "<|startoflm|>",
                       "<|startofprev|>", "<|nospeech|>", "<|notimestamps|>"]
                    + [f"<|{i * 0.02:.2f}|>" for i in range(1501)])
        for s in specials:
            self.special[s] = n
            n += 1
        self.n_vocab = n

        self.eot = self.special["<|endoftext|>"]
        self.sot = self.special["<|startoftranscript|>"]
        self.translate = self.special["<|translate|>"]
        self.transcribe = self.special["<|transcribe|>"]
        self.sot_prev = self.special["<|startofprev|>"]
        self.no_speech = self.special["<|nospeech|>"]
        self.no_timestamps = self.special["<|notimestamps|>"]
        self.timestamp_begin = self.special["<|0.00|>"]
        self.language = language
        self.language_token = self.special.get(f"<|{language}|>")
        self.task = task
        self.multilingual = multilingual

    # -- encode / decode ---------------------------------------------------

    def _bpe(self, piece: bytes) -> list[int]:
        parts = [piece[i: i + 1] for i in range(len(piece))]
        while len(parts) > 1:
            best = None
            best_rank = None
            for i in range(len(parts) - 1):
                r = self.ranks.get(parts[i] + parts[i + 1])
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            parts[best: best + 2] = [parts[best] + parts[best + 1]]
        return [self.ranks[p] for p in parts if p in self.ranks]

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for piece in split_pieces(text):
            ids.extend(self._bpe(piece.encode("utf-8")))
        return ids

    def decode(self, ids) -> str:
        return b"".join(self.id_to_bytes.get(int(i), b"") for i in ids).decode(
            "utf-8", errors="replace")

    def sot_sequence(self, *, with_timestamps: bool = True) -> list[int]:
        seq = [self.sot]
        if self.multilingual:
            seq.append(self.language_token)
            seq.append(self.transcribe if self.task == "transcribe" else self.translate)
        if not with_timestamps:
            seq.append(self.no_timestamps)
        return seq

    @lru_cache(maxsize=1)
    def non_speech_tokens(self) -> tuple[int, ...]:
        """The tokens suppressed in decoding (the reference tokenizer's
        non_speech_tokens: symbols and music signs)."""
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + \
            "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
        result = set()
        for s in symbols + list("♩♪♫♬♭♮♯"):
            for tok_text in (s, " " + s):
                ids = self.encode(tok_text)
                if len(ids) == 1:
                    result.add(ids[0])
        return tuple(sorted(result))

    def timestamp_to_seconds(self, token: int) -> float:
        return (token - self.timestamp_begin) * 0.02

    # -- word segmentation (reference tokenizer split_to_word_tokens /
    #    split_tokens_on_unicode / split_tokens_on_spaces) ---------------

    def decode_with_timestamps(self, ids) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i >= self.timestamp_begin:
                out.append(f"<|{(i - self.timestamp_begin) * 0.02:.2f}|>")
            else:
                out.append(self.decode([i]))
        return "".join(out)

    def split_tokens_on_unicode(self, tokens: list[int]):
        """Groups of tokens that each decode to whole characters (byte-level
        BPE may split a code point across tokens)."""
        decoded_full = self.decode_with_timestamps(tokens)
        replacement = "�"
        words, word_tokens, current = [], [], []
        offset = 0
        for token in tokens:
            current.append(token)
            decoded = self.decode_with_timestamps(current)
            if (replacement not in decoded
                    or decoded_full[offset + decoded.index(replacement)] == replacement):
                words.append(decoded)
                word_tokens.append(current)
                current = []
                offset += len(decoded)
        return words, word_tokens

    def split_tokens_on_spaces(self, tokens: list[int]):
        subwords, subword_tokens_list = self.split_tokens_on_unicode(tokens)
        words: list[str] = []
        word_tokens: list[list[int]] = []
        for subword, sub_tokens in zip(subwords, subword_tokens_list):
            special = sub_tokens[0] >= self.eot
            with_space = subword.startswith(" ")
            punct = subword.strip() in string.punctuation
            if special or with_space or punct or len(words) == 0:
                words.append(subword)
                word_tokens.append(sub_tokens)
            else:
                words[-1] += subword
                word_tokens[-1].extend(sub_tokens)
        return words, word_tokens

    def split_to_word_tokens(self, tokens: list[int]):
        if self.language in ("zh", "ja", "th", "lo", "my", "yue"):
            # no spaces between words: split at code point boundaries
            return self.split_tokens_on_unicode(tokens)
        return self.split_tokens_on_spaces(tokens)
