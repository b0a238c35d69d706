"""The port's speaker modules without Whisper's network: the tokenizer
and its pre-tokenizer scanner, word alignment, ECAPA-TDNN, the
HyperPyYAML subset, against the JAX package's (and `regex` / PyYAML,
which only this machine has).

Tolerances: tokens, pieces, DTW paths and parsed files equal; word
timings within 1e-6 s and probabilities within 1e-4; ECAPA embeddings
1e-4 x max(1, |ref|max); the folded BatchNorms 1e-6.
"""

import ast
import random
import subprocess
import sys
import unicodedata
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import regex
import torch

from rvc_maker_tpu.models import ecapa_tdnn as jec
from rvc_maker_tpu.models import whisper as jw
from rvc_maker_tpu.speaker import align as jal
from rvc_maker_tpu.speaker import hyperyaml as jhy
from rvc_maker_tpu.speaker import whisper_tokenizer as jtk
from rvc_maker_tpu_torch.errors import BadRequest
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.models import ecapa_tdnn as pec
from rvc_maker_tpu_torch.models import whisper as pw
from rvc_maker_tpu_torch.speaker import align as pal
from rvc_maker_tpu_torch.speaker import hyperyaml as phy
from rvc_maker_tpu_torch.speaker import whisper_tokenizer as ptk
from torch_port_util import n, rel_close, torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

MIXED = [
    "Hello world, it's a test.", "they'll've we'd I'M 'S", "naïve café — déjà vu",
    "e\u0301te\u0301 combining marks", "中文字符 and 日本語かな", "٣٤٥ Arabic digits ١٢",
    "x² y³ ½ Ⅻ numbers", "emoji 😀👍🏽 here", "sep\x1c\x1d\x1e\x1fends", "nbsp\xa0and\u3000wide",
    "trailing spaces   ", "  leading", "tabs\t\tand\nnewlines \n", "a  b   c", "!!!???...",
    " 's 't", "don't", "", " ", "   \t", "'", "mixed123abc 456 def",
]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return from_jax.write_tiktoken_vocab(str(tmp_path_factory.mktemp("vocab") / "v.tiktoken"))


@pytest.fixture(scope="module")
def toks(vocab):
    return jtk.WhisperTokenizer(vocab), ptk.WhisperTokenizer(vocab)


def test_synthetic_vocab_has_the_released_layout(toks):
    jt, pt = toks
    assert len(pt.ranks) == 50257 and pt.n_vocab == 51865
    for name in ("eot", "sot", "translate", "transcribe", "sot_prev", "no_speech",
                 "no_timestamps", "timestamp_begin", "language_token"):
        assert getattr(pt, name) == getattr(jt, name), name
    assert (pt.eot, pt.sot, pt.no_speech, pt.timestamp_begin) == (50257, 50258, 50362, 50364)
    assert pt.sot_sequence() == jt.sot_sequence()
    assert pt.sot_sequence(with_timestamps=False) == jt.sot_sequence(with_timestamps=False)
    assert pt.non_speech_tokens() == jt.non_speech_tokens()


@pytest.mark.parametrize("text", MIXED)
def test_encode_decode_match_jax(toks, text):
    jt, pt = toks
    ids = pt.encode(text)
    assert ids == jt.encode(text)
    assert pt.decode(ids) == jt.decode(ids) == text


def test_decode_and_word_split_match_jax(toks):
    jt, pt = toks
    rs = np.random.RandomState(0)
    for _ in range(20):
        ids = [int(i) for i in rs.randint(0, 50257, rs.randint(1, 30))]
        ids += [pt.eot] if rs.rand() < 0.5 else []
        assert pt.decode(ids) == jt.decode(ids)
        assert pt.decode_with_timestamps(ids + [pt.timestamp_begin + 7]) == \
            jt.decode_with_timestamps(ids + [pt.timestamp_begin + 7])
        assert pt.split_to_word_tokens(ids) == jt.split_to_word_tokens(ids)
    text = pt.encode(" Hello there, my friend. 中文 ok") + [pt.eot]
    assert pt.split_to_word_tokens(text) == jt.split_to_word_tokens(text)
    for lang in ("zh", "ja"):
        a = ptk.WhisperTokenizer.__new__(ptk.WhisperTokenizer)
        a.__dict__.update(pt.__dict__, language=lang)
        b = jtk.WhisperTokenizer.__new__(jtk.WhisperTokenizer)
        b.__dict__.update(jt.__dict__, language=lang)
        assert a.split_to_word_tokens(text) == b.split_to_word_tokens(text)


def _regex_class(ch, s=regex.compile(r"\s"), L=regex.compile(r"\p{L}"),
                 N=regex.compile(r"\p{N}")):
    return "s" if s.match(ch) else "L" if L.match(ch) else "N" if N.match(ch) else "o"


def test_scanner_classes_every_code_point_as_regex():
    """Every code point this Python's Unicode database assigns is in the
    same class (\\s, \\p{L}, \\p{N}, other) as `regex` puts it.  Code
    points it leaves unassigned (Cn) are left out: `regex` carries a newer
    Unicode, which assigns some of them (ROADMAP queue 3)."""
    differ = []
    for cp in range(0x110000):
        ch = chr(cp)
        if unicodedata.category(ch) != "Cn" and ptk.char_class(ch) != _regex_class(ch):
            differ.append(hex(cp))
    assert not differ, differ[:20]
    assert ptk.char_class("²") == "N" and ptk.char_class("\x1c") == "o"


def test_scanner_splits_as_the_pattern():
    """The scanner's pieces against the JAX package's `_PAT.findall` on
    mixed-script strings and on seeded random strings over an alphabet of
    every class (contractions, the \\s+(?!\\S) rule, U+001C-U+001F)."""
    for text in MIXED:
        assert ptk.split_pieces(text) == jtk._PAT.findall(text), text
    rnd = random.Random(0)
    alphabet = (list("ab Z \t\n'sdtrevml.,!?-") + ["²", "½", "Ⅻ", "٣", "é", "\u0301", "中",
                                                   "😀", "\x1c", "\x1f", "\xa0", "\u3000",
                                                   "'re", "'ll", "  ", "   "])
    for _ in range(3000):
        text = "".join(rnd.choice(alphabet) for _ in range(rnd.randint(0, 16)))
        assert ptk.split_pieces(text) == jtk._PAT.findall(text), repr(text)


def test_dtw_and_median_filter_match_jax():
    rs = np.random.RandomState(0)
    for shape in ((1, 1), (5, 9), (12, 40), (30, 31)):
        cost = rs.randn(*shape)
        for got, ref in zip(pal.dtw(cost), jal.dtw(cost)):
            np.testing.assert_array_equal(got, ref)
    for shape, width in (((3, 4, 50), 7), ((2, 5), 3), ((4, 3), 7), ((6, 1), 7), ((2, 9), 1)):
        x = rs.randn(*shape)
        np.testing.assert_array_equal(pal.median_filter_time(x, width),
                                      jal.median_filter_time(x, width))


SMALL = dict(n_mels=80, n_audio_ctx=100, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
             n_vocab=51865, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2)


@pytest.fixture(scope="module")
def whisper_pair():
    jd, pd = jw.WhisperDims(**SMALL), pw.WhisperDims(**SMALL)
    sd = from_jax.whisper_state_dict(from_jax.random_whisper_tree(pd, 4))
    jp, m = jw.params_from_state_dict(sd, jd), pw.params_from_state_dict(sd, pd)
    mel = np.random.RandomState(2).randn(1, 80, 200).astype(np.float32)
    return jp, jd, m, np.array(jw.encode_audio(jp["encoder"], jd, jnp.asarray(mel)))


def _same_words(got, ref):
    assert [w.word for w in got] == [w.word for w in ref] and len(got) > 2
    for g, r in zip(got, ref):
        assert g.tokens == r.tokens
        assert abs(g.start - r.start) <= 1e-6 and abs(g.end - r.end) <= 1e-6
        assert abs(g.probability - r.probability) <= 1e-4


@pytest.mark.parametrize("heads", ["default", "dump"])
def test_find_alignment_matches_jax(whisper_pair, toks, heads):
    jp, jd, m, feats = whisper_pair
    jt, pt = toks
    text = pt.encode(" Hello there, my friend. It's a fine day, isn't it?")
    mask = None if heads == "default" else np.array([[True, False, True, False],
                                                     [False, True, True, False]])
    ref = jal.find_alignment(jp, jd, jt, text, jnp.asarray(feats), 180, alignment_heads=mask)
    got = pal.find_alignment(m, pt, text, torch.from_numpy(feats), 180, alignment_heads=mask)
    _same_words(got, ref)


def test_add_word_timestamps_matches_jax(whisper_pair, toks):
    jp, jd, m, feats = whisper_pair
    jt, pt = toks
    segs = [{"tokens": pt.encode(" Hello there, my friend."), "start": 0.0, "end": 1.0},
            {"tokens": pt.encode(" It's a fine day!") + [pt.timestamp_begin + 50],
             "start": 1.0, "end": 2.0}]
    ref = [dict(s, tokens=list(s["tokens"])) for s in segs]
    jal.add_word_timestamps(ref, jp, jd, jt, jnp.asarray(feats), 150, time_offset=30.0)
    pal.add_word_timestamps(segs, m, pt, torch.from_numpy(feats), 150, time_offset=30.0)
    for g, r in zip(segs, ref):
        assert [w["word"] for w in g["words"]] == [w["word"] for w in r["words"]]
        for gw, rw in zip(g["words"], r["words"]):
            assert abs(gw["start"] - rw["start"]) <= 1e-6 and abs(gw["end"] - rw["end"]) <= 1e-6
    assert sum(len(s["words"]) for s in segs) > 3


def test_merge_punctuations_matches_jax():
    words = [" \"", "Hello", ",", " world", ".", " (", "yes", ")", " ¿", "no", "?"]
    got = [pal.WordTiming(w, [i], i * 0.1, i * 0.1 + 0.1, 0.5) for i, w in enumerate(words)]
    ref = [jal.WordTiming(w, [i], i * 0.1, i * 0.1 + 0.1, 0.5) for i, w in enumerate(words)]
    pal.merge_punctuations(got)
    jal.merge_punctuations(ref)
    assert [(w.word, w.tokens) for w in got] == [(w.word, w.tokens) for w in ref]


@pytest.fixture(scope="module")
def ecapa_sd():
    return from_jax.ecapa_state_dict(from_jax.random_ecapa_tree(seed=0),
                                     np.random.RandomState(1))


@pytest.mark.parametrize("seconds", [1.0, 2.0])
def test_ecapa_embeddings_match_jax(ecapa_sd, seconds):
    frames = int(100 * seconds) + 1
    x = np.random.RandomState(int(seconds)).randn(2, frames, 80).astype(np.float32)
    ref = np.asarray(jec.embed(jec.params_from_state_dict(ecapa_sd), jnp.asarray(x)))
    got = pec.embed(pec.params_from_state_dict(ecapa_sd), torch.from_numpy(x))
    assert got.shape == (2, 192)
    rel_close(n(got), ref, 1e-4, "embeddings")


def test_ecapa_params_from_state_dict_match_jax(ecapa_sd):
    """The port's folded tree against JAX's leaf by leaf (conv weights
    transposed back to the JAX layout), and the seeded JAX-layout tree
    carried across directly."""
    jp = jec.params_from_state_dict(ecapa_sd)
    got = pec.params_from_state_dict(ecapa_sd)
    carried = from_jax.ecapa_from_jax(from_jax.random_ecapa_tree(seed=0))

    def walk(a, b, c, path=""):
        if isinstance(b, dict):
            assert set(a) == set(b) == set(c), path
            for k in b:
                walk(a[k], b[k], c[k], f"{path}.{k}")
        elif isinstance(b, list):
            assert len(a) == len(b) == len(c), path
            for i, (x, y, z) in enumerate(zip(a, b, c)):
                walk(x, y, z, f"{path}[{i}]")
        else:
            ref = np.asarray(b)
            got_a, got_c = n(a), n(c)
            if ref.ndim == 3:
                got_a, got_c = got_a.transpose(2, 1, 0), got_c.transpose(2, 1, 0)
            np.testing.assert_allclose(got_a, ref, rtol=1e-6, atol=1e-6, err_msg=path)
            np.testing.assert_allclose(got_c, ref, rtol=1e-5, atol=1e-6, err_msg=path)

    walk(got, jp, carried)


def test_ecapa_checkpoint_prefixes_and_errors(ecapa_sd, tmp_path):
    path = str(tmp_path / "embedding_model.ckpt")
    torch.save({f"embedding_model.{k}": v for k, v in ecapa_sd.items()}, path)
    p = pec.load_ecapa_ckpt(path, device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 120, 80).astype(np.float32))
    rel_close(n(pec.embed(p, x)), n(pec.embed(pec.params_from_state_dict(ecapa_sd), x)), 0)
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(b"junk")
    with pytest.raises(BadRequest):
        pec.load_ecapa_ckpt(str(bad), device="cpu")
    with pytest.raises(BadRequest, match="no"):
        pec.params_from_state_dict({k: v for k, v in ecapa_sd.items() if "mfa" not in k})


# a speechbrain spkrec-ecapa hyperparams.yaml, with every construct the
# subset reads
HPARAMS = """\
# ############################################################################
# Model: ECAPA big for Speaker verification
# ############################################################################
---
n_mels: 80   # trailing comment
sample_rate: 16000
lr: 0.001
neg: -3
small: 1.5e-3
big: 6.02e+23
hexv: 0x1F
octv: 017
binv: 0b101
sexa: 1:20
flag_a: yes
flag_b: Off
flag_c: True
nothing: null
tilde: ~
empty:
quoted_s: 'it''s # not a comment'
quoted_d: "tab\\there \\"q\\" \\u00e9"
plain_apostrophe: it's fine  # comment
url: http://example.com/a#frag
pretrained_path: speechbrain/spkrec-ecapa-voxceleb
save_folder: !ref <pretrained_path>/save
inf_v: .inf
"quoted key": 5

compute_features: !new:speechbrain.lobes.features.Fbank
    n_mels: !ref <n_mels>
    deltas: False

mean_var_norm: !new:speechbrain.processing.features.InputNormalization
    norm_type: sentence
    std_norm: False

embedding_model: !new:speechbrain.lobes.models.ECAPA_TDNN.ECAPA_TDNN
    input_size: !ref <n_mels>
    channels: [1024, 1024, 1024,
               1024, 3072]
    kernel_sizes: [5, 3, 3, 3, 1]
    dilations: [1, 2, 3, 4, 1]
    nested: [[1, 2], ['a', "b"], [], !ref <n_mels>]
    attention_channels: 128
    lin_neurons: 192

label_encoder: !new:speechbrain.dataio.encoder.CategoricalEncoder
label_fn: !name:speechbrain.dataio.encoder.CategoricalEncoder
    ignored: 1
applied: !apply:torch.manual_seed [1234]
args_new: !new:torch.nn.Sequential
    - !ref <compute_features>
    - !new:torch.nn.ReLU

modules:
    compute_features: !ref <compute_features>
    mean_var_norm: !ref <mean_var_norm>
    embedding_model: !ref <embedding_model>

augment:
- a
- b: 1
  c: [x, y]
- - deep
  - 2
-
  e: 3
pretrainer: !new:speechbrain.utils.parameter_transfer.Pretrainer
    loadables:
        embedding_model: !ref <embedding_model>
    paths:
        embedding_model: !ref <pretrained_path>/embedding_model.ckpt
"""


def test_hyperyaml_matches_jax(tmp_path):
    path = tmp_path / "hyperparams.yaml"
    path.write_text(HPARAMS, encoding="utf-8")
    got, ref = phy.load_hyperpyyaml_lite(str(path)), jhy.load_hyperpyyaml_lite(str(path))
    assert got == ref
    assert got["embedding_model"]["input_size"] == 80
    assert got["save_folder"] == "speechbrain/spkrec-ecapa-voxceleb/save"
    assert got["quoted_d"] == 'tab\there "q" é' and got["sexa"] == 80


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: {c: 2}\n", 2), ("a: &x 1\n", 1), ("a: |\n  text\n", 1),
    ("a: !foo 1\n", 1), ("a:\n\tb: 1\n", 2), ("a: [1, 2\nb: 3\n", 1),
    ("a: 1\n  b: 2\n", 2), ("a: b: c\n", 1), ("a: 'open\n", 1), ("a: !ref\n  - 1\n", 1),
    ("a: 2001-12-14\n", 1), ("- 1\nb: 2\n", 2), ("a: 1\n%YAML 1.1\n", 2),
])
def test_hyperyaml_outside_the_subset_raises(tmp_path, text, line):
    path = tmp_path / "h.yaml"
    path.write_text(text)
    with pytest.raises(BadRequest, match=f"line {line}" if line else ""):
        phy.load_hyperpyyaml_lite(str(path))


def test_load_speechbrain_ecapa_matches_jax(tmp_path, ecapa_sd):
    (tmp_path / "hyperparams.yaml").write_text(HPARAMS, encoding="utf-8")
    torch.save(ecapa_sd, str(tmp_path / "embedding_model.ckpt"))
    jp, jinfo = jhy.load_speechbrain_ecapa(str(tmp_path))
    p, info = phy.load_speechbrain_ecapa(str(tmp_path), device="cpu")
    assert info == jinfo and info["n_mels"] == 80 and info["lin_neurons"] == 192
    x = np.random.RandomState(3).randn(1, 150, 80).astype(np.float32)
    rel_close(n(pec.embed(p, torch.from_numpy(x))), np.asarray(jec.embed(jp, jnp.asarray(x))),
              1e-4)
    rel_close(n(pec.embed(phy.load_ecapa(str(tmp_path), "cpu"), torch.from_numpy(x))),
              n(pec.embed(p, torch.from_numpy(x))), 0)
    (tmp_path / "hyperparams.yaml").write_text("embedding_model: !new:x.Other\n")
    with pytest.raises(BadRequest, match="ECAPA_TDNN"):
        phy.load_speechbrain_ecapa(str(tmp_path), device="cpu")


SPEAKER_MODULES = ["rvc_maker_tpu_torch/models/whisper.py",
                   "rvc_maker_tpu_torch/models/ecapa_tdnn.py",
                   "rvc_maker_tpu_torch/speaker", "rvc_maker_tpu_torch/utils/yaml_lite.py",
                   "rvc_maker_tpu_torch/interop/demucs_load.py"]


def test_speaker_stack_needs_no_regex_yaml_or_sklearn():
    """The card's machine has none of `regex`, PyYAML and scikit-learn:
    no speaker module imports them, and the stack runs in a process where
    importing any of them fails."""
    for root in SPEAKER_MODULES:
        path = REPO / root
        for f in [path] if path.is_file() else sorted(path.rglob("*.py")):
            for node in ast.walk(ast.parse(f.read_text())):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                         [node.module] if isinstance(node, ast.ImportFrom) and node.module
                         and node.level == 0 else [])
                for mod in names:
                    assert mod.split(".")[0] not in ("regex", "yaml", "sklearn", "jax",
                                                     "rvc_maker_tpu"), (f, mod)
    code = """
import sys
for m in ("regex", "yaml", "sklearn", "jax"):
    sys.modules[m] = None
import numpy as np, torch
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.speaker import diarize, hyperyaml, transcribe, whisper_tokenizer
from rvc_maker_tpu_torch.utils import yaml_lite
assert whisper_tokenizer.split_pieces("it's  2² ok ") == ["it", "'s", " ", " 2²", " ok", " "]
assert yaml_lite.load("a: !x 1", tag=lambda *a: 5) == {"a": 5}
x = np.random.RandomState(0).randn(6, 4)
x[3:] += 5
print(diarize.cluster_labels(x, 2).tolist())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] in ("[0, 0, 0, 1, 1, 1]", "[1, 1, 1, 0, 0, 0]")
