"""The port's F0 estimators other than the networks, against the JAX
package's on the same inputs: frame_signal exact; yin within 1e-4
relative on every frame of tones (>= 99 % of frames on pure noise); the
numpy copies pyin, swipe and praat_ac exactly equal; dio, harvest and
stonemask through the port's own build of native/src/worldlike.cpp
against the JAX package's library (voicing equal on every frame, f0
within 1e-6 relative); the silence split of split-audio conversion."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu import native as jnative
from rvc_maker_tpu.f0.praat_ac import praat_ac as jpraat
from rvc_maker_tpu.f0.pyin import pyin as jpyin
from rvc_maker_tpu.f0.swipe import swipe as jswipe
from rvc_maker_tpu.f0.yin import yin as jyin
from rvc_maker_tpu.ops.stft import frame_signal as jframe
from rvc_maker_tpu.pipelines import preprocess as jpre
from rvc_maker_tpu_torch.f0 import world
from rvc_maker_tpu_torch.f0.praat_ac import praat_ac
from rvc_maker_tpu_torch.f0.pyin import pyin
from rvc_maker_tpu_torch.f0.swipe import swipe
from rvc_maker_tpu_torch.f0.yin import yin
from rvc_maker_tpu_torch.ops import build
from rvc_maker_tpu_torch.ops.stft import frame_signal
from rvc_maker_tpu_torch.pipelines import preprocess as tpre
from torch_port_util import n, t, torch_threads, voice  # noqa: F401


@pytest.mark.parametrize("n_fft,hop", [(1024, 160), (2048, 160), (512, 300)])
def test_frame_signal_equals_jax(n_fft, hop):
    y = np.random.RandomState(n_fft).randn(2, 5000).astype(np.float32)
    np.testing.assert_array_equal(n(frame_signal(t(y), n_fft, hop)),
                                  n(jframe(jnp.asarray(y), n_fft, hop)))


def _yin_pair(audio):
    return n(yin(t(audio))), n(jyin(jnp.asarray(audio)))


@pytest.mark.parametrize("noise", [0.0, 1e-3], ids=["tones", "tones+noise"])
def test_yin_matches_jax_on_tones(noise):
    """Harmonic tones with vibrato at 120-600 Hz: f0 within 1e-4 relative
    on every frame (the trough index equal: one lag apart is >= 0.2 %)."""
    rs = np.random.RandomState(1)
    audio = np.stack([voice(1.0, f0, seed=i) for i, f0 in enumerate((120.0, 250.0, 600.0))])
    audio = audio + noise * rs.randn(*audio.shape).astype(np.float32)
    got, ref = _yin_pair(audio)
    rel = np.abs(got - ref) / ref
    print(f"yin noise={noise}: max rel err {rel.max():.3e} over {rel.size} frames")
    assert got.shape == ref.shape == (3, 101) and rel.max() <= 1e-4


def test_yin_matches_jax_on_noise():
    """Pure noise puts CMNDF troughs near the threshold and near-ties
    between minima, where rounding can flip the choice: >= 99 % of the
    frames within 1e-4 relative."""
    audio = (np.random.RandomState(2).randn(4, 16000) * 0.1).astype(np.float32)
    got, ref = _yin_pair(audio)
    same = np.abs(got - ref) <= 1e-4 * ref
    print(f"yin on noise: {int(same.sum())} of {same.size} frames equal")
    assert same.mean() >= 0.99


@pytest.fixture(scope="module")
def speech():
    return voice(1.0, 210.0, seed=5)


def test_pyin_equals_jax(speech):
    for a, b in zip(pyin(speech, 16000, fmin=50.0, fmax=1100.0, hop_length=160),
                    jpyin(speech, 16000, fmin=50.0, fmax=1100.0, hop_length=160)):
        np.testing.assert_array_equal(a, b)


def test_swipe_equals_jax(speech):
    for a, b in zip(swipe(speech, 16000, f0_floor=50.0, f0_ceil=1100.0),
                    jswipe(speech, 16000, f0_floor=50.0, f0_ceil=1100.0)):
        np.testing.assert_array_equal(a, b)


def test_praat_ac_equals_jax(speech):
    np.testing.assert_array_equal(
        praat_ac(speech, 16000, f0_floor=50.0, f0_ceil=1100.0, voicing_threshold=0.6),
        jpraat(speech, 16000, f0_floor=50.0, f0_ceil=1100.0, voicing_threshold=0.6))


def _close_f0(got, ref, what):
    assert got.shape == ref.shape, what
    np.testing.assert_array_equal(got > 0, ref > 0, err_msg=what)
    rel = float(np.max(np.abs(got - ref) / np.maximum(ref, 1e-30)))
    print(f"{what}: bit-equal {bool(np.array_equal(got, ref))}, max rel diff {rel:.3e}")
    assert rel <= 1e-6, (what, rel)


@pytest.mark.parametrize("name", ["dio", "harvest"])
def test_world_matches_jax_native(name):
    """The port's g++ build of worldlike.cpp against the JAX package's
    library, on a tone with a silent gap (voiced and unvoiced frames)."""
    x = voice(1.5, 170.0, seed=6).astype(np.float64)
    x[9000:15000] = 0.0
    f0, tt = getattr(world, name)(x, 16000, f0_floor=50.0, f0_ceil=1100.0)
    jf0, jt = getattr(jnative, name)(x, 16000, f0_floor=50.0, f0_ceil=1100.0)
    np.testing.assert_array_equal(tt, jt)
    _close_f0(f0, jf0, name)
    assert (f0 > 0).any() and (f0 == 0).any()
    if name == "dio":
        _close_f0(world.stonemask(x, 16000, tt, f0), jnative.stonemask(x, 16000, jt, jf0),
                  "stonemask")


def test_world_build_failure_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises with the compiler's output; nothing
    falls back."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build, "HOST_SOURCES", {"bad": bad})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ exited"):
        build.load_host("bad")
    assert not list((tmp_path / "_build").glob("*.so"))


@pytest.mark.parametrize("gaps", [[(5.5, 6.3)], [(0.0, 0.6), (5.8, 6.9), (11.0, 12.0)]],
                         ids=["one-gap", "edges-and-middle"])
def test_cut_with_positions_matches_jax(gaps):
    """The port's positions are the slicer's cut points; JAX scans the
    audio for each chunk.  Both give the same chunks at the same places,
    and restore_positions puts them back the same.  (The split keeps
    pieces of at least 5 s, so the audio is 12 s.)"""
    x = voice(12.0, 200.0, seed=7)
    for a, b in gaps:
        x[int(a * 16000):int(b * 16000)] = 0.0
    got = tpre.cut_with_positions(x, 16000, db_thresh=-60, min_interval_ms=500)
    ref = jpre.cut_with_positions(x, 16000, db_thresh=-60, min_interval_ms=500)
    assert [(s, e) for _, s, e in got] == [(s, e) for _, s, e in ref]
    assert len(got) >= 2
    for (c, _, _), (r, _, _) in zip(got, ref):
        np.testing.assert_array_equal(c, r)
    segs = [(3 * s, 3 * s + 3 * len(c), np.repeat(c, 3)) for c, s, _ in got]
    np.testing.assert_array_equal(tpre.restore_positions(segs, 3 * len(x)),
                                  jpre.restore_positions(segs, 3 * len(x)))


def test_slicer_pieces_unchanged():
    """SilenceSlicer.slice is its bounds applied to the audio."""
    x = voice(4.0, 150.0, seed=8)
    x[20000:36000] = 0.0
    slicer = tpre.SilenceSlicer(16000, threshold_db=-42, min_length_ms=1500,
                                min_interval_ms=400, hop_ms=15, max_sil_kept_ms=500)
    ref = jpre.SilenceSlicer(16000, threshold_db=-42, min_length_ms=1500,
                             min_interval_ms=400, hop_ms=15, max_sil_kept_ms=500).slice(x)
    got = slicer.slice(x)
    assert len(got) == len(ref) >= 2
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
