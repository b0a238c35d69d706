"""The port's noise gate (`rvc_maker_tpu_torch/utils/noisereduce.py`) and
its STFT pair (`ops/stft.py` `stft_complex` / `istft`) on the CPU against
the JAX package's, whose `_gate` runs jitted as its own tests run it.

`reduce_noise` in both modes at 16 / 32 / 40 / 48 kHz (the moving
average's kernel is even at 32 and 40 kHz), with prop_decrease 0.7 and
1.0, on 2 s of a noisy 440 Hz tone: max abs <= 1e-5.  Chunking with a
small chunk and padding, a clip shorter than the moving average, and a
noise clip.  The stationary mask is a hard threshold: the bins where the
two packages' masks differ are counted and printed (-s)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.ops import stft as jstft
from rvc_maker_tpu.utils import noisereduce as jnr
from rvc_maker_tpu_torch.ops import stft
from rvc_maker_tpu_torch.utils import noisereduce as nr
from torch_port_util import n, torch_threads  # noqa: F401

GATE_ATOL = 1e-5
RATES = [16000, 32000, 40000, 48000]


def _noisy(sr, seconds=2.0, seed=2):
    rs = np.random.RandomState(seed)
    tt = np.arange(int(sr * seconds)) / sr
    return (0.5 * np.sin(2 * np.pi * 440 * tt) + rs.randn(len(tt)) * 0.05).astype(np.float32)


@pytest.mark.parametrize("pad_mode", ["constant", "reflect"])
def test_stft_complex_matches_jax(pad_mode):
    y = np.random.RandomState(0).randn(2, 5000).astype(np.float32)
    win = stft.hann_window(1024)
    np.testing.assert_array_equal(win, jstft.hann_window(1024))
    kw = dict(n_fft=1024, hop_length=256, win_length=1024, window=win, center=True,
              pad_mode=pad_mode)
    got = n(stft.stft_complex(torch.as_tensor(y), **kw))
    ref = np.asarray(jstft.stft_complex(jnp.asarray(y), **kw))
    assert got.shape == ref.shape and got.dtype == np.complex64
    err = float(np.abs(got - ref).max())
    assert err <= 1e-5 * np.abs(ref).max(), err


@pytest.mark.parametrize("length", [5000, 4700, 5600, 5120])
def test_istft_matches_jax(length):
    """Trimmed, padded with zeros, and the natural length (21 frames of
    hop 256 span 5120 samples once centered)."""
    rs = np.random.RandomState(1)
    spec = (rs.randn(2, 21, 513) + 1j * rs.randn(2, 21, 513)).astype(np.complex64)
    win = stft.hann_window(1024)
    kw = dict(n_fft=1024, hop_length=256, win_length=1024, window=win, length=length)
    got = n(stft.istft(torch.as_tensor(spec), **kw))
    ref = np.asarray(jstft.istft(jnp.asarray(spec), center=True, **kw))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_istft_matches_torch_istft():
    """Against torch.istft on a spectrum it accepts (JAX
    tests/test_audio_utils.py:25's bound, 1e-4)."""
    y = torch.as_tensor(np.random.RandomState(1).randn(1, 4000).astype(np.float32))
    spec = torch.stft(y, 1024, hop_length=256, win_length=1024, window=torch.hann_window(1024),
                      center=True, return_complex=True)
    ref = torch.istft(spec, 1024, hop_length=256, win_length=1024,
                      window=torch.hann_window(1024), center=True, length=4000)
    got = stft.istft(spec.transpose(1, 2), n_fft=1024, hop_length=256, win_length=1024,
                     window=stft.hann_window(1024), length=4000)
    np.testing.assert_allclose(n(got), n(ref), rtol=0, atol=1e-4)
    np.testing.assert_allclose(n(got), n(y), rtol=0, atol=1e-4)


@pytest.mark.parametrize("sr", [32000, 40000, 16000])
def test_moving_mean_is_numpy_same_convolve(sr):
    """The moving average's kernel (2 s / hop at the rate: 250 and 312
    frames at 32 and 40 kHz, even) aligned as np.convolve(mode="same")."""
    m = max(int(2.0 / 256 * sr), 2)
    mag = np.abs(np.random.RandomState(3).randn(1, 700, 5)).astype(np.float32)
    got = n(nr._moving_mean(torch.as_tensor(mag), m))
    ref = np.stack([np.convolve(mag[0, :, f].astype(np.float64), np.ones(m) / m, mode="same")
                    for f in range(5)], 1)[None]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _stationary_masks(x, sr):
    """The stationary mask of each package before its smoothing, on the
    signal's own statistics: (port, JAX) as 0/1 arrays."""
    win = stft.hann_window(1024)
    kw = dict(n_fft=1024, hop_length=256, win_length=1024, window=win, center=True,
              pad_mode="constant")
    X = stft.stft_complex(torch.as_tensor(x[None]), **kw)
    db = nr._amp_to_db(X.transpose(1, 2))
    thresh = db.mean(-1) + db.std(-1, correction=1) * 1.5
    port = n((db > thresh[..., None]).float())
    jX = jstft.stft_complex(jnp.asarray(x[None]), **kw).transpose(0, 2, 1)
    jdb = jnr._amp_to_db(jX)
    jthresh = jnp.mean(jdb, -1) + jnp.std(jdb, -1, ddof=1) * 1.5
    return port, np.asarray(jdb > jthresh[..., None]).astype(np.float32)


@pytest.mark.parametrize("prop", [0.7, 1.0])
@pytest.mark.parametrize("stationary", [True, False], ids=["stationary", "nonstationary"])
@pytest.mark.parametrize("sr", RATES)
def test_reduce_noise_matches_jax(sr, stationary, prop):
    x = _noisy(sr)
    got = nr.reduce_noise(x, sr, stationary=stationary, prop_decrease=prop, device="cpu")
    ref = jnr.reduce_noise(x, sr, stationary=stationary, prop_decrease=prop)
    assert got.shape == ref.shape == x.shape and got.dtype == np.float32
    err = float(np.abs(got - ref).max())
    flips = ""
    if stationary:
        pm, jm = _stationary_masks(x, sr)
        flips = f", mask bins that differ: {int((pm != jm).sum())} of {pm.size}"
    print(f"\nreduce_noise {sr} Hz stationary={stationary} prop={prop}: max abs {err:.3e}"
          + flips)
    assert err <= GATE_ATOL, err
    assert np.abs(got - x).max() > 1e-3          # the gate changed the signal


@pytest.mark.parametrize("stationary", [True, False], ids=["stationary", "nonstationary"])
def test_reduce_noise_chunked_matches_jax(stationary):
    """1.5 s at 40 kHz in 30,000-sample chunks padded by 4,000: two
    whole chunks and a short last one."""
    x = _noisy(40000, seconds=1.5, seed=4)
    kw = dict(stationary=stationary, prop_decrease=0.9, chunk_size=30000, padding=4000)
    got = nr.reduce_noise(x, 40000, device="cpu", **kw)
    ref = jnr.reduce_noise(x, 40000, **kw)
    whole = nr.reduce_noise(x, 40000, stationary=stationary, prop_decrease=0.9, device="cpu")
    assert np.abs(got - whole).max() > 1e-5      # the chunks are gated apart
    np.testing.assert_allclose(got, ref, rtol=0, atol=GATE_ATOL)


@pytest.mark.parametrize("stationary", [True, False], ids=["stationary", "nonstationary"])
def test_reduce_noise_short_clip_matches_jax(stationary):
    """0.3 s at 48 kHz padded by 3,000: 80 frames, under the 375 of the
    moving average, which is clamped to the chunk's frame count."""
    x = _noisy(48000, seconds=0.3, seed=5)
    n_frames = (len(x) + 6000) // 256 + 1
    assert n_frames < int(2.0 / 256 * 48000)
    got = nr.reduce_noise(x, 48000, stationary=stationary, padding=3000, device="cpu")
    ref = jnr.reduce_noise(x, 48000, stationary=stationary, padding=3000)
    np.testing.assert_allclose(got, ref, rtol=0, atol=GATE_ATOL)


def test_reduce_noise_noise_clip_and_batch_match_jax():
    """The stationary threshold from a separate noise clip, on a (2, L)
    batch."""
    x = np.stack([_noisy(16000, 1.0, 6), _noisy(16000, 1.0, 7)])
    noise = (np.random.RandomState(8).randn(2, 8000) * 0.05).astype(np.float32)
    got = nr.reduce_noise(x, 16000, stationary=True, y_noise=noise, device="cpu")
    ref = jnr.reduce_noise(x, 16000, stationary=True, y_noise=noise)
    assert got.shape == (2, 16000)
    np.testing.assert_allclose(got, ref, rtol=0, atol=GATE_ATOL)


def test_reduce_noise_on_a_missing_card_raises(monkeypatch):
    """The card unless the caller asks for the CPU; no card raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        nr.reduce_noise(_noisy(16000, 0.2), 16000)
    with pytest.raises(RuntimeError, match="is_available"):
        nr.reduce_noise(_noisy(16000, 0.2), 16000, device="cuda")


def test_gate_precision_policy_is_scoped_to_the_call(monkeypatch):
    """reduce_noise is a library function: it runs its convolutions on the
    card with TF32 off (`device.full_fp32`) and hands the caller's
    process-wide flags back as they were, an exception included."""
    from rvc_maker_tpu_torch import device

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with device.full_fp32(torch.device("cuda")):
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    with pytest.raises(ZeroDivisionError):
        with device.full_fp32(torch.device("cuda")):
            1 / 0
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    with device.full_fp32(torch.device("cpu")):
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    nr.reduce_noise(_noisy(16000, 0.2), 16000, device="cpu")
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
