"""The port's spectral tools (`rvc_maker_tpu_torch/pipelines/spec_tools.py`)
against JAX `rvc_maker_tpu/pipelines/spec_tools.py` on the CPU, one test
per public function of JAX's module, on seeded numpy inputs given to both
as numpy (the port with device="cpu").

Tolerances:
- spectra and waves: max abs <= 1e-5 x max(1, |ref|max); 1e-4 for
  `cmb_spectrogram_to_wave`, as JAX's own test has it;
- masks, filters, shape, index and silence helpers: equal;
- the aligner (`_realign_window`, `time_correction`, `align_audio_test`,
  `align_audio`): every lag and every choice equal (the chosen windows
  within 1e-12), the residual within 1e-6 in float64;
- written WAVs read back within 1e-5 (float32) or 1 LSB (PCM16).
"""

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from rvc_maker_tpu.pipelines import spec_tools as jst
from rvc_maker_tpu_torch.pipelines import spec_tools as pst
from torch_port_util import torch_threads  # noqa: F401

CPU = dict(device="cpu")
TOL = 1e-5


def close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, (err, tol * scale)


def rs(seed):
    return np.random.RandomState(seed)


def cplx(r, *shape, dtype=np.complex128):
    return (r.randn(*shape) + 1j * r.randn(*shape)).astype(dtype)


def song(seconds, sr=44100, seed=0, delay=0, gain=1.0):
    """(2, L) float32: harmonics with vibrato over noise bursts."""
    r = rs(seed)
    t = np.arange(int(seconds * sr)) / sr
    phase = 2 * np.pi * np.cumsum(220.0 * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))) / sr
    voice = sum(0.2 / h * np.sin(h * phase) for h in (1, 2, 3))
    noise = 0.2 * r.randn(len(t)) * np.exp(-20 * (t % 0.5))
    x = np.stack([0.7 * voice + noise, 0.4 * voice + 0.8 * noise])
    if delay:
        x = np.concatenate([np.zeros((2, delay)), x[:, :-delay]], axis=1)
    return (gain * x).astype(np.float32)


def write(path, x, sr=44100):
    wavfile.write(str(path), sr, np.ascontiguousarray(np.asarray(x, np.float32).T))
    return str(path)


def read_close(a, b, pcm=False):
    (sa, xa), (sb, xb) = wavfile.read(a), wavfile.read(b)
    assert sa == sb and xa.shape == xb.shape and xa.dtype == xb.dtype
    if pcm:
        assert np.abs(xa.astype(np.int32) - xb).max() <= 1
    else:
        close(xa, xb)


def two_band_mp(mod):
    return mod.ModelParameters({
        "bins": 1025, "pre_filter_start": 1000, "pre_filter_stop": 1020,
        "band": {
            1: {"sr": 22050, "hl": 512, "n_fft": 1024, "crop_start": 0, "crop_stop": 400,
                "lpf_start": 300, "lpf_stop": 380, "hpf_start": 0, "hpf_stop": 0},
            2: {"sr": 44100, "hl": 1024, "n_fft": 2048, "crop_start": 100, "crop_stop": 725,
                "hpf_start": 150, "hpf_stop": 100, "lpf_start": 0, "lpf_stop": 0}}})


def three_band_mp(mod, v51=False):
    cc = {"convert_channels": "mid_side_c"} if v51 else {}
    return mod.ModelParameters({
        "bins": 672, "pre_filter_start": 640, "pre_filter_stop": 660,
        "band": {
            "1": {"sr": 11025, "hl": 128, "n_fft": 512, "crop_start": 0, "crop_stop": 186,
                  "lpf_start": 37, "lpf_stop": 73, "hpf_start": 0, "hpf_stop": 0, **cc},
            "2": {"sr": 22050, "hl": 256, "n_fft": 512, "crop_start": 4, "crop_stop": 190,
                  "hpf_start": 36, "hpf_stop": 28, "lpf_start": 140, "lpf_stop": 180, **cc},
            "3": {"sr": 44100, "hl": 512, "n_fft": 1024, "crop_start": 94, "crop_stop": 394,
                  "hpf_start": 138, "hpf_stop": 120, "lpf_start": 0, "lpf_stop": 0, **cc}}})


# ------------------------------------------------------------ the boundary


def test_numpy_in_numpy_out_and_tensors_stay_tensors():
    x = song(0.3)
    got = pst.wave_to_spectrogram_no_mp(x, **CPU)
    assert isinstance(got, np.ndarray) and got.dtype == np.complex64
    t = torch.as_tensor(x)
    spec = pst.wave_to_spectrogram_no_mp(t)
    assert isinstance(spec, torch.Tensor) and spec.device.type == "cpu"
    np.testing.assert_array_equal(spec.numpy(), got)


def test_asking_for_the_card_without_one_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = song(0.2)
    with pytest.raises(RuntimeError, match="cuda"):
        pst.wave_to_spectrogram_no_mp(x)
    with pytest.raises(RuntimeError, match="cuda"):
        pst.ensembling(pst.MIN_SPEC, [x, x], is_wavs=True, device="cuda")
    f = write(tmp_path / "a.wav", song(1.0))
    with pytest.raises(RuntimeError, match="cuda"):
        pst.ensemble_inputs([f, f], pst.MAX_SPEC, 1.0, "FLOAT", str(tmp_path / "o.wav"))
    with pytest.raises(RuntimeError, match="cuda"):
        pst.align_audio(f, f, str(tmp_path / "x.wav"), str(tmp_path / "y.wav"), "FLOAT",
                        False, None, None, [], [1], (0.0, [0.0]), None, pst.POSITIVE_PHASE,
                        190, False, False)
    assert not (tmp_path / "o.wav").exists() and not (tmp_path / "y.wav").exists()


# ------------------------------------------------------------ small helpers


def test_ModelParameters():
    p = {"bins": 10, "band": {"1": {"sr": 44100}, "2": {"sr": 22050}}, "mid_side": True}
    assert pst.ModelParameters(p).param == jst.ModelParameters(p).param


def test_crop_center():
    r = rs(1)
    h1, h2 = r.randn(1, 3, 4, 20), r.randn(1, 3, 4, 12)
    np.testing.assert_array_equal(pst.crop_center(h1, h2), jst.crop_center(h1, h2))
    np.testing.assert_array_equal(pst.crop_center(h1, h1), jst.crop_center(h1, h1))
    with pytest.raises(ValueError):
        pst.crop_center(h2, h1)


def test_preprocess():
    z = cplx(rs(2), 2, 9, 7, dtype=np.complex64)
    for got, ref in zip(pst.preprocess(z, **CPU), jst.preprocess(z)):
        close(got, ref)


def test_make_padding():
    for args in [(1000, 256, 32), (777, 512, 0), (64, 64, 32)]:
        assert pst.make_padding(*args) == jst.make_padding(*args)


def test_normalize():
    r = rs(3)
    for scale in (0.3, 1.7):
        w = (r.randn(2, 1000) * scale).astype(np.float32)
        np.testing.assert_array_equal(pst.normalize(w.copy()), jst.normalize(w.copy()))
        np.testing.assert_array_equal(pst.normalize(w.copy(), 0.9), jst.normalize(w.copy(), 0.9))


def test_auto_transpose():
    r = rs(4)
    for a in (r.randn(100, 2), r.randn(2, 100)):
        np.testing.assert_array_equal(pst.auto_transpose(a), jst.auto_transpose(a))


def test_write_array_to_mem():
    a = (rs(5).randn(1000, 2) * 0.6).astype(np.float32)
    for subtype in ("FLOAT", "PCM_16"):
        assert pst.write_array_to_mem(a, subtype).read() == jst.write_array_to_mem(a, subtype).read()
    assert pst.write_array_to_mem("p.wav") == "p.wav"


def test_spectrogram_to_image():
    spec = cplx(rs(6), 2, 64, 40)
    for mode in ("magnitude", "phase"):
        np.testing.assert_array_equal(pst.spectrogram_to_image(spec, mode),
                                      jst.spectrogram_to_image(spec, mode))
        np.testing.assert_array_equal(pst.spectrogram_to_image(spec[0], mode),
                                      jst.spectrogram_to_image(spec[0], mode))


def test_reduce_vocal_aggressively():
    r = rs(7)
    X, y = cplx(r, 2, 65, 30, dtype=np.complex64), cplx(r, 2, 65, 30, dtype=np.complex64)
    close(pst.reduce_vocal_aggressively(X, y, 0.2, **CPU), jst.reduce_vocal_aggressively(X, y, 0.2))


def test_merge_artifacts():
    mask = rs(8).rand(2, 16, 600).astype(np.float32)
    mask[:, :, 100:300] = 0.5
    mask[:, :, 350:360] = 0.001
    for kw in (dict(thres=0.01, min_range=64, fade_size=32), dict(min_range=10, fade_size=32)):
        np.testing.assert_array_equal(pst.merge_artifacts(mask.copy(), **kw),
                                      jst.merge_artifacts(mask.copy(), **kw))


def test_align_wave_head_and_tail():
    r = rs(9)
    a, b = r.randn(50, 2), r.randn(40, 2)
    for got, ref in zip(pst.align_wave_head_and_tail(a, b), jst.align_wave_head_and_tail(a, b)):
        np.testing.assert_array_equal(got, ref)


# -------------------------------------------------- multi-band (VR) tools


@pytest.mark.parametrize("cc", ["mid_side_c", "mid_side", "stereo_n", None])
def test_convert_channels(cc):
    spec = cplx(rs(10), 2, 33, 12, dtype=np.complex64)
    mp = {"band": {1: {"convert_channels": cc}}}
    close(pst.convert_channels(spec, mp, 1, **CPU), jst.convert_channels(spec, mp, 1))


@pytest.mark.parametrize("case", ["two-band", "one-band", "v51"])
def test_combine_spectrograms(case):
    r = rs(11)
    t = 24
    if case == "two-band":
        mps = two_band_mp(pst), two_band_mp(jst)
        specs = {1: cplx(r, 2, 513, t, dtype=np.complex64),
                 2: cplx(r, 2, 1025, t + 3, dtype=np.complex64)}
    else:
        p = {"bins": 512, "pre_filter_start": 400, "pre_filter_stop": 480,
             "band": {1: {"crop_start": 0, "crop_stop": 500}}}
        mps = pst.ModelParameters(p), jst.ModelParameters(p)
        specs = {1: cplx(r, 2, 513, t, dtype=np.complex64)}
    v51 = case == "v51"
    got = pst.combine_spectrograms({k: v.copy() for k, v in specs.items()}, mps[0], v51, **CPU)
    ref = jst.combine_spectrograms({k: v.copy() for k, v in specs.items()}, mps[1], v51)
    assert got.dtype == ref.dtype
    close(got, ref)


@pytest.mark.parametrize("mode", ["plain", "reverse", "mid_side", "mid_side_b2", "v51", "no-mp"])
def test_wave_to_spectrogram(mode):
    wave = (rs(12).randn(2, 16384) * 0.3).astype(np.float32)
    mp = pst.ModelParameters({"bins": 1025, "band": {1: {"convert_channels": "stereo_n"}},
                              "reverse": mode == "reverse", "mid_side": mode == "mid_side",
                              "mid_side_b2": mode == "mid_side_b2"})
    args = (wave, 512, 1024, None if mode == "no-mp" else mp, 1, mode == "v51")
    got = pst.wave_to_spectrogram(*args, **CPU)
    ref = jst.wave_to_spectrogram(*args)
    assert got.dtype == ref.dtype == np.complex64
    close(got, ref)
    close(pst.wave_to_spectrogram(wave[0], **CPU), jst.wave_to_spectrogram(wave[0]))


@pytest.mark.parametrize("mode", ["plain", "reverse", "mid_side", "mid_side_b2", "v51", "no-mp"])
def test_spectrogram_to_wave(mode):
    r = rs(13)
    spec = jst.wave_to_spectrogram((r.randn(2, 16384) * 0.3).astype(np.float32), 512, 1024)
    mp = pst.ModelParameters({"bins": 512, "band": {1: {"convert_channels": "mid_side_c"}},
                              "reverse": mode == "reverse", "mid_side": mode == "mid_side",
                              "mid_side_b2": mode == "mid_side_b2"})
    args = (spec, 512, None if mode == "no-mp" else mp, 1, mode == "v51")
    got = pst.spectrogram_to_wave(*args, **CPU)
    ref = jst.spectrogram_to_wave(*args)
    assert got.dtype == ref.dtype == np.float32
    close(got, ref)
    close(pst.spectrogram_to_wave(spec[0], 512, length=9000, **CPU),
          jst.spectrogram_to_wave(spec[0], 512, length=9000))


@pytest.mark.parametrize("case", ["two-band", "three-band", "three-band-v51", "high-end"])
def test_cmb_spectrogram_to_wave(case):
    """The combined spectrogram of JAX's own test and of a three-band set,
    legacy and v5.1, and with a grafted high end: 1e-4 x max(1, |ref|)."""
    r = rs(14)
    if case == "two-band":
        mps = two_band_mp(pst), two_band_mp(jst)
    else:
        mps = three_band_mp(pst, case == "three-band-v51"), three_band_mp(jst, case == "three-band-v51")
    p = mps[1].param
    t = 20
    specs = {b: cplx(r, 2, p["band"][b]["n_fft"] // 2 + 1, t, dtype=np.complex64)
             for b in p["band"]}
    v51 = case == "three-band-v51"
    comb = jst.combine_spectrograms(specs, mps[1], v51)
    kw = {}
    if case == "high-end":
        kw = dict(extra_bins_h=12, extra_bins=cplx(r, 2, 20, t, dtype=np.complex64))
    got = pst.cmb_spectrogram_to_wave(comb.copy(), mps[0], is_v51_model=v51, **kw, **CPU)
    ref = jst.cmb_spectrogram_to_wave(comb.copy(), mps[1], is_v51_model=v51, **kw)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    close(got, ref, 1e-4)


def test_get_lp_filter_mask():
    for args in [(1025, 300, 400), (513, 10, 11), (64, 1, 64)]:
        np.testing.assert_array_equal(pst.get_lp_filter_mask(*args), jst.get_lp_filter_mask(*args))


def test_get_hp_filter_mask():
    for args in [(1025, 150, 99), (513, 40, 39), (64, 10, 0)]:
        np.testing.assert_array_equal(pst.get_hp_filter_mask(*args), jst.get_hp_filter_mask(*args))


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_fft_lp_filter(dtype):
    spec = cplx(rs(15), 2, 513, 20, dtype=dtype)
    for a, b in [(300, 400), (200, 200), (0, 513)]:
        np.testing.assert_array_equal(pst.fft_lp_filter(spec.copy(), a, b, **CPU),
                                      jst.fft_lp_filter(spec.copy(), a, b))


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_fft_hp_filter(dtype):
    spec = cplx(rs(16), 2, 513, 20, dtype=dtype)
    for a, b in [(150, 99), (40, 40), (512, 0)]:
        np.testing.assert_array_equal(pst.fft_hp_filter(spec.copy(), a, b, **CPU),
                                      jst.fft_hp_filter(spec.copy(), a, b))


def test_fft_filters_write_a_tensor_in_place():
    spec = torch.as_tensor(cplx(rs(17), 2, 65, 4))
    out = pst.fft_lp_filter(spec, 20, 40)
    assert out is spec and bool((spec[:, 40:] == 0).all())


def test_spectrogram_to_wave_old():
    spec = jst.stft((rs(18).randn(2, 8192) * 0.3).astype(np.float32), 1024, 256)
    close(pst.spectrogram_to_wave_old(spec, 256, **CPU), jst.spectrogram_to_wave_old(spec, 256))
    close(pst.spectrogram_to_wave_old(spec[1], 256, **CPU), jst.spectrogram_to_wave_old(spec[1], 256))


def test_wave_to_spectrogram_old():
    w = (rs(19).randn(2, 8192) * 0.3).astype(np.float32)
    close(pst.wave_to_spectrogram_old(w, 256, 1024, **CPU), jst.wave_to_spectrogram_old(w, 256, 1024))


def test_mirroring():
    r = rs(20)
    mp = {"bins": 512, "band": {}, "pre_filter_start": 400, "pre_filter_stop": 500}
    spec_m = cplx(r, 2, 513, 10)
    high = cplx(r, 2, 50, 10)
    for mode in ("mirroring", "mirroring2", "none"):
        close(pst.mirroring(mode, spec_m, high, mp, **CPU), jst.mirroring(mode, spec_m, high, mp))


def test_adjust_aggr():
    mask = rs(21).rand(2, 100, 8).astype(np.float32)
    for aggr, stem in [({"value": 0.3, "split_bin": 40,
                         "aggr_correction": {"left": 0.05, "right": -0.05}}, False),
                       ({"value": 0.2, "split_bin": 10, "aggr_correction": None}, True),
                       ({"value": 0.0, "split_bin": 10, "aggr_correction": None}, True)]:
        close(pst.adjust_aggr(mask.copy(), stem, dict(aggr), **CPU),
              jst.adjust_aggr(mask.copy(), stem, dict(aggr)))


def test_stft():
    w = (rs(22).randn(2, 10000) * 0.3).astype(np.float32)
    close(pst.stft(w, 2048, 1024, **CPU), jst.stft(w, 2048, 1024))


def test_istft():
    spec = cplx(rs(23), 2, 1025, 14, dtype=np.complex64) * 3
    close(pst.istft(spec, 1024, **CPU), jst.istft(spec, 1024))


@pytest.mark.parametrize("alg,val", [("Min_Mag", None), ("Max_Mag", None), ("Default", 0.25),
                                     ("Invert_p", None)])
def test_spec_effects(alg, val):
    r = rs(24)
    pair = [(r.randn(2, 8192) * 0.3).astype(np.float32) for _ in range(2)]
    close(pst.spec_effects([p.copy() for p in pair], alg, val, **CPU),
          jst.spec_effects([p.copy() for p in pair], alg, val))


def test_spectrogram_to_wave_no_mp():
    spec = jst.wave_to_spectrogram_no_mp(song(0.5))
    close(pst.spectrogram_to_wave_no_mp(spec, **CPU), jst.spectrogram_to_wave_no_mp(spec))
    close(pst.spectrogram_to_wave_no_mp(spec[0], length=20000, **CPU),
          jst.spectrogram_to_wave_no_mp(spec[0], length=20000))


def test_wave_to_spectrogram_no_mp():
    w = song(0.5)
    close(pst.wave_to_spectrogram_no_mp(w, **CPU), jst.wave_to_spectrogram_no_mp(w))
    close(pst.wave_to_spectrogram_no_mp(w[0], **CPU), jst.wave_to_spectrogram_no_mp(w[0]))


def test_invert_audio():
    r = rs(25)
    a, b = cplx(r, 2, 65, 30), cplx(r, 2, 65, 28)
    for invert_p in (True, False):
        close(pst.invert_audio([a.copy(), b.copy()], invert_p, **CPU),
              jst.invert_audio([a.copy(), b.copy()], invert_p))


def test_invert_stem():
    mix = song(1.0, seed=1).astype(np.float64)
    stem = 0.5 * song(1.0, seed=2).astype(np.float64)
    close(pst.invert_stem(mix, stem, **CPU), jst.invert_stem(mix, stem))


def test_ensembling():
    """Every choice equal: the result is JAX's, element for element."""
    r = rs(26)
    specs = [cplx(r, 2, 33, 20 + i) for i in range(3)]
    specs.append(specs[0].copy())                    # exact ties: the later input wins
    waves = [r.randn(2, 500 + i * 7) for i in range(3)]
    for alg in (pst.MIN_SPEC, pst.MAX_SPEC, "Other"):
        np.testing.assert_array_equal(pst.ensembling(alg, [s.copy() for s in specs], **CPU),
                                      jst.ensembling(alg, [s.copy() for s in specs]))
        np.testing.assert_array_equal(
            pst.ensembling(alg, [w.copy() for w in waves], is_wavs=True, **CPU),
            jst.ensembling(alg, [w.copy() for w in waves], is_wavs=True))


def test_ensembling_float32_ties():
    """complex64 spectra whose |z| round to the same float32 while their
    float64 |z| differ (5 against 5 + 1e-11 to 1e-9): JAX compares np.abs in
    float32, so the later input wins those ties, in both directions."""
    r = rs(27)
    exact = np.full((2, 9, 12), 3 + 4j, np.complex64)            # |z| == 5
    near = (5 + 1j * r.uniform(1e-5, 1e-4, exact.shape)).astype(np.complex64)
    near[:, :3] += 0.01                                          # no tie here
    assert (np.abs(near[:, 3:]) == np.abs(exact[:, 3:])).all()
    assert (near[:, 3:].real.astype(np.float64) ** 2
            + near[:, 3:].imag.astype(np.float64) ** 2 > 25).all()
    for alg in (pst.MIN_SPEC, pst.MAX_SPEC):
        for pair in ([exact, near], [near, exact]):
            got = pst.ensembling(alg, [p.copy() for p in pair], **CPU)
            ref = jst.ensembling(alg, [p.copy() for p in pair])
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(got[:, 3:], pair[1][:, 3:])


def test_ensemble_for_align():
    waves = [song(1.0, seed=3).T, (0.8 * song(1.0, seed=4)).T[:40000]]
    close(pst.ensemble_for_align(waves, **CPU), jst.ensemble_for_align([w.copy() for w in waves]))


@pytest.mark.parametrize("alg,is_wave,wav_type", [
    (pst.MAX_SPEC, False, "FLOAT"), (pst.MIN_SPEC, False, "PCM_16"),
    (pst.AVERAGE, False, "FLOAT"), (pst.MIN_SPEC, True, "FLOAT")])
def test_ensemble_inputs(tmp_path, alg, is_wave, wav_type):
    """Three files (one shorter, one at 48 kHz), the written WAVs."""
    paths = [write(tmp_path / "a.wav", song(1.0, seed=5)),
             write(tmp_path / "b.wav", 0.7 * song(0.8, seed=6)),
             write(tmp_path / "c.wav", 0.9 * song(1.0, sr=48000, seed=7), sr=48000)]
    out_p, out_j = str(tmp_path / "p.wav"), str(tmp_path / "j.wav")
    pst.ensemble_inputs(paths, alg, 1.0, wav_type, out_p, is_wave=is_wave, **CPU)
    jst.ensemble_inputs(paths, alg, 1.0, wav_type, out_j, is_wave=is_wave)
    read_close(out_p, out_j, pcm=wav_type != "FLOAT")


# ------------------------------------------------- shape and file helpers


def test_to_shape():
    x = rs(27).randn(2, 80)
    np.testing.assert_array_equal(pst.to_shape(x, (2, 100)), jst.to_shape(x, (2, 100)))


def test_to_shape_minimize():
    x = rs(28).randn(2, 80)
    np.testing.assert_array_equal(pst.to_shape_minimize(x, (3, 90)), jst.to_shape_minimize(x, (3, 90)))


def test_detect_leading_silence():
    audio = np.zeros(8000, np.float32)
    audio[3000:] = 0.4
    for a in (audio, np.stack([audio, audio * 0.5]), np.zeros(100, np.float32)):
        assert pst.detect_leading_silence(a, 16000) == jst.detect_leading_silence(a, 16000)


def test_adjust_leading_silence():
    a = np.zeros(8000, np.float32)
    a[3000:] = 0.4
    b = np.zeros(8000, np.float32)
    b[1000:] = 0.4
    for x, y in ((b, a), (a, b), (a, a), (np.stack([a, a]), np.stack([b, b])),
                 (np.stack([b, b]), np.stack([a, a]))):
        np.testing.assert_array_equal(pst.adjust_leading_silence(x.copy(), y.copy()),
                                      jst.adjust_leading_silence(x.copy(), y.copy()))


def test_match_array_shapes():
    r = rs(29)
    a, b = r.randn(2, 50), r.randn(2, 70)
    for x, y, swap in ((a, b, False), (b, a, False), (a.T, b.T, True), (b.T, a.T, True)):
        np.testing.assert_array_equal(pst.match_array_shapes(x.copy(), y, swap),
                                      jst.match_array_shapes(x.copy(), y, swap))


def test_match_mono_array_shapes():
    r = rs(30)
    m1, m2 = r.randn(50), r.randn(70)
    for x, y in ((m1, m2), (m2, m1), (m1, m1)):
        np.testing.assert_array_equal(pst.match_mono_array_shapes(x.copy(), y),
                                      jst.match_mono_array_shapes(x.copy(), y))


def test_change_pitch_semitones():
    y = song(0.5, sr=22050)
    for shift in (12.0, -3.5):
        got, sr_p = pst.change_pitch_semitones(y, 22050, shift)
        ref, sr_j = jst.change_pitch_semitones(y, 22050, shift)
        assert sr_p == sr_j
        close(got, ref)


@pytest.mark.parametrize("kw", [dict(rate=2.0), dict(rate=12.0, is_pitch=True),
                                dict(rate=12.0, is_time_correction=False)],
                         ids=["tempo", "pitch", "semitones"])
def test_augment_audio(tmp_path, kw):
    src = write(tmp_path / "in.wav", song(1.0, seed=8))
    rate = kw.pop("rate")
    pst.augment_audio(str(tmp_path / "p.wav"), src, rate, 1.0, "FLOAT", **kw)
    jst.augment_audio(str(tmp_path / "j.wav"), src, rate, 1.0, "FLOAT", **kw)
    read_close(str(tmp_path / "p.wav"), str(tmp_path / "j.wav"))


def test_average_audio(tmp_path):
    paths = [write(tmp_path / "a.wav", song(1.0, seed=9)),
             write(tmp_path / "b.wav", song(0.7, seed=10))]
    np.testing.assert_array_equal(pst.average_audio(paths), jst.average_audio(paths))


def test_average_dual_sources():
    r = rs(31)
    a, b = r.randn(2, 100), r.randn(2, 80)
    np.testing.assert_array_equal(pst.average_dual_sources(a, b, 0.3),
                                  jst.average_dual_sources(a, b, 0.3))
    np.testing.assert_array_equal(pst.average_dual_sources(b, a, 0.3),
                                  jst.average_dual_sources(b, a, 0.3))


def test_reshape_sources():
    r = rs(32)
    a, b, c = r.randn(2, 100), r.randn(2, 80), r.randn(2, 130)
    for x, y in ((a, b), (a, c), (a, a)):
        np.testing.assert_array_equal(pst.reshape_sources(x, y), jst.reshape_sources(x, y))


def test_reshape_sources_ref():
    b = rs(33).randn(2, 80)
    for shape in ((2, 120), (2, 60)):
        np.testing.assert_array_equal(pst.reshape_sources_ref(shape, b),
                                      jst.reshape_sources_ref(shape, b))


def test_combine_arrarys():
    r = rs(34)
    srcs = [r.randn(2, 60), r.randn(2, 100), r.randn(2, 80)]
    np.testing.assert_array_equal(pst.combine_arrarys([s.copy() for s in srcs]),
                                  jst.combine_arrarys([s.copy() for s in srcs]))


def test_combine_audio(tmp_path):
    paths = [write(tmp_path / "a.wav", song(1.0, seed=11)),
             write(tmp_path / "b.wav", song(0.6, seed=12))]
    pst.combine_audio(paths, str(tmp_path / "p"), "FLOAT")
    jst.combine_audio(paths, str(tmp_path / "j"), "FLOAT")
    read_close(str(tmp_path / "p_combined.wav"), str(tmp_path / "j_combined.wav"))


def test_reduce_mix_bv():
    r = rs(35)
    inst, voc = r.randn(100, 2), r.randn(80, 2)
    np.testing.assert_array_equal(pst.reduce_mix_bv(inst, voc, 0.7), jst.reduce_mix_bv(inst, voc, 0.7))


def test_organize_inputs():
    files = ["a_(Vocals).wav", "x_RVC_out.wav", "reverbed_stem.wav", "b_(Instrumental).wav", "z"]
    assert pst.organize_inputs(files) == jst.organize_inputs(files)


def test_load_audio(tmp_path):
    for sr, x in ((44100, song(0.5)), (48000, song(0.5, sr=48000)[0])):
        f = write(tmp_path / f"{sr}.wav", x, sr=sr)
        np.testing.assert_array_equal(pst.load_audio(f), jst.load_audio(f))


def test_load_audio_maybe_mono(tmp_path):
    for sr, x in ((44100, song(0.5)[0]), (32000, song(0.5, sr=32000))):
        f = write(tmp_path / f"{sr}.wav", x, sr=sr)
        np.testing.assert_array_equal(pst.load_audio_maybe_mono(f), jst.load_audio_maybe_mono(f))


def test_time_stretch():
    tone = song(1.0, sr=22050)[0]
    for rate in (2.0, 0.8, 1.0):
        close(pst.time_stretch(tone, 22050, rate), jst.time_stretch(tone, 22050, rate))
    with pytest.raises(ValueError):
        pst.time_stretch(tone, 22050, 0.0)


def test_pitch_shift():
    tone = song(0.5, sr=22050)[0]
    for steps in (12.0, -5.0, 0):
        close(pst.pitch_shift(tone, 22050, steps), jst.pitch_shift(tone, 22050, steps))


# ---------------------------------------------------------------- the aligner


def test_check_if_phase_inverted():
    w1 = rs(36).randn(2, 2000)
    for a, b, mono in ((w1, -w1, False), (w1, w1, False), (w1[0], -w1[0], True),
                       (w1, np.zeros_like(w1), False)):
        assert pst.check_if_phase_inverted(a, b, mono, **CPU) == \
            bool(jst.check_if_phase_inverted(a, b, mono))


def test_phase_shift_hilbert():
    r = rs(37)
    for sig in (r.randn(1024), r.randn(1023), r.randn(3, 500)):
        for deg in (45, 90, -60):
            close(pst.phase_shift_hilbert(sig, deg, **CPU), jst.phase_shift_hilbert(sig, deg), 1e-12)


def test_get_phase_shifted_tracks():
    sig = rs(38).randn(1024)
    for shift in (180, 90, 45, 70):
        got = pst.get_phase_shifted_tracks(sig, shift, **CPU)
        ref = jst.get_phase_shifted_tracks(sig, shift)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            close(g, r, 1e-12)


def test_xcorr_lag_matches_np_correlate():
    r = rs(39)
    for na, nb in ((1000, 1000), (700, 300), (301, 900)):
        a, b = r.randn(na), r.randn(nb)
        got = pst._xcorr_full(torch.as_tensor(a), torch.as_tensor(b)).numpy()
        np.testing.assert_allclose(got, np.correlate(a, b, "full"), atol=1e-10)
    a = r.randn(4000)
    b = np.concatenate([np.zeros(123), a[:-123]])
    assert pst._xcorr_lag(a, b, **CPU) == jst._xcorr_lag(a, b) == -123


@pytest.mark.parametrize("phase_shifts,gains", [(190, [0.0]), (180, [-0.5, 0.0, 0.5]),
                                                (45, [0.0, 1.0])])
def test_realign_window_choices(phase_shifts, gains):
    """Each of 12 windows: the chosen rolled variant is JAX's (every lag
    and every choice equal), batched and one window at a time, and in
    chunks of one window."""
    r = rs(40)
    w = 1500
    ref = r.randn(12, w)
    tgt = np.stack([np.roll(ref[i], -(17 * i - 60)) * 10 ** (-0.5 / 20) * (-1) ** i
                    + 0.05 * r.randn(w) for i in range(12)])
    tgt[3] = 0.0                                      # silence: every variant ties
    db = (0.3, gains)
    want = np.stack([jst._realign_window(ref[i], tgt[i], db, phase_shifts) for i in range(12)])
    got = pst._realign_window(ref, tgt, db, phase_shifts, **CPU)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(pst._realign_window(ref[5], tgt[5], db, phase_shifts, **CPU),
                               want[5], rtol=0, atol=1e-12)
    old = pst.XCORR_BATCH_BYTES
    pst.XCORR_BATCH_BYTES = 1
    try:
        np.testing.assert_allclose(pst._realign_window(ref, tgt, db, phase_shifts, **CPU), want,
                                   rtol=0, atol=1e-12)
    finally:
        pst.XCORR_BATCH_BYTES = old


@pytest.mark.parametrize("case", ["jax-test", "stereo-float32", "mono-three-windows"])
def test_time_correction(case):
    """JAX's own case, a stereo float32 take with gains and phase
    variants, and three window sizes (odd windows overlap 3 deep): the
    residual within 1e-6, and the progress ticks JAX gives."""
    r = rs(41)
    sr = 4000
    if case == "jax-test":
        mix = r.randn(sr * 2) * 0.3
        inst = np.roll(mix, 37) + r.randn(sr * 2) * 0.01
        kw = dict(align_window=[0.5], db_analysis=(0.0, [0.0]), phase_shifts=190)
    elif case == "stereo-float32":
        mix = (r.randn(sr * 2, 2) * 0.3).astype(np.float32)
        inst = (-0.9 * np.roll(mix, 21, axis=0) + r.randn(sr * 2, 2) * 0.01).astype(np.float32)
        kw = dict(align_window=[0.25, 0.5], db_analysis=(0.0, [-0.5, 0.0, 0.5]),
                  phase_shifts=180)
    else:
        mix = r.randn(sr * 3) * 0.3
        inst = np.roll(mix, -11) * 1.1 + r.randn(sr * 3) * 0.02
        kw = dict(align_window=[0.0625, 0.1251, 0.25], db_analysis=(0.5, [0.0, -1.0]),
                  phase_shifts=90)
    ticks = {"p": [], "j": []}
    got = pst.time_correction(mix.copy(), inst.copy(), 2, sr=sr, unique_sources=2,
                              progress_bar=ticks["p"].append, **kw, **CPU)
    ref = jst.time_correction(mix.copy(), inst.copy(), 2, sr=sr, unique_sources=2,
                              progress_bar=ticks["j"].append, **kw)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert ticks["p"] == ticks["j"]


def test_ensemble_wav():
    r = rs(42)
    waves = [r.randn(4800) * s for s in (1.0, 0.5, 2.0)]
    for split in (12, 240, 7):
        np.testing.assert_array_equal(pst.ensemble_wav([w.copy() for w in waves], split, **CPU),
                                      jst.ensemble_wav([w.copy() for w in waves], split))
    stereo = [r.randn(1001, 2) * s for s in (1.0, 1.0, 0.3)]
    stereo[1][:500] = stereo[0][:500]                 # equal chunks: the first wins
    np.testing.assert_array_equal(pst.ensemble_wav(stereo, 12, **CPU), jst.ensemble_wav(stereo, 12))


def test_ensemble_wav_min():
    r = rs(43)
    waves = [r.randn(4800 - 13 * i) * s for i, s in enumerate((1.0, 0.5, 2.0))]
    np.testing.assert_array_equal(pst.ensemble_wav_min([w.copy() for w in waves], **CPU),
                                  jst.ensemble_wav_min([w.copy() for w in waves]))


def test_align_audio_test():
    base = (rs(44).randn(2, 44100 * 3) * 0.3).astype(np.float32)
    for lag in (500, 0):
        shifted = np.concatenate([np.zeros((2, lag), np.float32), base[:, :base.shape[1] - lag]], 1)
        np.testing.assert_array_equal(pst.align_audio_test(base, shifted, **CPU),
                                      jst.align_audio_test(base.copy(), shifted.copy()))
    mono = base[:1]
    early = np.concatenate([mono[:, 200:], np.zeros((1, 200), np.float32)], 1)
    np.testing.assert_array_equal(pst.align_audio_test(mono, early, **CPU),
                                  jst.align_audio_test(mono.copy(), early.copy()))


@pytest.mark.parametrize("case", ["windows-spec-match", "no-windows", "mono-auto-phase",
                                  "silence-negative"])
def test_align_audio(tmp_path, case):
    """align_audio end to end on both packages: the aligned take and the
    residual they write, within 1e-5 (float32) or 1 LSB (PCM16)."""
    sr = 44100
    mix = song(3.0, seed=45)
    take = song(3.0, seed=45, delay=300, gain=10 ** (-0.5 / 20))
    kw = dict(wav_type_set="FLOAT", is_save_aligned=True, command_Text=None, save_format=None,
              align_window=[0.25, 0.5], align_intro_val=[1, 2],
              db_analysis=(0.0, [-0.5, 0.0, 0.5]), set_progress_bar=None,
              phase_option=pst.AUTO_PHASE, phase_shifts=180, is_match_silence=False,
              is_spec_match=True)
    if case == "no-windows":
        kw.update(align_window=[], is_spec_match=False, wav_type_set="PCM_16",
                  phase_option=pst.POSITIVE_PHASE)
    elif case == "mono-auto-phase":
        mix, take = mix[0], -take[0]
        kw.update(is_spec_match=False, phase_shifts=190)
    elif case == "silence-negative":
        mix[:, :5000] = 0
        take = -song(3.0, seed=45, delay=1300, gain=0.9)
        take[:, :6000] = 0
        kw.update(phase_option=pst.NEGATIVE_PHASE, is_match_silence=True,
                  align_window=[0.5], db_analysis=(0.0, [0.0]))
    f1, f2 = write(tmp_path / "mix.wav", mix, sr), write(tmp_path / "take.wav", take, sr)
    out = {k: (str(tmp_path / f"{k}_aligned.wav"), str(tmp_path / f"{k}_sub.wav"))
           for k in ("p", "j")}
    ticks = {"p": [], "j": []}
    pst.align_audio(f1, f2, *out["p"], **dict(kw, set_progress_bar=lambda *a: ticks["p"].append(a)),
                    **CPU)
    jst.align_audio(f1, f2, *out["j"], **dict(kw, set_progress_bar=lambda *a: ticks["j"].append(a)))
    pcm = kw["wav_type_set"] != "FLOAT"
    read_close(out["p"][0], out["j"][0], pcm)
    read_close(out["p"][1], out["j"][1], pcm)
    assert ticks["p"] == ticks["j"]
    if case == "windows-spec-match":
        # the recovered take cancels the mix: a residual near silence
        assert np.abs(wavfile.read(out["p"][1])[1]).mean() < 1e-3
