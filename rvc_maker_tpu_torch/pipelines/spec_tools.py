"""Separation spectral tools (counterpart of JAX `pipelines/spec_tools.py`,
itself the reference uvr5_separator/spec_utils.py): the STFT pair, the
VR multi-band tools, min/max-magnitude ensembling, the spectral inversion
of a stem, and the aligner with its windowed `time_correction`.

Names, argument order and defaults are JAX's.  The spectral functions
run in torch on a `device` keyword: numpy arrays go to `device` (the
card when it is not given; a card that is not there raises) and the
result comes back as numpy; tensors stay where they are unless `device`
names another place, and the result stays a tensor.

- The STFT core computes what JAX `_stft_np` / `_istft_np` compute
  (centred, constant pad, periodic Hann, the squared-window
  normalisation with its 1e-11 floor summed in float64).  Its FFTs run
  in float64, and the forward spectrum is rounded to complex64 as JAX's
  is: the card and the CPU then give the same complex64 bins, so a
  min/max-magnitude choice between two spectra does not flip between
  devices.  For the same reason every magnitude comparison reads |z| as
  numpy's `np.abs` gives it (`_mag`): for complex64, the float64 square
  root of re^2 + im^2 rounded to float32, which IEEE rounding makes the
  same on both devices, so ties in float32 fall as they fall in JAX.
- The aligner batches every window of one size, for every phase variant,
  into float64 FFT cross-correlations on the device (`_realign_window`),
  under `XCORR_BATCH_BYTES` a chunk.  A correlation is linear in the
  gain, so the lag is the same for every gain and the FFTs run once per
  variant; the gains enter the residual, and the choice goes gains
  outer, variants inner, with the first minimum winning, as in JAX.

On the host, copied as JAX has them: `ModelParameters`, the shape,
silence and source-combination helpers, the filter masks (columns of
constants), `merge_artifacts`, the file I/O (`utils/audio.py`), and the
band-to-band `_resample` (scipy `resample_poly`).  `time_stretch` and
`pitch_shift` are the phase vocoders of `utils/tts.py` and
`utils/pitchshift.py`.
"""

from __future__ import annotations

import functools
import io
import logging
import math
from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import resample_poly

from ..device import resolve_device
from ..utils.audio import read_wav as _read_wav_file
from ..utils.audio import save_wav as _save_wav

logger = logging.getLogger(__name__)

N_FFT = 2048
HOP = 1024

AUTO_PHASE = "Automatic"
POSITIVE_PHASE = "Positive Phase"
NEGATIVE_PHASE = "Negative Phase"
NONE_P = ("None",)
MAX_SPEC = "Max Spec"
MIN_SPEC = "Min Spec"
LIN_ENSE = "Linear Ensemble"
MAX_WAV = MAX_SPEC
MIN_WAV = MIN_SPEC
AVERAGE = "Average"

# the aligner's cross-correlation batch: the largest complex128 spectrum
# one chunk of windows holds (936 windows x variants at 20 s of stereo
# and a 0.5 s window are 0.5 GiB)
XCORR_BATCH_BYTES = 1 << 30


# ------------------------------------------------------ the device boundary


def _any_numpy(tree) -> bool:
    if isinstance(tree, np.ndarray):
        return True
    if isinstance(tree, (list, tuple)):
        return any(_any_numpy(v) for v in tree)
    if isinstance(tree, dict):
        return any(_any_numpy(v) for v in tree.values())
    return False


def _to_dev(tree, dev: torch.device):
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(np.ascontiguousarray(tree), device=dev)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_dev(v, dev) for v in tree)
    if isinstance(tree, dict):
        return {k: _to_dev(v, dev) for k, v in tree.items()}
    return tree


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _spectral(fn):
    """The public form of a spectral function (module docstring): its
    array arguments, and lists, tuples and dicts of them, go to `device`;
    numpy in, numpy out."""
    @functools.wraps(fn)
    def wrapper(*args, device=None, **kw):
        host = _any_numpy((args, kw))
        if device is None and not host:
            return fn(*args, **kw)
        dev = resolve_device("cuda" if device is None else device)
        out = fn(*_to_dev(args, dev), **_to_dev(kw, dev))
        return _to_host(out) if host else out
    return wrapper


def _T(x: torch.Tensor) -> torch.Tensor:
    """numpy's `.T` for any number of dimensions."""
    return x.permute(*reversed(range(x.ndim)))


def _mag(z: torch.Tensor) -> torch.Tensor:
    """|z| in the precision numpy's np.abs gives it, the key of every
    magnitude comparison: complex64 -> float32 (re^2 and im^2 are exact
    in float64, their sum rounds once, and its square root is rounded to
    float32, as numpy's hypotf rounds |z|), complex128 ->
    float64 hypot, a real tensor's own abs."""
    if z.dtype == torch.complex64:
        return torch.sqrt(z.real.double().square() + z.imag.double().square()).float()
    if z.is_complex():
        return torch.hypot(z.real, z.imag)
    return z.abs()


def _unit_phase(z: torch.Tensor) -> torch.Tensor:
    """numpy's exp(1j * angle(z))."""
    return torch.exp(1j * torch.angle(z))


def _scale(x: torch.Tensor, g) -> torch.Tensor:
    """x * g computed in g's (float64) precision and stored in x's dtype,
    as numpy's in-place multiply of a float32 array by a float64 one."""
    return (x * g).to(x.dtype)


def _fit_time(x: torch.Tensor, n: int) -> torch.Tensor:
    """Trim or zero-pad axis 0 to n (match_array_shapes(..., is_swap=True)
    and match_mono_array_shapes on the device)."""
    if x.shape[0] > n:
        return x[:n]
    if x.shape[0] < n:
        return torch.cat([x, x.new_zeros((n - x.shape[0],) + tuple(x.shape[1:]))])
    return x


def _pad_to(x: torch.Tensor, shape) -> torch.Tensor:
    """`to_shape` on the device: zero-pad every axis up to `shape`."""
    pads = []
    for s, t in reversed(list(zip(x.shape, shape))):
        pads += [0, t - s]
    return F.pad(x, pads)


# ---------------------------------------------------------------- STFT core


def _hann(n: int) -> np.ndarray:
    # periodic hann: librosa's get_window("hann", n, fftbins=True)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def _stft(wave: torch.Tensor, n_fft: int = N_FFT, hop: int = HOP) -> torch.Tensor:
    """librosa.stft (center=True, constant pad).  (L,) -> (F, T) or
    (C, L) -> (C, F, T), complex64."""
    x = wave.to(torch.float32)
    mono = x.ndim == 1
    if mono:
        x = x[None]
    pad = n_fft // 2
    x = F.pad(x, (pad, pad))
    win = torch.as_tensor(_hann(n_fft).astype(np.float32), device=x.device)
    frames = x.unfold(-1, n_fft, hop) * win                         # (C, T, n_fft)
    z = torch.fft.rfft(frames.double(), dim=-1).to(torch.complex64).transpose(1, 2)
    return z[0] if mono else z


def _istft(spec: torch.Tensor, hop: int = HOP, length: int | None = None) -> torch.Tensor:
    """librosa.istft (centred, squared-window normalisation).  (F, T) ->
    (L,) or (C, F, T) -> (C, L), float32.  The spectrum is read as
    Hermitian: the imaginary parts of its DC and Nyquist bins are
    dropped, as numpy's irfft drops them."""
    z = spec.to(torch.complex128)
    mono = z.ndim == 2
    if mono:
        z = z[None]
    n_fft = 2 * (z.shape[1] - 1)
    ri = torch.view_as_real(z).clone()
    ri[:, 0, :, 1] = 0.0
    ri[:, -1, :, 1] = 0.0
    win = torch.as_tensor(_hann(n_fft), device=z.device)
    t = torch.fft.irfft(torch.view_as_complex(ri).transpose(1, 2), n=n_fft, dim=-1) * win
    frames = t.shape[1]
    total = (frames - 1) * hop + n_fft

    def overlap_add(cols):                                          # (N, n_fft, frames)
        return F.fold(cols, (1, total), (1, n_fft), stride=(1, hop))[:, 0, 0]

    y = overlap_add(t.transpose(1, 2))
    norm = overlap_add(win.square()[None, :, None].expand(1, n_fft, frames).contiguous())
    y = y / torch.clamp(norm, min=1e-11)
    pad = n_fft // 2
    y = y[:, pad:-pad]
    if length is not None:
        y = y[:, :length]
    y = y.to(torch.float32)
    return y[0] if mono else y


def _resample(x, orig_sr: float, target_sr: float):
    """Polyphase resample along the last axis on the host (scipy), the
    ratio a rational approximation (stand-in for librosa.resample).  A
    tensor comes back as a tensor on its device."""
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(_resample(x.cpu().numpy(), orig_sr, target_sr),
                               device=x.device)
    if orig_sr == target_sr:
        return np.asarray(x, np.float32)
    frac = Fraction(float(target_sr) / float(orig_sr)).limit_denominator(1000)
    up, down = frac.numerator, frac.denominator
    out = resample_poly(np.asarray(x, np.float64), up, down, axis=-1, window=("kaiser", 12.0))
    return out.astype(np.float32)


def _param(mp):
    """A ModelParameters-like object (`.param` dict) or a bare dict."""
    return mp.param if hasattr(mp, "param") else mp


class ModelParameters:
    """UVR's VR `ModelParameters`, minimal: the per-band parameter dict
    the multi-band functions read (`bins`, `band` -> {n_fft, hl, sr,
    crop_start/stop, lpf/hpf_*, convert_channels}, `pre_filter_start/stop`,
    `reverse`, `mid_side`, `mid_side_b2`)."""

    DEFAULTS = {"reverse": False, "mid_side": False, "mid_side_b2": False,
                "pre_filter_start": 0, "pre_filter_stop": 0}

    def __init__(self, param: dict):
        merged = dict(self.DEFAULTS)
        merged.update(param)
        # JSON keys arrive as strings; band indices are 1-based ints
        band = merged.get("band", {})
        merged["band"] = {int(k): v for k, v in band.items()}
        self.param = merged


# ------------------------------------------------------- small host helpers


def crop_center(h1: np.ndarray, h2: np.ndarray) -> np.ndarray:
    """Center-crop h1's time axis (axis 3) to h2's (spec_utils.py:45-55)."""
    if h1.shape[3] == h2.shape[3]:
        return h1
    if h1.shape[3] < h2.shape[3]:
        raise ValueError("h1_shape[3] > h2_shape[3]")
    s_time = (h1.shape[3] - h2.shape[3]) // 2
    return h1[:, :, :, s_time:s_time + h2.shape[3]]


@_spectral
def preprocess(X_spec):
    """(magnitude, phase) (spec_utils.py:57-58)."""
    return X_spec.abs(), torch.angle(X_spec)


def make_padding(width: int, cropsize: int, offset: int):
    """(spec_utils.py:60-64)."""
    roi_size = cropsize - offset * 2
    if roi_size == 0:
        roi_size = cropsize
    return offset, roi_size - (width % roi_size) + offset, roi_size


def normalize(wave: np.ndarray, max_peak: float = 1.0) -> np.ndarray:
    """Peak limit (spec_utils.py:66-70)."""
    maxv = np.abs(wave).max()
    if maxv > max_peak:
        wave = wave * (max_peak / maxv)
    return wave


def auto_transpose(audio_array: np.ndarray) -> np.ndarray:
    """(T, 2) -> (2, T) (spec_utils.py:72-74)."""
    if audio_array.shape[1] == 2:
        return audio_array.T
    return audio_array


def write_array_to_mem(audio_data, subtype: str = "PCM_16"):
    """WAV bytes in memory at 44100 Hz (spec_utils.py:76-85); FLOAT
    subtypes write float32, any other 16-bit PCM."""
    if not isinstance(audio_data, np.ndarray):
        return audio_data
    from scipy.io import wavfile

    buf = io.BytesIO()
    if "FLOAT" in subtype.upper():
        wavfile.write(buf, 44100, np.asarray(audio_data, np.float32))
    else:
        clipped = np.clip(np.asarray(audio_data, np.float64), -1.0, 1.0)
        wavfile.write(buf, 44100, (clipped * 32767.0).astype(np.int16))
    buf.seek(0)
    return buf


def spectrogram_to_image(spec: np.ndarray, mode: str = "magnitude"):
    """uint8 image of a (C, F, T) or (F, T) spectrogram
    (spec_utils.py:87-99)."""
    if mode == "magnitude":
        y = np.log10((np.abs(spec) if np.iscomplexobj(spec) else spec) ** 2 + 1e-8)
    elif mode == "phase":
        y = np.angle(spec) if np.iscomplexobj(spec) else spec
    else:
        raise ValueError(mode)
    y = y - y.min()
    y = y * (255 / y.max())
    img = np.uint8(y)
    if y.ndim == 3:
        img = img.transpose(1, 2, 0)
        img = np.concatenate([np.max(img, axis=2, keepdims=True), img], axis=2)
    return img


@_spectral
def reduce_vocal_aggressively(X, y, softmask: float):
    """(spec_utils.py:101-105): clamp y's magnitude where the residual
    exceeds it, keep y's phase."""
    y_mag = y.abs()
    v_mag = (X - y).abs()
    return (torch.clamp(y_mag - v_mag * (v_mag > y_mag) * softmask, min=0)
            * _unit_phase(y))


def merge_artifacts(y_mask: np.ndarray, thres: float = 0.01,
                    min_range: int = 64, fade_size: int = 32) -> np.ndarray:
    """Fade mask gaps between detected artifact regions
    (spec_utils.py:107-143).  On any error the input mask is returned
    unchanged, like the reference's blanket except."""
    mask = y_mask
    try:
        if min_range < fade_size * 2:
            raise ValueError("min_range >= fade_size * 2")
        idx = np.where(y_mask.min(axis=(0, 1)) > thres)[0]
        start_idx = np.insert(idx[np.where(np.diff(idx) != 1)[0] + 1], 0, idx[0])
        end_idx = np.append(idx[np.where(np.diff(idx) != 1)[0]], idx[-1])
        artifact_idx = np.where(end_idx - start_idx > min_range)[0]
        weight = np.zeros_like(y_mask)
        if len(artifact_idx) > 0:
            start_idx = start_idx[artifact_idx]
            end_idx = end_idx[artifact_idx]
            old_e = None
            for s, e in zip(start_idx, end_idx):
                if old_e is not None and s - old_e < fade_size:
                    s = old_e - fade_size * 2
                if s != 0:
                    weight[:, :, s:s + fade_size] = np.linspace(0, 1, fade_size)
                else:
                    s -= fade_size
                if e != y_mask.shape[2]:
                    weight[:, :, e - fade_size:e] = np.linspace(1, 0, fade_size)
                else:
                    e += fade_size
                weight[:, :, s + fade_size:e - fade_size] = 1
                old_e = e
        v_mask = 1 - y_mask
        y_mask = y_mask + weight * v_mask
        mask = y_mask
    except Exception as exc:  # noqa: BLE001 — the reference swallows all errors here
        from ..utils.i18n import tr

        logger.warning("%s", tr("merge_artifacts_failed", e=exc))
    return mask


def align_wave_head_and_tail(a: np.ndarray, b: np.ndarray):
    """(spec_utils.py:145-147), with the reference's double-axis slice
    `a[:l, :l]` (it crops the channel axis too when l < n_channels)."""
    l = min([a[0].size, b[0].size])
    return a[:l, :l], b[:l, :l]


# -------------------------------------------------- multi-band (VR) helpers
#
# Channel encodes/decodes as 2x2 mixing matrices over the channel axis
# (out = M @ [ch0, ch1]); the reference writes each mode out longhand
# (spec_utils.py:149-163, 193-239).  Several decodes are deliberately
# not the matrix inverse of their encode.

_V51_ENCODE = {
    "mid_side":   ((0.5, 0.5), (1.0, -1.0)),
    "mid_side_c": ((1.0, 0.25), (-0.25, 1.0)),
    "stereo_n":   ((1 / 0.9375, 0.25 / 0.9375), (0.25 / 0.9375, 1 / 0.9375)),
}
_V51_DECODE = {
    "mid_side":   ((1.0, 0.5), (1.0, -0.5)),
    "mid_side_c": ((1 / 1.0625, -1 / 4.25), (1 / 4.25, 1 / 1.0625)),
    "stereo_n":   ((1.0, -0.25), (-0.25, 1.0)),
}
_LEGACY_ENCODE = {
    "mid_side":    ((0.5, 0.5), (1.0, -1.0)),
    "mid_side_b2": ((0.5, 1.0), (1.0, -0.5)),
}
_LEGACY_DECODE = {
    "mid_side":    ((1.0, 0.5), (1.0, -0.5)),
    "mid_side_b2": ((0.4, 1 / 1.25), (1 / 1.25, -0.4)),
}


def _mix2(pair: torch.Tensor, m) -> torch.Tensor:
    """A 2x2 mixing matrix over the leading channel axis."""
    (a, b), (c, d) = m
    return torch.stack([a * pair[0] + b * pair[1], c * pair[0] + d * pair[1]])


def _legacy_mode(p) -> str | None:
    for mode in ("reverse", "mid_side", "mid_side_b2"):
        if p.get(mode):
            return mode
    return None


@_spectral
def convert_channels(spec, mp, band: int):
    """Per-band v5.1 stereo encode (spec_utils.py:149-163)."""
    m = _V51_ENCODE.get(_param(mp)["band"][band].get("convert_channels"))
    return spec if m is None else _mix2(spec, m)


def _legacy_prefilter_gains(start: int, stop: int) -> np.ndarray:
    """The reference's recursive multiband pre-filter roll-off
    (spec_utils.py:184-189): each bin's dB slope depends on the previous
    bin's linear gain, so the recurrence stays on the host and only the
    multiply runs on the device."""
    gains = np.empty(max(stop - start - 1, 0))
    g = 1.0
    for k in range(gains.shape[0]):
        g = math.pow(10, -(k + 1) * (3.5 - g) / 20.0)
        gains[k] = g
    return gains


@_spectral
def combine_spectrograms(specs: dict, mp, is_v51_model: bool = False):
    """Each band's crop rows concatenated into the model's bin layout,
    then the pre-filter roll-off (spec_utils.py:165-191)."""
    p = _param(mp)
    n_frames = min(specs[i].shape[2] for i in specs)
    bands = [p["band"][d] for d in range(1, len(p["band"]) + 1)]
    rows = [specs[d + 1][:, b["crop_start"]:b["crop_stop"], :n_frames]
            for d, b in enumerate(bands)]
    used = sum(r.shape[1] for r in rows)
    if used > p["bins"]:
        raise ValueError("offset > mp.param['bins']")
    dev = rows[0].device
    out = torch.zeros((2, p["bins"] + 1, n_frames), dtype=torch.complex64, device=dev)
    out[:, :used] = torch.cat(rows, dim=1)
    lo, hi = p["pre_filter_start"], p["pre_filter_stop"]
    if lo > 0:
        if is_v51_model:
            out = _scale(out, torch.as_tensor(get_lp_filter_mask(out.shape[1], lo, hi),
                                              device=dev))
        elif len(bands) == 1:
            out = fft_lp_filter(out, lo, hi)
        else:
            gains = torch.as_tensor(_legacy_prefilter_gains(lo, hi), device=dev)[None, :, None]
            out[:, lo + 1:hi] = _scale(out[:, lo + 1:hi], gains)
    return out


@_spectral
def wave_to_spectrogram(wave, hop_length: int = HOP, n_fft: int = N_FFT, mp=None,
                        band: int = 0, is_v51_model: bool = False):
    """Stereo STFT with the mp channel encodes (spec_utils.py:193-219).
    With `mp=None` the plain transform (wave_to_spectrogram_no_mp)."""
    if wave.ndim == 1:
        wave = torch.stack([wave, wave])
    if mp is not None and not is_v51_model:
        mode = _legacy_mode(_param(mp))
        if mode == "reverse":
            wave = torch.flip(wave, [1])
        elif mode is not None:
            wave = _mix2(wave, _LEGACY_ENCODE[mode])
    spec = torch.stack([_stft(wave[0], n_fft, hop_length), _stft(wave[1], n_fft, hop_length)])
    if is_v51_model and mp is not None:
        spec = convert_channels(spec, mp, band)
    return spec


@_spectral
def spectrogram_to_wave(spec, hop_length: int = HOP, mp=None, band: int = 0,
                        is_v51_model: bool = True, length: int | None = None):
    """Inverse of wave_to_spectrogram with the channel decodes
    (spec_utils.py:221-239).  `mp=None`: the plain iSTFT."""
    if spec.ndim == 2:
        spec = torch.stack([spec, spec])
    pair = torch.stack([_istft(spec[0], hop_length, length), _istft(spec[1], hop_length, length)])
    if mp is None:
        return pair
    p = _param(mp)
    if is_v51_model:
        m = _V51_DECODE.get(p["band"][band].get("convert_channels"))
        return pair if m is None else _mix2(pair, m)
    mode = _legacy_mode(p)
    if mode == "reverse":
        return torch.flip(pair, [1])
    return pair if mode is None else _mix2(pair, _LEGACY_DECODE[mode])


def _band_rows(bands) -> list:
    """[(row0, row1)]: each band's row range inside the combined spec."""
    heights = [b["crop_stop"] - b["crop_start"] for b in bands]
    edges = np.concatenate([[0], np.cumsum(heights)])
    return list(zip(edges[:-1], edges[1:]))


@_spectral
def cmb_spectrogram_to_wave(spec_m, mp, extra_bins_h=None, extra_bins=None,
                            is_v51_model: bool = False):
    """Multi-band combined spectrogram -> wave (spec_utils.py:241-287).

    Walks the bands bottom-up: each band's rows are re-seated at its own
    FFT size in complex128, band-filtered (low band: LPF; middle: HPF and
    LPF; top: HPF and the optional grafted high end) and inverted on the
    device, and the running mix is resampled on the host up to the next
    band's rate before the next band is added."""
    p = _param(mp)
    bands = [p["band"][d] for d in range(1, len(p["band"]) + 1)]
    n_frames = spec_m.shape[2]
    mix = None
    for pos, (binfo, (row0, row1)) in enumerate(zip(bands, _band_rows(bands))):
        top = pos == len(bands) - 1
        band_spec = torch.zeros((2, binfo["n_fft"] // 2 + 1, n_frames), dtype=torch.complex128,
                                device=spec_m.device)
        band_spec[:, binfo["crop_start"]:binfo["crop_stop"]] = spec_m[:, row0:row1]

        if top and extra_bins_h:
            # graft the carried-over high-end rows under the Nyquist bin
            nyq = binfo["n_fft"] // 2
            band_spec[:, nyq - extra_bins_h:nyq] = extra_bins[:, :extra_bins_h]

        hpf = (not top and pos > 0) or (top and binfo["hpf_start"] > 0)
        if hpf:
            if is_v51_model:
                band_spec = band_spec * torch.as_tensor(get_hp_filter_mask(
                    band_spec.shape[1], binfo["hpf_start"], binfo["hpf_stop"] - 1),
                    device=band_spec.device)
            else:
                band_spec = fft_hp_filter(band_spec, binfo["hpf_start"], binfo["hpf_stop"] - 1)
        if not top:
            if is_v51_model:
                band_spec = band_spec * torch.as_tensor(get_lp_filter_mask(
                    band_spec.shape[1], binfo["lpf_start"], binfo["lpf_stop"]),
                    device=band_spec.device)
            else:
                band_spec = fft_lp_filter(band_spec, binfo["lpf_start"], binfo["lpf_stop"])

        band_wave = spectrogram_to_wave(band_spec, binfo["hl"], mp, pos + 1, is_v51_model)
        mix = band_wave if mix is None else mix + band_wave
        if not top:
            mix = _resample(mix, binfo["sr"], bands[pos + 1]["sr"])
    return mix


def get_lp_filter_mask(n_bins: int, bin_start: int, bin_stop: int) -> np.ndarray:
    """(spec_utils.py:289-290): a (n_bins, 1) column of constants."""
    return np.concatenate([
        np.ones((bin_start - 1, 1)),
        np.linspace(1, 0, bin_stop - bin_start + 1)[:, None],
        np.zeros((n_bins - bin_stop, 1)),
    ], axis=0)


def get_hp_filter_mask(n_bins: int, bin_start: int, bin_stop: int) -> np.ndarray:
    """(spec_utils.py:292-293): a (n_bins, 1) column of constants."""
    return np.concatenate([
        np.zeros((bin_stop + 1, 1)),
        np.linspace(0, 1, 1 + bin_start - bin_stop)[:, None],
        np.ones((n_bins - bin_start - 2, 1)),
    ], axis=0)


@_spectral
def fft_lp_filter(spec, bin_start: int, bin_stop: int):
    """Linear low-pass roll-off (1 -> 0 over [bin_start, bin_stop), zero
    above); writes `spec` in place, like the reference
    (spec_utils.py:295-303)."""
    span = bin_stop - bin_start
    if span > 0:
        ramp = 1.0 - torch.arange(1, span + 1, dtype=torch.float64, device=spec.device) / span
        spec[:, bin_start:bin_stop] = _scale(spec[:, bin_start:bin_stop], ramp[None, :, None])
    spec[:, bin_stop:] *= 0
    return spec


@_spectral
def fft_hp_filter(spec, bin_start: int, bin_stop: int):
    """Linear high-pass roll-off (0 -> 1 over (bin_stop, bin_start], zero
    at and below bin_stop); writes `spec` in place (spec_utils.py:305-313)."""
    span = bin_start - bin_stop
    if span > 0:
        ramp = 1.0 - torch.arange(span, 0, -1, dtype=torch.float64, device=spec.device) / span
        spec[:, bin_stop + 1:bin_start + 1] = _scale(spec[:, bin_stop + 1:bin_start + 1],
                                                     ramp[None, :, None])
    spec[:, :bin_stop + 1] *= 0
    return spec


@_spectral
def spectrogram_to_wave_old(spec, hop_length: int = 1024):
    """(spec_utils.py:315-319)."""
    if spec.ndim == 2:
        return _istft(spec, hop_length)
    return torch.stack([_istft(spec[0], hop_length), _istft(spec[1], hop_length)])


@_spectral
def wave_to_spectrogram_old(wave, hop_length: int, n_fft: int):
    """(spec_utils.py:321-322)."""
    return torch.stack([_stft(wave[0], n_fft, hop_length), _stft(wave[1], n_fft, hop_length)])


@_spectral
def mirroring(a: str, spec_m, input_high_end, mp):
    """High-end reconstruction by mirroring the bins just below the
    pre-filter cut (spec_utils.py:324-333)."""
    p = _param(mp)
    if a not in ("mirroring", "mirroring2"):
        return input_high_end
    lo = p["pre_filter_start"] - 10 - input_high_end.shape[1]
    flipped = torch.flip(spec_m[:, lo:p["pre_filter_start"] - 10, :].abs(), [1])
    if a == "mirroring":
        mirror = flipped * _unit_phase(input_high_end)
    else:
        mirror = flipped * (input_high_end * 1.7)
    return torch.where(_mag(input_high_end) <= _mag(mirror), input_high_end, mirror)


@_spectral
def adjust_aggr(mask, is_non_accom_stem: bool, aggressiveness: dict):
    """Exponent-shape the mask per channel and bin split; writes `mask`
    in place (spec_utils.py:335-354)."""
    aggr = aggressiveness["value"] * 2
    if aggr != 0:
        if is_non_accom_stem:
            aggr = 1 - aggr
        aggr = [aggr, aggr]
        if aggressiveness["aggr_correction"] is not None:
            aggr[0] += aggressiveness["aggr_correction"]["left"]
            aggr[1] += aggressiveness["aggr_correction"]["right"]
        split = aggressiveness["split_bin"]
        for ch in range(2):
            mask[ch, :split] = torch.pow(mask[ch, :split], 1 + aggr[ch] / 3)
            mask[ch, split:] = torch.pow(mask[ch, split:], 1 + aggr[ch])
    return mask


@_spectral
def stft(wave, nfft: int, hl: int):
    """Stereo STFT pair (spec_utils.py:356-357)."""
    return torch.stack([_stft(wave[0], nfft, hl), _stft(wave[1], nfft, hl)])


@_spectral
def istft(spec, hl: int):
    """Stereo iSTFT pair (spec_utils.py:359-360)."""
    return torch.stack([_istft(spec[0], hl), _istft(spec[1], hl)])


@_spectral
def spec_effects(wave, algorithm: str = "Default", value=None):
    """Two-source spectral combine (spec_utils.py:362-373)."""
    wave = [wave[0], wave[1]]
    if any(not bool(torch.isfinite(w).all()) for w in wave):
        from ..utils.i18n import tr

        logger.warning("%s", tr("spec_nonfinite", shapes=[tuple(w.shape) for w in wave]))
    if algorithm == "Default":
        return (wave[1] * value) + (wave[0] * (1 - value))
    spec = [stft(wave[0], 2048, 1024), stft(wave[1], 2048, 1024)]
    if algorithm == "Min_Mag":
        return istft(torch.where(_mag(spec[1]) <= _mag(spec[0]), spec[1], spec[0]), 1024)
    if algorithm == "Max_Mag":
        return istft(torch.where(_mag(spec[1]) >= _mag(spec[0]), spec[1], spec[0]), 1024)
    if algorithm == "Invert_p":
        X_mag, y_mag = spec[0].abs(), spec[1].abs()
        return istft(spec[1] - torch.where(X_mag >= y_mag, X_mag, y_mag)
                     * _unit_phase(spec[0]), 1024)
    raise ValueError(algorithm)


@_spectral
def spectrogram_to_wave_no_mp(spec, n_fft: int = N_FFT, hop_length: int = HOP,
                              length: int | None = None):
    """(spec_utils.py:375-379)."""
    wave = _istft(spec, hop_length, length)
    if wave.ndim == 1:
        wave = torch.stack([wave, wave])
    return wave


@_spectral
def wave_to_spectrogram_no_mp(wave):
    """(spec_utils.py:381-385)."""
    spec = _stft(wave, N_FFT, HOP)
    if spec.ndim == 1:
        spec = torch.stack([spec, spec])
    return spec


@_spectral
def invert_audio(specs: list, invert_p: bool = True):
    """Spectral inversion of a stem against the mixture
    (spec_utils.py:387-399)."""
    ln = min(specs[0].shape[2], specs[1].shape[2])
    specs = [specs[0][:, :, :ln], specs[1][:, :, :ln]]
    if invert_p:
        x_mag, y_mag = specs[0].abs(), specs[1].abs()
        return specs[1] - (torch.where(x_mag >= y_mag, x_mag, y_mag) * _unit_phase(specs[0]))
    specs[1] = reduce_vocal_aggressively(specs[0], specs[1], 0.2)
    return specs[0] - specs[1]


@_spectral
def invert_stem(mixture, stem):
    """The secondary stem by spectral subtraction (spec_utils.py:401-402).
    mixture / stem: (C, L) waves -> (L, C) inverted wave."""
    v_spec = invert_audio([wave_to_spectrogram_no_mp(mixture), wave_to_spectrogram_no_mp(stem)])
    return -_T(spectrogram_to_wave_no_mp(v_spec))


@_spectral
def ensembling(a: str, inputs: list, is_wavs: bool = False):
    """Min/Max-magnitude ensemble across spectrograms or waves
    (spec_utils.py:404-420); on a tie the later input wins."""
    inputs = list(inputs)
    input = inputs[0]
    for i in range(1, len(inputs)):
        if is_wavs:
            ln = min(input.shape[1], inputs[i].shape[1])
            input = input[:, :ln]
            inputs[i] = inputs[i][:, :ln]
        else:
            ln = min(input.shape[2], inputs[i].shape[2])
            input = input[:, :, :ln]
            inputs[i] = inputs[i][:, :, :ln]
        if a == MIN_SPEC:
            input = torch.where(_mag(inputs[i]) <= _mag(input), inputs[i], input)
        if a == MAX_SPEC:
            input = torch.where(_mag(inputs[i]) >= _mag(input), inputs[i], input)
    return input


@_spectral
def ensemble_for_align(waves: list):
    """The aligner's min-spec ensemble (spec_utils.py:422-432)."""
    specs = [wave_to_spectrogram_no_mp(_T(wav)) for wav in waves]
    wav_aligned = _T(spectrogram_to_wave_no_mp(ensembling(MIN_SPEC, specs)))
    return _fit_time(wav_aligned, waves[1].shape[0])


def ensemble_inputs(audio_input: list, algorithm: str, is_normalization: bool,
                    wav_type_set: str, save_path: str, is_wave: bool = False,
                    is_array: bool = False, *, device="cuda") -> None:
    """Ensemble N audio files into one (spec_utils.py:434-454): Average
    on the host, the min/max-magnitude ensembles on `device` (the card
    unless the caller passes "cpu")."""
    if algorithm == AVERAGE:
        output = average_audio(audio_input)
    else:
        dev = resolve_device(device)
        wavs_ = [torch.as_tensor(np.ascontiguousarray(load_audio(path)), device=dev)
                 for path in audio_input]
        specs = [w if is_wave else wave_to_spectrogram_no_mp(w) for w in wavs_]
        wave_shapes = [w.shape[1] for w in wavs_]
        target_shape = wavs_[wave_shapes.index(max(wave_shapes))]
        out = (ensembling(algorithm, specs, is_wavs=True) if is_wave
               else spectrogram_to_wave_no_mp(ensembling(algorithm, specs)))
        output = _pad_to(out, target_shape.shape).cpu().numpy()
    _write_out(save_path, normalize(output.T, is_normalization), 44100, wav_type_set)


def to_shape(x: np.ndarray, target_shape) -> np.ndarray:
    """Zero-pad up to target_shape (spec_utils.py:456-462)."""
    pads = [(0, t - s) for s, t in zip(x.shape, target_shape)]
    return np.pad(x, tuple(pads), mode="constant")


def to_shape_minimize(x: np.ndarray, target_shape) -> np.ndarray:
    """(spec_utils.py:464-470, the same body as to_shape)."""
    return to_shape(x, target_shape)


def _first_loud_sample(audio: np.ndarray, threshold: float, frame: int) -> int:
    """Start of the first frame whose peak exceeds threshold, or
    len(audio) if none does; stereo picks the louder channel
    (spec_utils.py:472-505)."""
    if audio.ndim == 2:
        audio = audio[np.argmax(np.sum(np.abs(audio), axis=1))]
    n = len(audio)
    if n == 0:
        return 0
    padded = np.abs(np.concatenate([audio, np.zeros((-n) % frame)]))
    loud = padded.reshape(-1, frame).max(axis=1) > threshold
    hits = np.flatnonzero(loud)
    return n if hits.size == 0 else int(hits[0]) * frame


def detect_leading_silence(audio: np.ndarray, sr: int, silence_threshold: float = 0.007,
                           frame_length: int = 1024) -> float:
    """Leading-silence length in ms (spec_utils.py:472-480)."""
    return _first_loud_sample(np.asarray(audio), silence_threshold, frame_length) / sr * 1000


def adjust_leading_silence(target_audio: np.ndarray, reference_audio: np.ndarray,
                           silence_threshold: float = 0.01,
                           frame_length: int = 1024) -> np.ndarray:
    """Pad or trim target's head so its first sound lines up with the
    reference's (spec_utils.py:482-505)."""
    shift = (_first_loud_sample(reference_audio, silence_threshold, frame_length)
             - _first_loud_sample(target_audio, silence_threshold, frame_length))
    stereo = target_audio.ndim == 2
    if shift > 0:
        pad_shape = (target_audio.shape[0], shift) if stereo else shift
        return np.hstack((np.zeros(pad_shape), target_audio))
    if shift < 0:
        return target_audio[:, -shift:] if stereo else target_audio[-shift:]
    return target_audio


def match_array_shapes(array_1: np.ndarray, array_2: np.ndarray,
                       is_swap: bool = False) -> np.ndarray:
    """Trim or zero-pad array_1's axis 1 to array_2's (spec_utils.py:507-518)."""
    if is_swap:
        array_1, array_2 = array_1.T, array_2.T
    if array_1.shape[1] > array_2.shape[1]:
        array_1 = array_1[:, :array_2.shape[1]]
    elif array_1.shape[1] < array_2.shape[1]:
        padding = array_2.shape[1] - array_1.shape[1]
        array_1 = np.pad(array_1, ((0, 0), (0, padding)), "constant", constant_values=0)
    if is_swap:
        array_1, array_2 = array_1.T, array_2.T
    return array_1


def match_mono_array_shapes(array_1: np.ndarray, array_2: np.ndarray) -> np.ndarray:
    """(spec_utils.py:520-526)."""
    if len(array_1) > len(array_2):
        array_1 = array_1[:len(array_2)]
    elif len(array_1) < len(array_2):
        array_1 = np.pad(array_1, (0, len(array_2) - len(array_1)), "constant",
                         constant_values=0)
    return array_1


def change_pitch_semitones(y: np.ndarray, sr: int, semitone_shift: float):
    """Pitch change by resampling, without time correction
    (spec_utils.py:528-538)."""
    factor = 2 ** (semitone_shift / 12)
    y_pitch_tuned = [np.asarray(_resample(ch, sr, sr * factor)) for ch in y]
    return np.array(y_pitch_tuned), sr * factor


def augment_audio(export_path: str, audio_file: str, rate: float, is_normalization: bool,
                  wav_type_set: str, save_format=None, is_pitch: bool = False,
                  is_time_correction: bool = True) -> None:
    """Speed or pitch augmentation of a file (spec_utils.py:540-556), the
    phase vocoders in place of rubberband."""
    wav = load_audio(audio_file)
    sr = 44100
    if not is_time_correction:
        wav_mix = change_pitch_semitones(wav, sr, semitone_shift=-rate)[0]
    else:
        if is_pitch:
            wav_1 = pitch_shift(wav[0], sr, rate)
            wav_2 = pitch_shift(wav[1], sr, rate)
        else:
            wav_1 = time_stretch(wav[0], sr, rate)
            wav_2 = time_stretch(wav[1], sr, rate)
        if wav_1.shape > wav_2.shape:
            wav_2 = to_shape(wav_2, wav_1.shape)
        if wav_1.shape < wav_2.shape:
            wav_1 = to_shape(wav_1, wav_2.shape)
        wav_mix = np.asfortranarray([wav_1, wav_2])
    _write_out(export_path, normalize(wav_mix.T, is_normalization), sr, wav_type_set)
    if save_format is not None:
        save_format(export_path)


def average_audio(audio: list) -> np.ndarray:
    """Sample mean of N files, padded to the longest (spec_utils.py:558-577)."""
    waves, wave_shapes, final_waves = [], [], []
    for path in audio:
        wave = load_audio(path)
        waves.append(wave)
        wave_shapes.append(wave.shape[1])
    wave_shapes_index = wave_shapes.index(max(wave_shapes))
    target_shape = waves[wave_shapes_index]
    waves.pop(wave_shapes_index)
    final_waves.append(target_shape)
    for n_array in waves:
        final_waves.append(to_shape(n_array, target_shape.shape))
    waves = sum(final_waves)
    return waves / len(audio)


def average_dual_sources(wav_1: np.ndarray, wav_2: np.ndarray, value: float) -> np.ndarray:
    """(spec_utils.py:579-583)."""
    if wav_1.shape > wav_2.shape:
        wav_2 = to_shape(wav_2, wav_1.shape)
    if wav_1.shape < wav_2.shape:
        wav_1 = to_shape(wav_1, wav_2.shape)
    return (wav_1 * value) + (wav_2 * (1 - value))


def reshape_sources(wav_1: np.ndarray, wav_2: np.ndarray) -> np.ndarray:
    """wav_2 matched to wav_1's shape (spec_utils.py:585-596)."""
    if wav_1.shape > wav_2.shape:
        wav_2 = to_shape(wav_2, wav_1.shape)
    if wav_1.shape < wav_2.shape:
        ln = min(wav_1.shape[1], wav_2.shape[1])
        wav_2 = wav_2[:, :ln]
    ln = min(wav_1.shape[1], wav_2.shape[1])
    return wav_2[:, :ln]


def reshape_sources_ref(wav_1_shape, wav_2: np.ndarray) -> np.ndarray:
    """(spec_utils.py:598-600)."""
    if wav_1_shape > wav_2.shape:
        wav_2 = to_shape(wav_2, wav_1_shape)
    return wav_2


def combine_arrarys(audio_sources: list, is_swap: bool = False) -> np.ndarray:
    """Sum arrays onto the largest's shape (spec_utils.py:602-609; the
    reference's misspelt name kept)."""
    source = np.zeros_like(max(audio_sources, key=np.size))
    for v in audio_sources:
        v = match_array_shapes(v, source, is_swap=is_swap)
        source += v
    return source


def combine_audio(paths: list, audio_file_base=None, wav_type_set: str = "FLOAT",
                  save_format=None) -> None:
    """(spec_utils.py:611-615)."""
    source = combine_arrarys([load_audio(i) for i in paths])
    save_path = f"{audio_file_base}_combined.wav"
    _write_out(save_path, source.T, 44100, wav_type_set)
    if save_format is not None:
        save_format(save_path)


def reduce_mix_bv(inst_source: np.ndarray, voc_source: np.ndarray,
                  reduction_rate: float = 0.9) -> np.ndarray:
    """(spec_utils.py:617-618)."""
    return combine_arrarys([inst_source * (1 - reduction_rate), voc_source], is_swap=True)


def organize_inputs(inputs: list) -> dict:
    """Classify aligner input files by suffix (spec_utils.py:620-629)."""
    input_list = {"target": None, "reference": None, "reverb": None, "inst": None}
    for i in inputs:
        if i.endswith("_(Vocals).wav"):
            input_list["reference"] = i
        elif "_RVC_" in i:
            input_list["target"] = i
        elif i.endswith("reverbed_stem.wav"):
            input_list["reverb"] = i
        elif i.endswith("_(Instrumental).wav"):
            input_list["inst"] = i
    return input_list


@_spectral
def check_if_phase_inverted(wav1, wav2, is_mono: bool = False) -> bool:
    """(spec_utils.py:631-636): the correlation of the first 1,000
    samples, in float64, is negative."""
    if not is_mono:
        wav1 = wav1.mean(0)
        wav2 = wav2.mean(0)
    c = torch.corrcoef(torch.stack([wav1[:1000], wav2[:1000]]).double())
    return bool(c[0, 1] < 0)


# --------------------------------------------------------------- alignment
#
# The JAX package's aligner (spec_utils.py:638-852 in its own structure:
# module-level lag and gain helpers, a progress relay), with every window
# of one size searched in one batch on the device.

_SR_ALIGN = 44100


def _db_gain(db: float) -> float:
    return 10.0 ** (db / 20.0)


def _xcorr_full(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """np.correlate(a, b, "full") along the last axis, batched and
    broadcast, by float64 FFTs: (..., Na), (..., Nb) -> (..., Na + Nb - 1),
    entry k the lag k - (Nb - 1)."""
    na, nb = a.shape[-1], b.shape[-1]
    n = 1 << (na + nb - 2).bit_length()
    spec = torch.fft.rfft(a.double(), n=n) * torch.fft.rfft(b.double(), n=n).conj()
    r = torch.fft.irfft(spec, n=n)
    return torch.cat([r[..., n - (nb - 1):], r[..., :na]], dim=-1)


@_spectral
def _xcorr_lag(a, b) -> int:
    """Signed lag (samples) that best aligns b onto a: the peak of the
    full cross-correlation."""
    return int(torch.argmax(_xcorr_full(a, b))) - (b.shape[0] - 1)


def _delay(wav: torch.Tensor, lag: int) -> torch.Tensor:
    """A signed lag along time axis 0: positive prepends silence,
    negative drops leading samples."""
    if lag > 0:
        return torch.cat([wav.new_zeros((lag,) + tuple(wav.shape[1:])), wav])
    return wav[-lag:] if lag < 0 else wav


class _AlignProgress:
    """Relays window-loop progress into the UI callback as a saturating
    fraction in [0.1, 1.0)."""

    def __init__(self, cb):
        self.cb = cb
        self.ticks = 0

    def tick(self, expected_total: int) -> None:
        self.ticks += 1
        denom = max(expected_total, self.ticks + 1)
        if self.cb is not None:
            self.cb(0.1, 0.9 * self.ticks / denom)


def align_audio(file1: str, file2: str, file2_aligned: str, file_subtracted: str,
                wav_type_set: str, is_save_aligned: bool, command_Text, save_format,
                align_window: list, align_intro_val: list, db_analysis: tuple,
                set_progress_bar, phase_option: str, phase_shifts, is_match_silence: bool,
                is_spec_match: bool, *, device="cuda") -> None:
    """Time-align file2 against file1 and write the aligned take and the
    subtraction residual (capability of spec_utils.py:638-739).  The
    files are read on the host; from the coarse pass to the residual the
    arrays stay on `device` (the card unless the caller passes "cpu")."""
    dev = resolve_device(device)
    emit = command_Text if command_Text is not None else (lambda *_: None)
    progress = _AlignProgress(set_progress_bar)

    wav1 = load_audio_maybe_mono(file1)
    wav2 = load_audio_maybe_mono(file2)
    is_mono = wav1.ndim == 1 and wav2.ndim == 1
    if not is_mono:
        if wav1.ndim == 1:
            wav1 = np.asfortranarray([wav1, wav1])
        if wav2.ndim == 1:
            wav2 = np.asfortranarray([wav2, wav2])
    w1 = torch.as_tensor(np.ascontiguousarray(wav1), device=dev)
    w2 = torch.as_tensor(np.ascontiguousarray(wav2), device=dev)

    if phase_option == AUTO_PHASE:
        if check_if_phase_inverted(w1, w2, is_mono=is_mono):
            w2 = -w2
    elif phase_option == NEGATIVE_PHASE:
        w2 = -w2

    if is_match_silence:
        w2 = torch.as_tensor(adjust_leading_silence(w2.cpu().numpy(), wav1), device=dev)

    seconds = min(w1.shape[-1], w2.shape[-1]) // _SR_ALIGN
    if not is_mono:
        w1, w2 = w1.T, w2.T                                         # (T, C)

    emit("processing files...\n")

    # coarse pass: probe the cross-correlation lag at several points of
    # the track and keep each distinct shifted take as a candidate
    candidates: list[torch.Tensor] = []
    for divisor in align_intro_val:
        probe = _SR_ALIGN * (1 if divisor == 1 else int(seconds // divisor))
        ref_seg = w1[probe:probe + _SR_ALIGN]
        tgt_seg = w2[probe:probe + _SR_ALIGN]
        if not is_mono:
            ref_seg, tgt_seg = ref_seg[:, 0], tgt_seg[:, 0]
        shifted = _delay(w2, _xcorr_lag(ref_seg, tgt_seg))
        if not any(shifted.shape == c.shape and torch.equal(shifted, c) for c in candidates):
            candidates.append(shifted)

    # fine pass per candidate; residuals keyed by mean level so
    # identical-quality duplicates collapse
    residuals: dict[float, torch.Tensor] = {}
    for cand in candidates:
        cand = _fit_time(cand, w1.shape[0])
        if align_window:
            sub = time_correction(w1, cand, seconds, align_window=align_window,
                                  db_analysis=db_analysis, progress_bar=progress.tick,
                                  unique_sources=len(candidates), phase_shifts=phase_shifts)
            residuals[float(sub.abs().mean())] = sub
        else:
            pre = cand * _db_gain(db_analysis[0])
            for db_adj in db_analysis[1]:
                sub = w1 - pre * _db_gain(db_adj)
                residuals[float(sub.abs().mean())] = sub

    subs = list(residuals.values())
    wav_sub = (ensemble_for_align(subs) if is_spec_match and len(subs) >= 2
               else ensemble_wav(subs))
    wav_sub = torch.clamp(wav_sub, -1, +1)

    emit("saving instrumental...\n")
    if is_save_aligned or is_spec_match:
        wav1m = _fit_time(w1, wav_sub.shape[0])
        aligned = wav1m - wav_sub
        if is_spec_match:
            if wav1m.ndim == 1:
                aligned = torch.stack([aligned, aligned]).T
                wav1m = torch.stack([wav1m, wav1m]).T
            aligned = ensemble_for_align([aligned, wav1m])
            wav_sub = wav1m - aligned
        if is_save_aligned:
            _write_out(file2_aligned, aligned.cpu().numpy(), _SR_ALIGN, wav_type_set)
            if save_format is not None:
                save_format(file2_aligned)

    _write_out(file_subtracted, wav_sub.cpu().numpy(), _SR_ALIGN, wav_type_set)
    if save_format is not None:
        save_format(file_subtracted)


def _analytic(x: torch.Tensor) -> torch.Tensor:
    """scipy.signal.hilbert along the last axis: the analytic signal."""
    n = x.shape[-1]
    h = torch.zeros(n, dtype=torch.float64, device=x.device)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1
        h[1:n // 2] = 2
    else:
        h[0] = 1
        h[1:(n + 1) // 2] = 2
    return torch.fft.ifft(torch.fft.fft(x.double(), dim=-1) * h, dim=-1)


@_spectral
def phase_shift_hilbert(signal, degree: float):
    """Constant phase rotation through the analytic signal
    (spec_utils.py:738-740)."""
    analytic_signal = _analytic(signal)
    rad = math.radians(degree)
    return math.cos(rad) * analytic_signal.real - math.sin(rad) * analytic_signal.imag


@_spectral
def get_phase_shifted_tracks(track, phase_shift: int) -> list:
    """The track and its phase rotations every `phase_shift` degrees
    (spec_utils.py:742-753)."""
    if phase_shift == 180:
        return [track, -track]
    step = phase_shift
    end = 180 - (180 % step) if 180 % step == 0 else 181
    flipped_list = [track, -track]
    for i in range(step, end, step):
        flipped_list.extend([phase_shift_hilbert(track, i), phase_shift_hilbert(track, -i)])
    return flipped_list


@_spectral
def _realign_window(ref_win, tgt_win, db_analysis: tuple, phase_shifts):
    """The best gain/phase/lag variant of each target window against its
    reference window: (W,) or (N, W) -> the same shape.

    Every phase variant is lag-corrected at the peak of |full
    cross-correlation|; each gain step of each variant is rolled by its
    variant's lag, and the one with the least mean absolute residual wins
    (gains outer, variants inner, the first minimum; semantics of
    spec_utils.py:757-771).  The windows go in chunks of at most
    XCORR_BATCH_BYTES of complex128 spectra."""
    single = ref_win.ndim == 1
    ref, tgt = (ref_win[None], tgt_win[None]) if single else (ref_win, tgt_win)
    rows, w = ref.shape
    pre = tgt * _db_gain(db_analysis[0])
    variants = torch.stack([pre] if phase_shifts == 190
                           else get_phase_shifted_tracks(pre, phase_shifts), dim=1)
    gains = torch.tensor([_db_gain(g) for g in db_analysis[1]], dtype=variants.dtype,
                         device=ref.device)
    nv, ng = variants.shape[1], len(gains)
    n = 1 << (2 * w - 2).bit_length()
    # about the bytes one window holds at once: its spectra, correlations and candidates
    per_row = 16 * (n // 2 + 1) * (nv + 1) + 8 * n * nv + 24 * w * ng * nv
    step = max(1, XCORR_BATCH_BYTES // per_row)
    best = []
    for r0 in range(0, rows, step):
        r_ref, r_var = ref[r0:r0 + step], variants[r0:r0 + step]
        lag = torch.argmax(_xcorr_full(r_ref[:, None], r_var).abs(), dim=-1) - (w - 1)
        # np.roll(cand, lag): out[i] = cand[(i - lag) mod w]
        idx = torch.remainder(torch.arange(w, device=ref.device) - lag[..., None], w)
        rolled = torch.gather(r_var, -1, idx)                       # (r, nv, w)
        cand = rolled[:, None] * gains[None, :, None, None]         # (r, ng, nv, w)
        err = (r_ref[:, None, None] - cand).abs().mean(-1).flatten(1)
        pick = torch.argmin(err, dim=1)
        best.append(cand.flatten(1, 2)[torch.arange(len(pick), device=ref.device), pick])
    out = torch.cat(best)
    return out[0] if single else out


def _window_starts(length: int, win: int, step: int) -> int:
    """len(range(0, length - win, step))."""
    return len(range(0, length - win, step))


@_spectral
def time_correction(mix, instrumental, seconds_length: int, align_window: list,
                    db_analysis: tuple, sr: int = 44100, progress_bar=None,
                    unique_sources=None, phase_shifts=NONE_P):
    """Windowed overlap-add re-alignment of instrumental against mix
    (capability of spec_utils.py:755-819): in each window the best
    gain/phase/lag variant is subtracted, and the passes over the window
    sizes of align_window are ensembled piecewise.  All windows of one
    size, over every channel, are one batch (`_realign_window`)."""
    if mix.shape != instrumental.shape:
        raise ValueError(f"shape mismatch: {tuple(mix.shape)} vs {tuple(instrumental.shape)}")

    mono = mix.ndim == 1
    n_ch = 1 if mono else mix.shape[1]
    length = mix.shape[0]
    tick_every = 320 if len(align_window) > 2 else 120
    expected_windows = sum(
        _window_starts(length, int(sr * secs), int(sr * secs) // 2)
        for secs in align_window) * n_ch
    expected_ticks = (expected_windows // tick_every) * (unique_sources or 1)

    # (C, T) views, each channel's windows in the order JAX walks them
    m_ct = mix[None] if mono else mix.T
    i_ct = instrumental[None] if mono else instrumental.T
    windows_done = 0
    results: dict[float, torch.Tensor] = {}
    for secs in align_window:
        win = int(sr * secs)
        step = win // 2
        n_w = _window_starts(length, win, step)
        sub = torch.zeros_like(mix)
        norm = torch.zeros_like(mix)
        if n_w:
            taper = torch.as_tensor(np.hanning(win), device=mix.device)
            wm = m_ct.unfold(-1, win, step)[:, :n_w] * taper        # (C, n_w, win) float64
            wi = i_ct.unfold(-1, win, step)[:, :n_w] * taper
            best = _realign_window(wm.flatten(0, 1), wi.flatten(0, 1), db_analysis,
                                   phase_shifts).view(n_ch, n_w, win)
            total = (n_w - 1) * step + win

            def overlap_add(cols):                                  # (N, win, n_w)
                return F.fold(cols, (1, total), (1, win), stride=(1, step))[:, 0, 0]

            s = overlap_add((wm - best).transpose(1, 2))            # (C, total)
            nm = overlap_add(taper[None, :, None].expand(1, win, n_w).contiguous())[0]
            sub_ct = sub[None] if mono else sub.T
            sub_ct[:, :total] = s.to(sub.dtype)
            norm_ct = norm[None] if mono else norm.T
            norm_ct[:, :total] = nm.to(norm.dtype)
        for _ in range((windows_done + n_w * n_ch) // tick_every - windows_done // tick_every):
            if progress_bar is not None:
                progress_bar(expected_ticks)
        windows_done += n_w * n_ch
        results[float(sub.abs().mean())] = torch.where(norm > 1e-6, sub / norm, sub)

    return ensemble_wav(list(results.values()), split_size=12)


@_spectral
def ensemble_wav(waveforms: list, split_size: int = 240):
    """Piecewise min-energy ensemble: every waveform cut into split_size
    chunks (np.array_split's sizes), the quietest chunk kept at each
    position, the first on a tie (spec_utils.py:821-827)."""
    chunked, means = [], []
    for w in waveforms:
        q, r = divmod(w.shape[0], split_size)
        a = w[:r * (q + 1)].reshape((r, q + 1) + tuple(w.shape[1:]))
        b = w[r * (q + 1):].reshape((split_size - r, q) + tuple(w.shape[1:]))
        dims = tuple(range(1, w.ndim + 1))
        means.append(torch.cat([a.abs().mean(dims), b.abs().mean(dims)]))
        chunked.append(torch.tensor_split(w, split_size))
    picks = torch.argmin(torch.stack(means), dim=0).tolist()
    return torch.cat([chunked[k][j] for j, k in enumerate(picks)])


@_spectral
def ensemble_wav_min(waveforms: list):
    """Sample-wise min-magnitude ensemble (spec_utils.py:829-837)."""
    waveforms = list(waveforms)
    wave = waveforms[0]
    for i in range(1, len(waveforms)):
        ln = min(len(wave), len(waveforms[i]))
        wave = wave[:ln]
        waveforms[i] = waveforms[i][:ln]
        wave = torch.where(waveforms[i].abs() <= wave.abs(), waveforms[i], wave)
    return wave


@_spectral
def align_audio_test(wav1, wav2, sr1: int = 44100):
    """Single-probe coarse alignment of wav2 onto wav1 (capability of
    spec_utils.py:839-852; the reference's single-column zero pad on a
    positive lag is kept)."""
    wav1, wav2 = wav1.T, wav2.T
    lag = _xcorr_lag(wav1[sr1:2 * sr1, 0], wav2[sr1:2 * sr1, 0])
    if lag > 0:
        if wav2.shape[1] != 1:
            raise ValueError("all the input array dimensions except for the concatenation "
                             f"axis must match exactly: (lag, 1) against {tuple(wav2.shape)}")
        return torch.cat([wav2.new_zeros((lag, 1), dtype=torch.float64), wav2.double()])
    return wav2[-lag:] if lag < 0 else wav2


# ----------------------------------------------------------------- file I/O


def load_audio(audio_file: str) -> np.ndarray:
    """(C, L) stereo at 44100 (spec_utils.py:854-857)."""
    wav = load_audio_maybe_mono(audio_file)
    if wav.ndim == 1:
        wav = np.asfortranarray([wav, wav])
    return wav


def load_audio_maybe_mono(audio_file: str) -> np.ndarray:
    """librosa.load(sr=44100, mono=False) on the repo's readers: mono files
    stay 1-D, stereo becomes (2, L)."""
    audio, sr = _read_wav_file(audio_file)
    if audio.ndim == 2:
        audio = audio.T  # (T, C) -> (C, T)
    if sr != 44100:
        audio = _resample(audio, sr, 44100)
    return np.asarray(audio, np.float32)


def _write_out(path: str, audio: np.ndarray, sr: int, wav_type_set: str) -> None:
    subtype = "float32" if "FLOAT" in (wav_type_set or "").upper() else "pcm16"
    _save_wav(path, np.asarray(audio), sr, subtype=subtype)


# -------------------------------------------------- rubberband replacements


def time_stretch(y: np.ndarray, sr: int, rate: float) -> np.ndarray:
    """Tempo change without pitch change (the reference runs rubberband,
    spec_utils.py:887-893; here the phase vocoder of utils/tts.py).
    rate > 1: a shorter output."""
    if rate <= 0:
        raise ValueError("rate must be positive")
    if rate == 1.0:
        return y
    from ..utils.tts import time_stretch as _pv_stretch

    return _pv_stretch(y, sr, (len(y) / sr) / rate)


def pitch_shift(y: np.ndarray, sr: int, n_steps: float, rbargs=None) -> np.ndarray:
    """Pitch shift keeping the duration (the reference runs rubberband,
    spec_utils.py:895-899; here the STFT shifter of utils/pitchshift.py)."""
    if n_steps == 0:
        return y
    from ..utils.pitchshift import shift_pitch

    return shift_pitch(np.asarray(y, np.float64), sr,
                       factors=2.0 ** (n_steps / 12.0)).astype(np.float32)
