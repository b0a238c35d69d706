"""int8 quality gate on trained weights.

The int8 mode (RVC_TPU_INT8=1) stays off by default until it passes a
mel-distance gate on released checkpoints, which are not in the
repository.  This tool runs that gate on the nearest thing at hand: a
synthesizer `.pth` trained by `e2e_train` and a file of its training
corpus as input.  For each int8 scope it converts the same utterance in
bf16 and in int8 and reports the log-mel L1 distance, its maximum and the
waveform SNR between the two, with the mel parameters of the validator's
`bf16_gate` (n_fft 1024, 80 mels, hop 256), whose threshold (mel L1 <
1.0) it applies.

    python -m rvc_maker_tpu_torch.tools.int8_gate_rehearsal --pth e.pth
        --wav s000.wav [--seconds 6] [--scopes decode,all]
        [--f0-method rmvpe] [--out gate.json] [--cpu]

HuBERT and RMVPE are random, drawn from a seed.  Scope `all` is
RVC_TPU_INT8_SCOPE=decode,hubert,rmvpe.  On the card unless --cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

GATE_MEL_L1 = 1.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def log_mel(wav: np.ndarray, sr: int, device="cpu") -> np.ndarray:
    """Log-mel at the gate's parameters (`validate_real_weights`
    check_bf16): n_fft 1024, 80 mels, hop 256, win 1024, fmin 0."""
    import torch

    from ..ops.stft import mel_spectrogram

    with torch.inference_mode():
        m = mel_spectrogram(torch.as_tensor(np.asarray(wav, np.float32)[None], device=device),
                            n_fft=1024, num_mels=80, sample_rate=sr, hop_length=256,
                            win_length=1024, fmin=0.0, fmax=None)
    return m[0].cpu().numpy()


def gate_metrics(ref: np.ndarray, got: np.ndarray, sr: int, device="cpu") -> dict:
    """The gate's figures for a waveform `got` against `ref` (both at sr):
    mel_l1 and mel_max, the mean and max |log-mel difference| over their
    common frames (ref's log-mel from all of ref, got's from its first
    len(ref) samples); snr_db, 10 log10 of ref's power over the difference's
    on the common samples; passes_gate, mel_l1 < 1.0."""
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    n = min(len(ref), len(got))
    mel_ref = log_mel(ref, sr, device)
    mel_got = log_mel(got[:n], sr, device)
    # (frames, mels): the common frames (JAX's tool cuts the last axis,
    # the mels, and so takes only waveforms of one length)
    m = min(mel_ref.shape[0], mel_got.shape[0])
    diff = np.abs(mel_ref[:m] - mel_got[:m])
    err = ref[:n] - got[:n]
    snr = float(10 * np.log10(np.mean(ref[:n] ** 2) / max(np.mean(err ** 2), 1e-12)))
    mel_l1 = float(np.mean(diff))
    return {"mel_l1": mel_l1, "mel_max": float(np.max(diff)), "snr_db": snr,
            "passes_gate": mel_l1 < GATE_MEL_L1}


def random_nets(seed: int = 0) -> dict:
    """A random HuBERT and a random RMVPE (the port's trees) from `seed`."""
    from ..interop import from_jax

    return dict(hubert=from_jax.hubert_from_jax(from_jax.random_hubert_tree(seed)),
                rmvpe=from_jax.rmvpe_from_jax(from_jax.random_rmvpe_tree(seed + 1234)))


def build_pipeline(pth: str, device="cuda", nets: dict | None = None):
    """ConvertPipeline in bf16 on `device` with the .pth's synthesizer and
    `nets` (default `random_nets()`).  The int8 switches are read here,
    at construction."""
    import torch

    from ..interop.onnx_voice import load_voice_model
    from ..pipelines.convert import ConvertPipeline

    nets = nets or random_nets()
    synth, cfg, meta = load_voice_model(pth, device=device)
    return ConvertPipeline(synth, cfg, nets["hubert"], version=meta.get("version", "v2"),
                           rmvpe_params=nets["rmvpe"], device=device,
                           compute_dtype=torch.bfloat16)


def rehearse(pth: str, wav: str, *, seconds: float = 6.0, scopes: str = "decode,all",
             f0_method: str = "rmvpe", device="cuda", nets: dict | None = None,
             on_arm=None) -> dict:
    """The bf16 arm, then one int8 arm per scope; returns the figures.
    nets: HuBERT and RMVPE (default `random_nets()`).  on_arm(name, pipe,
    run) is called for each arm with the pipeline and the conversion it
    runs (a caller counts launches there); its return value replaces the
    arm's waveform when it is not None."""
    from ..pipelines.convert import ConvertSettings
    from ..utils.audio import load_audio

    audio = load_audio(wav, 16000)[: int(seconds * 16000)]
    settings = ConvertSettings(f0_method=f0_method, index_rate=0.0, deterministic=True)
    saved = {k: os.environ.get(k) for k in ("RVC_TPU_INT8", "RVC_TPU_INT8_SCOPE")}
    nets = nets or random_nets()

    def arm(name):
        pipe = build_pipeline(pth, device, nets)

        def convert():
            return np.asarray(pipe.convert_utterance(audio, 0, settings))
        out = on_arm(name, pipe, convert) if on_arm is not None else None
        return (convert() if out is None else out), pipe.cfg.sr

    try:
        os.environ.pop("RVC_TPU_INT8", None)
        os.environ.pop("RVC_TPU_INT8_SCOPE", None)
        log("arm A: bf16 (no int8) ...")
        ref, sr = arm("bf16")
        results = {"pth": pth, "wav": wav, "sr": sr, "seconds": float(len(audio) / 16000),
                   "device": str(device), "scopes": {}}
        for scope in [s for s in scopes.split(",") if s]:
            os.environ["RVC_TPU_INT8"] = "1"
            os.environ["RVC_TPU_INT8_SCOPE"] = ("decode,hubert,rmvpe" if scope == "all"
                                                else scope)
            log(f"arm B: int8 scope={scope} (calibration + convert) ...")
            got, _ = arm(scope)
            r = gate_metrics(ref, got, sr)
            results["scopes"][scope] = r
            log(f"scope={scope}: mel L1 {r['mel_l1']:.4f}, mel max {r['mel_max']:.3f}, "
                f"SNR {r['snr_db']:.1f} dB")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m rvc_maker_tpu_torch.tools.int8_gate_rehearsal")
    ap.add_argument("--pth", required=True)
    ap.add_argument("--wav", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--scopes", default="decode,all")
    ap.add_argument("--f0-method", default="rmvpe")
    ap.add_argument("--out", default="")
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)
    results = rehearse(a.pth, a.wav, seconds=a.seconds, scopes=a.scopes,
                       f0_method=a.f0_method, device="cpu" if a.cpu else "cuda")
    print(json.dumps(results))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(results, f, indent=2)
        log(f"written {a.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
