"""What the conversion generators share: the models from the seed, the
program's pipeline, the reference's models, the voices, the noise, and
the numbers that judge a conversion against the reference."""

from __future__ import annotations

import contextlib
import math

import torch

from . import roofline, weights
from .reference import convert as ref_convert
from .reference import rmvpe as ref_rmvpe

RANGES = ("convert.rmvpe", "convert.hubert_retrieval", "convert.synthesizer")


def build_models(config: dict, seed: int, device) -> dict:
    """Every network of a conversion configuration, drawn on the device
    from the seed: the synthesizer, HuBERT, RMVPE (its BiGRU raw) and the
    retrieval index's rows."""
    m = config["model"]
    return {
        "synth": weights.materialize(weights.synthesizer_spec(m), seed * 4 + 1, device),
        "hubert": weights.materialize(weights.hubert_spec(config["hubert"]), seed * 4 + 2,
                                      device),
        "rmvpe": weights.materialize(weights.rmvpe_spec(config["rmvpe"]), seed * 4 + 3, device),
        "index": weights.index_rows(config["index"]["rows"], config["index"]["dim"],
                                    seed * 4 + 4, device),
    }


def program_pipeline(config: dict, models: dict, device: str):
    """The port's ConvertPipeline on the models, fp32."""
    from rvc_maker_tpu_torch.config import ModelConfig
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline

    m = {k: (tuple(tuple(x) if isinstance(x, list) else x for x in v) if isinstance(v, list)
             else v) for k, v in config["model"].items()}
    cfg = ModelConfig(**m)
    return ConvertPipeline(models["synth"], cfg, models["hubert"], version="v2",
                           rmvpe_params=weights.program_rmvpe(models["rmvpe"]),
                           index_vectors=models["index"].cpu().numpy(),
                           max_device_batch=8, device=device)


def program_settings(params: dict):
    from rvc_maker_tpu_torch.pipelines.convert import ConvertSettings

    keys = ("f0_method", "index_rate", "protect", "x_pad", "x_query", "x_center", "x_max")
    return ConvertSettings(**{k: params[k] for k in keys if k in params})


def reference_models(models: dict) -> dict:
    """The reference's own copy of the models; its BiGRU built anew."""
    out = weights.clone_tree({k: v for k, v in models.items() if k != "rmvpe"})
    rp = weights.clone_tree({k: v for k, v in models["rmvpe"].items() if k != "gru_raw"})
    rp["gru"] = ref_rmvpe.make_bigru(models["rmvpe"]["gru_raw"]).to(
        models["rmvpe"]["gru_raw"]["w_ih"].device)
    out["rmvpe"] = rp
    return out


def voices(n: int, seconds, gen: torch.Generator, device) -> torch.Tensor:
    """n harmonic voices at 16 kHz, (n, max samples), each zero after its
    own length: a gliding f0 of 90-330 Hz with vibrato, six harmonics
    under a random spectral tilt, syllables of 0.15-0.6 s with short
    pauses, and a little breath noise; every parameter from `gen`."""
    lens = [int(16000 * s) for s in (seconds if isinstance(seconds, (list, tuple))
                                     else [seconds] * n)]
    L = max(lens)
    t = torch.arange(L, device=device, dtype=torch.float64) / 16000.0

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((n, 1), generator=gen, device=device,
                                           dtype=torch.float64)

    f0 = (u(90, 330) * (1 + u(-0.15, 0.15) * torch.sin(2 * math.pi * u(0.05, 0.2) * t))
          * (1 + u(0.01, 0.04) * torch.sin(2 * math.pi * u(4, 6.5) * t)))
    phase = 2 * math.pi * torch.cumsum(f0, dim=1) / 16000.0
    tilt = u(0.5, 1.5)
    x = sum(torch.sin(h * phase) / h ** tilt for h in range(1, 7))
    syl = 0.5 * (1 + torch.sin(2 * math.pi * u(1.6, 4.0) * t + u(0, 6.283)))
    env = torch.clamp(syl * 1.6 - 0.25, 0.0, 1.0)
    noise = torch.randn((n, L), generator=gen, device=device, dtype=torch.float64)
    x = 0.25 * x * env + 0.01 * noise
    mask = torch.arange(L, device=device)[None, :] < torch.tensor(lens, device=device)[:, None]
    return (x * mask).to(torch.float32)


def noise_pool(n_sets: int, rows: int, p_len: int, model: dict, gen, device) -> list:
    """n_sets of (z (rows, p_len, inter), sine (rows, p_len * upp, 1))."""
    upp = math.prod(model["upsample_rates"])
    return [(torch.randn((rows, p_len, model["inter_channels"]), generator=gen, device=device),
             torch.randn((rows, p_len * upp, 1), generator=gen, device=device))
            for _ in range(n_sets)]


F0_CENTS_OFF = 1.0


def f0_frames_off(got, ref) -> float:
    """Share of frames whose f0 the two tracks disagree on: voiced in one
    and not the other, or more than F0_CENTS_OFF cents apart.  (A widest
    gap in cents is no number to hold: RMVPE's argmax moves by whole bins
    where two bins of random weights' salience nearly tie.)"""
    got, ref = got.double(), ref.double()
    both = (got > 0) & (ref > 0)
    cents = (1200.0 * torch.log2(torch.where(both, got, 1.0) / torch.where(both, ref, 1.0))).abs()
    off = ((got > 0) != (ref > 0)) | (both & (cents > F0_CENTS_OFF))
    return float(off.double().mean())


def wave_gap(got, ref) -> float:
    """Widest sample gap over the reference's peak."""
    got, ref = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-6))


def resblock_launches(config: dict, rows: int, samples: int) -> list:
    """(B, C, T, k, dilation) of every resblock launch of one decode."""
    m = config["model"]
    p_len = ref_convert.frames(samples)
    return roofline.resblock_launch_shapes(m, rows, p_len)


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for cuBLAS and cuDNN on or off inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
