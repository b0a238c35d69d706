"""Configuration: training, data and synthesizer hyperparameters, presets.

A copy of `rvc_maker_tpu/config.py` (the port imports nothing of the JAX
package).  The preset matrices reproduce the reference v1/v2 × 32/40/48
kHz configs exactly.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Sequence


@dataclass(frozen=True)
class TrainConfig:
    log_interval: int = 200
    seed: int = 1234
    learning_rate: float = 1e-4
    betas: tuple[float, float] = (0.8, 0.99)
    eps: float = 1e-9
    lr_decay: float = 0.999875
    segment_size: int = 12800       # waveform samples per training slice
    c_mel: float = 45.0
    c_kl: float = 1.0
    # bf16 forward/backward over fp32 masters; checkpointed (recomputed)
    # forwards of G and D (pipelines/train.py make_train_step)
    bf16: bool = False
    remat: bool = False


@dataclass(frozen=True)
class DataConfig:
    max_wav_value: float = 32768.0
    sample_rate: int = 40000
    filter_length: int = 2048
    hop_length: int = 400
    win_length: int = 2048
    n_mel_channels: int = 125
    mel_fmin: float = 0.0
    mel_fmax: float | None = None


@dataclass(frozen=True)
class ModelConfig:
    """Synthesizer hyperparameters (reference synthesizers.py:396-426)."""

    spec_channels: int = 1025
    segment_size: int = 32
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.0
    resblock_kernel_sizes: tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: tuple[tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: tuple[int, ...] = (10, 10, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: tuple[int, ...] = (16, 16, 4, 4)
    spk_embed_dim: int = 109
    gin_channels: int = 256
    sr: int = 40000
    use_f0: bool = True
    text_enc_hidden_dim: int = 768  # 768 for v2, 256 for v1
    vocoder: str = "Default"
    rel_attn_window_size: int = 10

    @property
    def upp(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out


@dataclass(frozen=True)
class RVCConfig:
    version: str = "v2"
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


_DATA = {
    32000: dict(sample_rate=32000, filter_length=1024, hop_length=320, win_length=1024, n_mel_channels=80),
    40000: dict(sample_rate=40000, filter_length=2048, hop_length=400, win_length=2048, n_mel_channels=125),
    48000: dict(sample_rate=48000, filter_length=2048, hop_length=480, win_length=2048, n_mel_channels=128),
}

_UPSAMPLE = {
    ("v1", 32000): ((10, 4, 2, 2, 2), (16, 16, 4, 4, 4)),
    ("v1", 40000): ((10, 10, 2, 2), (16, 16, 4, 4)),
    ("v1", 48000): ((10, 6, 2, 2, 2), (16, 16, 4, 4, 4)),
    ("v2", 32000): ((10, 8, 2, 2), (20, 16, 4, 4)),
    ("v2", 40000): ((10, 10, 2, 2), (16, 16, 4, 4)),
    ("v2", 48000): ((12, 10, 2, 2), (24, 20, 4, 4)),
}

_SEGMENT = {
    ("v1", 32000): 12800, ("v1", 40000): 12800, ("v1", 48000): 11520,
    ("v2", 32000): 12800, ("v2", 40000): 12800, ("v2", 48000): 17280,
}


def preset(version: str = "v2", sample_rate: int = 40000, *,
           vocoder: str = "Default", pitch_guidance: bool = True) -> RVCConfig:
    """The preset for (version, sample_rate), as the reference JSON configs."""
    if version not in ("v1", "v2"):
        raise ValueError(f"unknown version {version!r}")
    if sample_rate not in _DATA:
        raise ValueError(f"unknown sample rate {sample_rate}")
    data = DataConfig(**_DATA[sample_rate])
    rates, kernels = _UPSAMPLE[(version, sample_rate)]
    seg = _SEGMENT[(version, sample_rate)]
    model = ModelConfig(
        spec_channels=data.filter_length // 2 + 1,
        segment_size=seg // data.hop_length,
        upsample_rates=rates,
        upsample_kernel_sizes=kernels,
        sr=sample_rate,
        text_enc_hidden_dim=768 if version == "v2" else 256,
        vocoder=vocoder,
        use_f0=pitch_guidance,
    )
    return RVCConfig(version=version, train=TrainConfig(segment_size=seg),
                     data=data, model=model)


def model_config_from_ckpt_list(cfg_list: Sequence[Any], *, use_f0: bool,
                                version: str, vocoder: str = "Default") -> ModelConfig:
    """ModelConfig from the 18-element list embedded in reference .pth
    inference weights (reference train.py:724-744 `extract_model`)."""
    c = list(cfg_list)
    sr = c[17]
    if isinstance(sr, str):
        sr = {"32k": 32000, "40k": 40000, "48k": 48000}.get(sr, 40000)
    return ModelConfig(
        spec_channels=int(c[0]),
        segment_size=int(c[1]),
        inter_channels=int(c[2]),
        hidden_channels=int(c[3]),
        filter_channels=int(c[4]),
        n_heads=int(c[5]),
        n_layers=int(c[6]),
        kernel_size=int(c[7]),
        p_dropout=float(c[8]),
        resblock_kernel_sizes=tuple(c[10]),
        resblock_dilation_sizes=tuple(tuple(d) for d in c[11]),
        upsample_rates=tuple(c[12]),
        upsample_initial_channel=int(c[13]),
        upsample_kernel_sizes=tuple(c[14]),
        spk_embed_dim=int(c[15]),
        gin_channels=int(c[16]),
        sr=int(sr),
        use_f0=bool(use_f0),
        text_enc_hidden_dim=768 if version == "v2" else 256,
        vocoder=vocoder,
    )


def model_config_to_ckpt_list(m: ModelConfig) -> list:
    """Inverse of model_config_from_ckpt_list (for writing interchange .pth)."""
    return [
        m.spec_channels, m.segment_size, m.inter_channels, m.hidden_channels,
        m.filter_channels, m.n_heads, m.n_layers, m.kernel_size, m.p_dropout,
        "1", list(m.resblock_kernel_sizes),
        [list(d) for d in m.resblock_dilation_sizes], list(m.upsample_rates),
        m.upsample_initial_channel, list(m.upsample_kernel_sizes),
        m.spk_embed_dim, m.gin_channels, m.sr,
    ]
