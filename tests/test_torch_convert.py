"""The slice as a whole: the port's ConvertPipeline on the CPU against
the JAX package's ConvertPipeline (fp32, compute_dtype=None) on the same
weights, carried across, with the retrieval index on and the noise that
the JAX pipeline draws fed to the port.  Waveform max abs err <= 1e-3.
Also the port's CLI `convert` on weight files written from the same
trees."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.config import ModelConfig as JaxModelConfig
from rvc_maker_tpu.config import model_config_to_ckpt_list
from rvc_maker_tpu.interop.torch_export import synthesizer_state_dict
from rvc_maker_tpu.pipelines.convert import ConvertPipeline as JaxPipeline
from rvc_maker_tpu.pipelines.convert import ConvertSettings as JaxSettings
from rvc_maker_tpu.pipelines.convert import change_rms as jax_change_rms
from rvc_maker_tpu_torch import cli
from rvc_maker_tpu_torch.config import ModelConfig
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.pipelines.convert import (ConvertPipeline, ConvertSettings,
                                                   change_rms)
from rvc_maker_tpu_torch.utils.audio import read_wav, save_wav
from torch_port_util import (hubert_state_dict, jax_noise, n, rmvpe_state_dict,
                             torch_threads)  # noqa: F401

WAVE_ATOL = 1e-3   # the BASELINE fp32 waveform target

JCFG = JaxModelConfig(
    spec_channels=129, segment_size=8, inter_channels=32, hidden_channels=32,
    filter_channels=64, n_heads=2, n_layers=1, kernel_size=3,
    resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)),
    upsample_rates=(4, 4, 2, 2), upsample_initial_channel=64,
    upsample_kernel_sizes=(8, 8, 4, 4), spk_embed_dim=4, gin_channels=16,
    sr=6400, use_f0=True, text_enc_hidden_dim=768)
CFG = ModelConfig(**dataclasses.asdict(JCFG))
RMVPE_WIDTHS = dict(widths=(4, 8, 16, 32, 64), inter_width=128)


def _loud_synth_tree():
    """Random synthesizer weights scaled up in the decode, so that the
    waveform spans a good part of [-1, 1] and 1e-3 is a tight bound."""
    tree = from_jax.random_synthesizer_tree(CFG, seed=0)
    for u in tree["dec"]["ups"]:
        u["w"] *= 20.0
    tree["dec"]["conv_post"]["w"] *= 20.0
    return tree


@pytest.fixture(scope="module")
def trees():
    rs = np.random.RandomState(5)
    return {
        "synth": _loud_synth_tree(),
        "hubert": from_jax.random_hubert_tree(seed=1, n_layers=2),
        "rmvpe": from_jax.random_rmvpe_tree(seed=2, **RMVPE_WIDTHS),
        "index": rs.randn(300, 768).astype(np.float32),
    }


@pytest.fixture(scope="module")
def pipes(trees):
    jp = jax.tree_util.tree_map(jnp.asarray, trees)
    jax_pipe = JaxPipeline(jp["synth"], JCFG, jp["hubert"], version="v2",
                           rmvpe_params=jp["rmvpe"], index_vectors=trees["index"],
                           compute_dtype=None)
    port = ConvertPipeline(from_jax.synthesizer_from_jax(trees["synth"], CFG), CFG,
                           from_jax.hubert_from_jax(trees["hubert"]), version="v2",
                           rmvpe_params=from_jax.rmvpe_from_jax(trees["rmvpe"]),
                           index_vectors=trees["index"], device="cpu")
    return jax_pipe, port


def _voice(seconds, f0=180.0, seed=0, gap=None):
    """A harmonic test tone with vibrato and noise, optionally silent in
    `gap` = (start_s, end_s)."""
    tt = np.arange(int(16000 * seconds)) / 16000
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.05 * np.sin(2 * np.pi * 3 * tt))) / 16000
    x = sum(0.3 / h * np.sin(h * phase) for h in (1, 2, 3))
    x = x + 0.01 * np.random.RandomState(seed).randn(len(tt))
    if gap is not None:
        x[int(gap[0] * 16000):int(gap[1] * 16000)] = 0.0
    return x.astype(np.float32)


def test_convert_batch_matches_jax(pipes):
    """B=2 rows of different lengths in one 1 s bucket."""
    jax_pipe, port = pipes
    audio = np.stack([_voice(1.0, 160.0, 1), _voice(1.0, 240.0, 2)])
    audio[1, 12000:] = 0.0
    lengths = np.array([16000, 12000])
    settings = dict(index_rate=0.5, protect=0.33, pitch=2)
    wav_j, pf_j = jax_pipe.convert_batch(audio, lengths, 1, JaxSettings(**settings))
    p_len = port.frames(audio.shape[1])
    assert pf_j.shape == (2, p_len)
    z, s = jax_noise(2, p_len, CFG.inter_channels, CFG.upp)
    wav, pf = port.convert_batch(audio, lengths, 1, ConvertSettings(**settings),
                                 z_noise=torch.as_tensor(z), noise={"sine": torch.as_tensor(s)})
    assert wav.shape == (2, p_len * CFG.upp)
    np.testing.assert_allclose(n(pf), n(pf_j), atol=1e-2)
    err = np.abs(n(wav) - n(wav_j)).max()
    assert np.abs(n(wav_j)).max() > 0.1
    assert np.isfinite(n(wav)).all() and err <= WAVE_ATOL, err


def test_convert_utterance_split_matches_jax(pipes):
    """3 s of audio with x_max 3 s: the utterance is cut at its
    low-energy point into two chunks of one 4 s bucket, each converted,
    trimmed of its pads and joined; then the RMS mix and the resample."""
    jax_pipe, port = pipes
    audio = _voice(3.0, 200.0, 3, gap=(1.45, 1.55))
    knobs = dict(index_rate=0.5, x_pad=1, x_query=1, x_center=2, x_max=3,
                 volume_envelope=0.5, resample_sr=16000)
    ref = jax_pipe.convert_utterance(audio, 0, JaxSettings(**knobs))
    chunks = []

    def noise_fn(b, p_len):
        chunks.append(p_len)
        z, s = jax_noise(b, p_len, CFG.inter_channels, CFG.upp)
        return torch.as_tensor(z), {"sine": torch.as_tensor(s)}

    got = port.convert_utterance(audio, 0, ConvertSettings(**knobs), noise_fn=noise_fn)
    assert len(chunks) == 2                               # the split ran
    assert got.shape == ref.shape
    assert abs(len(got) - 3.0 * 16000) <= 2 * CFG.upp * 16000 / CFG.sr
    err = np.abs(got - ref).max()
    assert np.abs(ref).max() > 0.1
    assert np.isfinite(got).all() and err <= WAVE_ATOL, err


def test_convert_batch_v1_matches_jax(trees):
    """A v1 model (layer-9 features through final_proj, a 256-d index),
    with the legacy RMVPE band and autotune, and protect off."""
    jcfg = dataclasses.replace(JCFG, text_enc_hidden_dim=256)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    synth = from_jax.random_synthesizer_tree(cfg, seed=7)
    for u in synth["dec"]["ups"]:
        u["w"] *= 20.0
    synth["dec"]["conv_post"]["w"] *= 20.0
    index = np.random.RandomState(8).randn(200, 256).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, dict(trees, synth=synth))
    jax_pipe = JaxPipeline(jp["synth"], jcfg, jp["hubert"], version="v1",
                           rmvpe_params=jp["rmvpe"], index_vectors=index,
                           compute_dtype=None)
    port = ConvertPipeline(from_jax.synthesizer_from_jax(synth, cfg), cfg,
                           from_jax.hubert_from_jax(trees["hubert"]), version="v1",
                           rmvpe_params=from_jax.rmvpe_from_jax(trees["rmvpe"]),
                           index_vectors=index, device="cpu")
    audio = _voice(1.0, 300.0, 4)[None]
    lengths = np.array([16000])
    settings = dict(index_rate=0.75, protect=0.5, f0_method="rmvpe-legacy",
                    f0_autotune=True, f0_autotune_strength=0.8)
    wav_j, pf_j = jax_pipe.convert_batch(audio, lengths, 0, JaxSettings(**settings))
    z, s = jax_noise(1, port.frames(16000), cfg.inter_channels, cfg.upp)
    wav, pf = port.convert_batch(audio, lengths, 0, ConvertSettings(**settings),
                                 z_noise=torch.as_tensor(z), noise={"sine": torch.as_tensor(s)})
    np.testing.assert_allclose(n(pf), n(pf_j), atol=1e-2)
    err = np.abs(n(wav) - n(wav_j)).max()
    assert np.abs(n(wav_j)).max() > 0.1
    assert np.isfinite(n(wav)).all() and err <= WAVE_ATOL, err


@pytest.mark.parametrize("rate", [0.0, 0.5, 1.0])
def test_change_rms_matches_jax(rate):
    rs = np.random.RandomState(9)
    source = (rs.randn(16000 * 2) * np.linspace(0.01, 0.5, 32000)).astype(np.float32)
    target = (rs.randn(6400 * 2) * 0.3).astype(np.float32)
    np.testing.assert_allclose(change_rms(source, 16000, target, 6400, rate),
                               jax_change_rms(source, 16000, target, 6400, rate),
                               rtol=1e-5, atol=1e-6)


def test_cli_convert_writes_wav(trees, tmp_path):
    """The port's CLI on a .pth written by the JAX exporter, a reference-
    layout rmvpe.pt and a fairseq-layout HuBERT checkpoint."""
    sd = synthesizer_state_dict(trees["synth"], JCFG)
    torch.save({"weight": {k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()},
                "config": model_config_to_ckpt_list(JCFG), "f0": 1, "version": "v2"},
               tmp_path / "voice.pth")
    torch.save(rmvpe_state_dict(trees["rmvpe"], np.random.RandomState(0)),
               tmp_path / "rmvpe.pt")
    torch.save({"model": hubert_state_dict(trees["hubert"])}, tmp_path / "hubert.pt")
    np.save(tmp_path / "total_fea.npy", trees["index"])
    save_wav(str(tmp_path / "in.wav"), _voice(1.5), 16000)
    rc = cli.main(["convert", "--input", str(tmp_path / "in.wav"),
                   "--output", str(tmp_path / "out.wav"),
                   "--model", str(tmp_path / "voice.pth"),
                   "--rmvpe-path", str(tmp_path / "rmvpe.pt"),
                   "--hubert-path", str(tmp_path / "hubert.pt"),
                   "--index", str(tmp_path / "total_fea.npy"), "--index-rate", "0.5",
                   "--device", "cpu"])
    assert rc == 0
    out, sr = read_wav(str(tmp_path / "out.wav"))
    assert sr == CFG.sr
    assert abs(len(out) - 1.5 * CFG.sr) <= 2 * CFG.upp
    assert np.isfinite(out).all() and np.abs(out).max() > 0


def test_cli_convert_missing_weights_is_an_error(tmp_path):
    save_wav(str(tmp_path / "in.wav"), _voice(0.5), 16000)
    with pytest.raises(FileNotFoundError, match="--model"):
        cli.main(["convert", "--input", str(tmp_path / "in.wav"),
                  "--output", str(tmp_path / "out.wav"),
                  "--model", str(tmp_path / "missing.pth"),
                  "--rmvpe-path", "x", "--hubert-path", "y", "--device", "cpu"])
