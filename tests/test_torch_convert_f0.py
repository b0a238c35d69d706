"""Conversion with every F0 method of the JAX package outside ONNX: the
port's ConvertPipeline on the CPU against the JAX package's (fp32) on
the same weights (a narrow NSF model, a 2-layer HuBERT, a narrow RMVPE,
FCPE at width 128 in both layouts, CREPE tiny) and the noise the JAX
pipeline draws: waveform <= 1e-3, pitchf <= 1e-2 Hz.  Also
deterministic noise and the missing-weight errors.  f0 files and
split-audio conversion are in test_torch_convert_split.py, transformers
HuBERT and the CLI in test_torch_convert_cli.py, on this file's model."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.config import ModelConfig as JaxModelConfig
from rvc_maker_tpu.pipelines.convert import ConvertPipeline as JaxPipeline
from rvc_maker_tpu.pipelines.convert import ConvertSettings as JaxSettings
from rvc_maker_tpu_torch.config import ModelConfig
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline, ConvertSettings
from torch_port_util import jax_noise, n, torch_threads, voice  # noqa: F401

WAVE_ATOL = 1e-3
F0_HZ = 1e-2

# tests/test_f0_dispatch.py's narrow model
JCFG = JaxModelConfig(
    spec_channels=129, segment_size=8, inter_channels=32, hidden_channels=32,
    filter_channels=64, n_heads=2, n_layers=1, kernel_size=3,
    resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
    upsample_rates=(4, 4, 2, 2), upsample_initial_channel=32,
    upsample_kernel_sizes=(8, 8, 4, 4), spk_embed_dim=4, gin_channels=16,
    sr=6400, use_f0=True, text_enc_hidden_dim=768)
CFG = ModelConfig(**dataclasses.asdict(JCFG))
RMVPE_WIDTHS = dict(widths=(4, 8, 16, 32, 64), inter_width=128)

METHODS = ["rmvpe", "yin", "fcpe", "fcpe-legacy", "crepe-tiny", "mangio-crepe-tiny", "pyin",
           "dio", "harvest", "swipe", "pm", "hybrid[yin+pyin]", "hybrid[rmvpe+fcpe+harvest]"]


@pytest.fixture(scope="module")
def trees():
    synth = from_jax.random_synthesizer_tree(CFG, seed=0)
    for u in synth["dec"]["ups"]:       # a loud decode: 1e-3 is a tight bound
        u["w"] *= 20.0
    synth["dec"]["conv_post"]["w"] *= 20.0
    crepe = from_jax.random_crepe_tree(seed=4, capacity="tiny")
    crepe["classifier"]["w"] *= 8.0     # peaked bins: a Viterbi path with a clear best
    return {"synth": synth, "hubert": from_jax.random_hubert_tree(seed=1, n_layers=2),
            "rmvpe": from_jax.random_rmvpe_tree(seed=2, **RMVPE_WIDTHS),
            "fcpe": from_jax.random_fcpe_tree(seed=3, hidden=128, n_layers=2),
            "fcpe-legacy": from_jax.random_fcpe_tree(seed=5, hidden=128, n_layers=2,
                                                     legacy=True),
            "crepe": crepe}


def _pipes(trees, fcpe_key="fcpe"):
    jp = jax.tree_util.tree_map(jnp.asarray, trees)
    jax_pipe = JaxPipeline(jp["synth"], JCFG, jp["hubert"], version="v2",
                           rmvpe_params=jp["rmvpe"], fcpe_params=jp[fcpe_key],
                           crepe_params=jp["crepe"], compute_dtype=None)
    port = ConvertPipeline(from_jax.synthesizer_from_jax(trees["synth"], CFG), CFG,
                           from_jax.hubert_from_jax(trees["hubert"]), version="v2",
                           rmvpe_params=from_jax.rmvpe_from_jax(trees["rmvpe"]),
                           fcpe_params=from_jax.fcpe_from_jax(trees[fcpe_key]),
                           crepe_params=from_jax.crepe_from_jax(trees["crepe"]), device="cpu")
    return jax_pipe, port


@pytest.fixture(scope="module")
def pipes(trees):
    return _pipes(trees)


@pytest.fixture(scope="module")
def legacy_pipes(trees):
    return _pipes(trees, "fcpe-legacy")


def _batch(seconds=1.0):
    audio = np.stack([voice(seconds, 160.0, 1), voice(seconds, 240.0, 2)])
    cut = int(16000 * seconds * 0.75)
    audio[1, cut:] = 0.0
    return audio, np.array([audio.shape[1], cut])


def _compare(jax_pipe, port, audio, lengths, settings, what):
    wav_j, pf_j = jax_pipe.convert_batch(audio, lengths, 0, JaxSettings(**settings))
    p_len = port.frames(audio.shape[1])
    z, s = jax_noise(len(audio), p_len, CFG.inter_channels, CFG.upp)
    wav, pf = port.convert_batch(audio, lengths, 0, ConvertSettings(**settings),
                                 z_noise=torch.as_tensor(z), noise={"sine": torch.as_tensor(s)})
    wav, pf, wav_j, pf_j = n(wav), n(pf), n(wav_j), n(pf_j)
    f0_err = float(np.abs(pf - pf_j).max())
    err = float(np.abs(wav - wav_j).max())
    print(f"{what}: pitchf max abs err {f0_err:.3e} Hz ({(pf_j > 0).mean():.2f} voiced), "
          f"waveform {err:.3e} (|wav|max {np.abs(wav_j).max():.3f})")
    assert pf.shape == pf_j.shape == (len(audio), p_len)
    assert np.abs(wav_j).max() > 0.1 and (pf_j > 0).any()
    assert f0_err <= F0_HZ, (what, f0_err)
    assert np.isfinite(wav).all() and err <= WAVE_ATOL, (what, err)
    return pf, pf_j


@pytest.mark.parametrize("method", METHODS)
def test_convert_batch_matches_jax(pipes, legacy_pipes, method):
    """B = 2 rows of one 1 s bucket (the second padded after 0.75 s),
    transposed 2 semitones; hybrid[yin+pyin] also autotuned."""
    jax_pipe, port = legacy_pipes if method == "fcpe-legacy" else pipes
    audio, lengths = _batch()
    settings = dict(f0_method=method, pitch=2, protect=0.33)
    if method == "hybrid[yin+pyin]":
        settings.update(f0_autotune=True, f0_autotune_strength=0.5)
    _compare(jax_pipe, port, audio, lengths, settings, method)


def test_deterministic_ignores_the_generator(pipes):
    _, port = pipes
    audio, lengths = _batch()
    outs = {}
    for det in (True, False):
        for seed in (1, 2):
            wav, _ = port.convert_batch(audio, lengths, 0,
                                        ConvertSettings(f0_method="yin", deterministic=det),
                                        generator=torch.Generator().manual_seed(seed))
            outs[det, seed] = n(wav)
    np.testing.assert_array_equal(outs[True, 1], outs[True, 2])
    assert np.abs(outs[False, 1] - outs[False, 2]).max() > 1e-3
    seeded0, _ = port.convert_batch(audio, lengths, 0, ConvertSettings(f0_method="yin"))
    np.testing.assert_array_equal(outs[True, 1], n(seeded0))


@pytest.mark.parametrize("method,missing", [("rmvpe", "rmvpe"), ("fcpe-legacy", "fcpe"),
                                            ("mangio-crepe-tiny", "crepe"),
                                            ("hybrid[pm+rmvpe]", "rmvpe"), ("nope", None)])
def test_pipeline_missing_weights_raise(trees, method, missing):
    """A pipeline without an F0 network's params raises when a method
    needs them, naming them; an unknown method raises too."""
    port = ConvertPipeline(from_jax.synthesizer_from_jax(trees["synth"], CFG), CFG,
                           from_jax.hubert_from_jax(trees["hubert"]), device="cpu")
    audio, lengths = _batch()
    match = f"{missing}_params not loaded" if missing else "unknown f0 method"
    with pytest.raises(ValueError, match=match):
        port.convert_batch(audio, lengths, 0, ConvertSettings(f0_method=method))
