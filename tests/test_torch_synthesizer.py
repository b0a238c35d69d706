"""The port's synthesizer (models/synthesizer.py) against the JAX
package's, on the same weights (carried across by interop/from_jax.py)
and the same explicit noise; plus the .pth round trip through the JAX
package's exporter and the port's loader."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.config import ModelConfig as JaxModelConfig
from rvc_maker_tpu.config import model_config_to_ckpt_list
from rvc_maker_tpu.interop.torch_export import synthesizer_state_dict
from rvc_maker_tpu.models import synthesizer as jsyn
from rvc_maker_tpu_torch.config import ModelConfig
from rvc_maker_tpu_torch.interop.from_jax import (random_synthesizer_tree,
                                                  synthesizer_from_jax)
from rvc_maker_tpu_torch.interop.pth import load_synthesizer_pth
from rvc_maker_tpu_torch.models import synthesizer as tsyn
from torch_port_util import n, t, torch_threads, tree_np  # noqa: F401

ATOL = 1e-4

JCFG = JaxModelConfig(
    spec_channels=129, segment_size=8, inter_channels=32, hidden_channels=32,
    filter_channels=64, n_heads=2, n_layers=2, kernel_size=3,
    resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)),
    upsample_rates=(4, 4, 2, 2), upsample_initial_channel=64,
    upsample_kernel_sizes=(8, 8, 4, 4), spk_embed_dim=4, gin_channels=16,
    sr=16000, use_f0=True, text_enc_hidden_dim=48)
CFG = ModelConfig(**dataclasses.asdict(JCFG))


@pytest.fixture(scope="module")
def params():
    # drawn with numpy in the JAX layouts (as init_params draws them, but
    # with a non-zero flow `post`, so that the flow is exercised)
    tree = random_synthesizer_tree(CFG, seed=0)
    return jax.tree_util.tree_map(jnp.asarray, tree), synthesizer_from_jax(tree, CFG)


_jax_infer_jit = jax.jit(lambda p, *a: jsyn.infer(p, JCFG, *a)[0])


def _inputs(b, T, seed=1):
    rs = np.random.RandomState(seed)
    phone = rs.randn(b, T, JCFG.text_enc_hidden_dim).astype(np.float32)
    lengths = np.array([T, max(1, T - 5)][:b], np.int64)
    f0 = rs.uniform(80, 500, (b, T)).astype(np.float32)
    f0[:, ::7] = 0.0                                   # unvoiced frames
    pitch = rs.randint(1, 255, (b, T))
    z = rs.randn(b, T, JCFG.inter_channels).astype(np.float32)
    s = rs.randn(b, T * JCFG.upp, 1).astype(np.float32)
    return phone, lengths, pitch, f0, z, s


@pytest.mark.parametrize("T", [9, 20, 21, 40])
def test_text_encoder(params, T):
    jp, tp = params
    phone, lengths, pitch, *_ = _inputs(2, T)
    ref = jsyn.text_encoder(jp["enc_p"], JCFG, jnp.asarray(phone), jnp.asarray(pitch),
                            jnp.asarray(lengths))
    got = tsyn.text_encoder(tp["enc_p"], CFG, t(phone), torch.as_tensor(pitch),
                            torch.as_tensor(lengths))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(n(g), n(r), atol=ATOL, rtol=1e-4)


def test_flow_reverse(params):
    jp, tp = params
    rs = np.random.RandomState(2)
    x = rs.randn(2, 30, JCFG.inter_channels).astype(np.float32)
    mask = np.ones((2, 30, 1), np.float32)
    mask[1, 24:] = 0
    g = rs.randn(2, 1, JCFG.gin_channels).astype(np.float32)
    ref = jsyn.flow(jp["flow"], jnp.asarray(x), jnp.asarray(mask), jnp.asarray(g),
                    reverse=True)
    got = tsyn.flow(tp["flow"], t(x), t(mask), t(g), reverse=True)
    np.testing.assert_allclose(n(got), n(ref), atol=ATOL, rtol=1e-4)


def test_sine_gen_negative_phase():
    rs = np.random.RandomState(3)
    upp, sr = 64, 16000
    f0 = rs.uniform(0, 1000, (2, 50)).astype(np.float32)   # end phase up to 4 cycles
    f0[:, ::5] = 0.0
    rad_last = f0[:, :-1] / sr * upp
    assert (np.mod(rad_last + 0.5, 1.0) - 0.5 < 0).any()   # negative offsets
    noise = rs.randn(2, 50 * upp, 1).astype(np.float32)
    ref = jsyn.sine_gen(jnp.asarray(f0), jnp.asarray(noise), upp=upp, sample_rate=sr)
    got = tsyn.sine_gen(t(f0), t(noise), upp=upp, sample_rate=sr)
    np.testing.assert_allclose(n(got), n(ref), atol=ATOL)


def test_generator_nsf(params):
    jp, tp = params
    rs = np.random.RandomState(4)
    T = 24
    x = (rs.randn(1, T, JCFG.inter_channels) * 0.3).astype(np.float32)
    f0 = rs.uniform(100, 300, (1, T)).astype(np.float32)
    g = (rs.randn(1, 1, JCFG.gin_channels) * 0.1).astype(np.float32)
    noise = rs.randn(1, T * JCFG.upp, 1).astype(np.float32)
    ref = jsyn.generator_nsf(jp["dec"], JCFG, jnp.asarray(x), jnp.asarray(f0),
                             jnp.asarray(g), jnp.asarray(noise))
    got = tsyn.generator_nsf(tp["dec"], CFG, t(x), t(f0), t(g), t(noise))
    assert got.shape == (1, T * CFG.upp, 1)
    np.testing.assert_allclose(n(got), n(ref), atol=ATOL)


def _jax_infer(jp, phone, lengths, pitch, f0, z, s):
    sid = jnp.asarray([0, 1][:phone.shape[0]])
    return _jax_infer_jit(jp, jnp.asarray(phone), jnp.asarray(lengths),
                          jnp.asarray(pitch), jnp.asarray(f0), sid, jnp.asarray(z),
                          jnp.asarray(s))


def _port_infer(tp, cfg, phone, lengths, pitch, f0, z, s):
    sid = torch.as_tensor([0, 1][:phone.shape[0]])
    return tsyn.infer(tp, cfg, t(phone), torch.as_tensor(lengths),
                      torch.as_tensor(pitch), t(f0), sid, t(z), t(s))[0]


def test_infer(params):
    jp, tp = params
    args = _inputs(2, 30)
    ref = _jax_infer(jp, *args)
    got = _port_infer(tp, CFG, *args)
    np.testing.assert_allclose(n(got), n(ref), atol=ATOL)


@pytest.mark.parametrize("spelling", ["parametrizations", "weight_g"])
def test_pth_round_trip(params, tmp_path, spelling):
    """JAX-layout params -> JAX torch_export state dict -> torch.save -> the
    port's load_synthesizer_pth: same waveform as JAX infer."""
    jp, _ = params
    sd = synthesizer_state_dict(tree_np(jp), JCFG)
    if spelling == "weight_g":
        sd = {k.replace("parametrizations.weight.original0", "weight_g")
               .replace("parametrizations.weight.original1", "weight_v"): v
              for k, v in sd.items()}
    assert any(spelling in k for k in sd)
    path = tmp_path / "model.pth"
    torch.save({"weight": {k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()},
                "config": model_config_to_ckpt_list(JCFG), "f0": 1,
                "version": "v2"}, path)
    tp, cfg, meta = load_synthesizer_pth(str(path))
    assert cfg.upsample_rates == JCFG.upsample_rates and meta["version"] == "v2"
    assert cfg.text_enc_hidden_dim == JCFG.text_enc_hidden_dim
    args = _inputs(2, 30)
    ref = _jax_infer(jp, *args)
    got = _port_infer(tp, cfg, *args)
    assert np.abs(n(got) - n(ref)).max() <= 1e-3
