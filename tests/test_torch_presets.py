"""The port's synthesizer `infer` against the JAX package's at the decode
geometry of all six presets (v1/v2 x 32/40/48 kHz: upsample rates,
transposed-conv kernels, noise-conv strides, resblock kernels and
dilations, sample rate, content width), with the channel widths cut so
that the matrix runs in seconds.  The port's own copy of the presets is
held equal to the JAX package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.config import preset as jax_preset
from rvc_maker_tpu.models import synthesizer as jsyn
from rvc_maker_tpu_torch.config import preset
from rvc_maker_tpu_torch.interop.from_jax import (random_synthesizer_tree,
                                                  synthesizer_from_jax)
from rvc_maker_tpu_torch.models import synthesizer as tsyn
from torch_port_util import n, t, torch_threads  # noqa: F401

PRESETS = [("v1", 32000), ("v1", 40000), ("v1", 48000),
           ("v2", 32000), ("v2", 40000), ("v2", 48000)]
NARROW = dict(inter_channels=16, hidden_channels=16, filter_channels=32, n_layers=1,
              upsample_initial_channel=64, spk_embed_dim=2, gin_channels=16)


@pytest.mark.parametrize("version,sr", PRESETS)
def test_infer_at_preset_geometry(version, sr):
    full, jfull = preset(version, sr), jax_preset(version, sr)
    for part in ("model", "data"):
        assert (dataclasses.asdict(getattr(full, part))
                == dataclasses.asdict(getattr(jfull, part)))
    cfg = dataclasses.replace(full.model, **NARROW)
    jcfg = dataclasses.replace(jfull.model, **NARROW)
    tree = random_synthesizer_tree(cfg, seed=1)
    for u in tree["dec"]["ups"]:
        u["w"] *= 20.0
    tree["dec"]["conv_post"]["w"] *= 20.0

    rs = np.random.RandomState(2)
    b, T = 1, 13                                   # odd length: asymmetric pads
    phone = (rs.randn(b, T, cfg.text_enc_hidden_dim) * 0.5).astype(np.float32)
    lengths = np.array([T])
    pitch = rs.randint(1, 256, (b, T))
    f0 = rs.uniform(80, 380, (b, T)).astype(np.float32)
    f0[:, :3] = 0.0                                # unvoiced head
    sid = np.array([1])
    z = rs.randn(b, T, cfg.inter_channels).astype(np.float32)
    s = rs.randn(b, T * cfg.upp, 1).astype(np.float32)

    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    ref = jsyn.infer(jp, jcfg, jnp.asarray(phone), jnp.asarray(lengths),
                     jnp.asarray(pitch), jnp.asarray(f0), jnp.asarray(sid),
                     jnp.asarray(z), jnp.asarray(s))[0]
    got = tsyn.infer(synthesizer_from_jax(tree, cfg), cfg, t(phone),
                     torch.as_tensor(lengths), torch.as_tensor(pitch), t(f0),
                     torch.as_tensor(sid), t(z), t(s))[0]
    assert got.shape == (b, T * cfg.upp, 1) == ref.shape
    assert np.abs(n(ref)).max() > 0.05
    np.testing.assert_allclose(n(got), n(ref), atol=1e-4)
