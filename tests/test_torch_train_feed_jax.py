"""The bf16 train step on a bf16-fed spectrogram (RVC_TPU_BF16_SPEC=1,
`pipelines/train.py` Batch.to(half_spec=True)) against the JAX bf16 step
fed spec.astype(bfloat16), at test_torch_train_modes.py's bounds (loss
terms within 0.1 relative, the G gradient norm within 0.25), on the tiny
NSF config of tests/test_torch_train_vocoders.py.  The mel target comes
from the spec in fp32 on both sides (JAX train.py:179,
`pipelines/train.py` g_loss); the bf16 spec moves loss_mel off the fp32
spec's.  Its own file: the JAX bf16 step's compile takes ~45 s."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from rvc_maker_tpu.pipelines import train as jtrain
from rvc_maker_tpu_torch.pipelines import train as ttrain
from test_torch_train import DIV, _batch_np
from test_torch_train_vocoders import (configs, jax_draws, jax_ref_step, jax_state, port_noise,
                                       port_state)
from torch_port_util import torch_threads, tree_np  # noqa: F401


def test_bf16_step_on_a_bf16_spec_tracks_jax():
    jcfg, pcfg = configs("nsf")
    pcfg = dataclasses.replace(pcfg, train=dataclasses.replace(pcfg.train, bf16=True))
    jstate = jax_state(jcfg, pcfg, seed=2)
    b = _batch_np(seed=7)
    rng = jax.random.PRNGKey(13)
    jb = dict(b, spec=b["spec"].astype(ml_dtypes.bfloat16))
    ref = jax_ref_step(jcfg, bf16=True)(jstate, jtrain.Batch(**jb), rng)[0]
    draws = jax_draws("nsf", pcfg.model, rng, b["spec_lengths"], dtype=jnp.bfloat16)
    state = port_state(pcfg, tree_np(jstate.params_g), tree_np(jstate.params_d))
    batch = ttrain.Batch(**b).to("cpu", torch.bfloat16, half_spec=True)
    assert batch.spec.dtype == torch.bfloat16
    m = ttrain.make_train_step(pcfg, DIV)(state, batch, noise=port_noise(draws, torch.bfloat16))
    for k in ("loss_g", "loss_d", "loss_mel", "loss_kl"):
        a, r = float(m[k]), float(ref[k])
        assert np.isfinite(a), (k, a)
        assert abs(a - r) / max(abs(r), 1e-6) < 0.1, (k, a, r)
    g, g_ref = float(m["grad_norm_g"]), float(ref["grad_norm_g"])
    assert abs(g - g_ref) / max(g_ref, 1e-6) < 0.25, (g, g_ref)
    # the mel target from the bf16 spec differs from the fp32 spec's
    fp32_state = port_state(pcfg, tree_np(jstate.params_g), tree_np(jstate.params_d))
    m32 = ttrain.make_train_step(pcfg, DIV)(fp32_state, ttrain.Batch(**b).to(
        "cpu", torch.bfloat16), noise=port_noise(draws, torch.bfloat16))
    assert float(m32["loss_mel"]) != float(m["loss_mel"])
