"""The port's bf16 and checkpointed (remat) training steps on the tiny
config of tests/test_torch_train.py (disc_width_div=16), with the
thresholds of the JAX package's tests/test_train_step.py:99-145.

bf16: the port's bf16 step against the JAX bf16 step on the same weights
and the noise the JAX step draws in bf16: losses within 0.1 relative,
the G gradient norm within 0.25; master params and AdamW state stay fp32
and move.  remat: against the plain step, loss_g rtol 1e-4 and params
rtol 1e-3 / atol 1e-6; the resblock's forward runs again in the
backward."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.pipelines import train as jtrain
from rvc_maker_tpu_torch.ops import resblock as rb
from rvc_maker_tpu_torch.pipelines import train as ttrain
from test_torch_train import DIV, _batch_np
from test_torch_train_vocoders import (configs, jax_draws, jax_ref_step, jax_state,
                                       port_noise, port_state)
from torch_port_util import n, torch_threads, tree_np  # noqa: F401


def _port_step(kind, jstate, batch, noise, **modes):
    """One port step of `kind` from the JAX state; modes: TrainConfig's
    bf16 / remat."""
    _, pcfg = configs(kind)
    pcfg = dataclasses.replace(pcfg, train=dataclasses.replace(pcfg.train, **modes))
    state = port_state(pcfg, tree_np(jstate.params_g), tree_np(jstate.params_d))
    before = [leaf.detach().clone() for leaf in ttrain.tree_leaves(state.params_g)]
    m = ttrain.make_train_step(pcfg, DIV)(
        state, ttrain.Batch(**batch).to("cpu"), noise=noise, keep_grads=True)
    return state, before, m


@pytest.mark.parametrize("kind", ["nsf", "mrf"])
def test_bf16_step_tracks_jax_bf16(kind):
    jcfg, pcfg = configs(kind)
    jstate = jax_state(jcfg, pcfg, seed=2)
    b = _batch_np(seed=7)
    rng = jax.random.PRNGKey(13)
    ref = jax_ref_step(jcfg, bf16=True)(jstate, jtrain.Batch(**b), rng)[0]
    draws = jax_draws(kind, pcfg.model, rng, b["spec_lengths"], dtype=jnp.bfloat16)
    state, before, m = _port_step(kind, jstate, b, port_noise(draws, torch.bfloat16),
                                  bf16=True)
    for k in ("loss_g", "loss_d", "loss_mel", "loss_kl"):
        a, r = float(m[k]), float(ref[k])
        assert np.isfinite(a), (k, a)
        assert abs(a - r) / max(abs(r), 1e-6) < 0.1, (k, a, r)
    g, g_ref = float(m["grad_norm_g"]), float(ref["grad_norm_g"])
    assert abs(g - g_ref) / max(g_ref, 1e-6) < 0.25, (g, g_ref)
    # master params, their gradients and AdamW's moments stay fp32; params move
    leaves = ttrain.tree_leaves(state.params_g)
    assert all(v.dtype == torch.float32 for v in leaves + m["grads_g"] + m["grads_d"])
    assert all(v.dtype == torch.float32 for s in state.opt_g.state.values()
               for v in s.values() if torch.is_tensor(v) and v.is_floating_point())
    assert max(float((a.detach() - b0).abs().max()) for a, b0 in zip(leaves, before)) > 0


@pytest.mark.parametrize("kind", ["nsf", "plain", "mrf"])
def test_remat_step_matches_plain(kind, monkeypatch):
    jcfg, pcfg = configs(kind)
    jstate = jax_state(jcfg, pcfg, seed=3)
    b = _batch_np(seed=5)
    noise = port_noise(jax_draws(kind, pcfg.model, jax.random.PRNGKey(11), b["spec_lengths"]))
    calls = []
    forward_steps = rb._forward_steps
    monkeypatch.setattr(rb, "_forward_steps", lambda *a: calls.append(1) or forward_steps(*a))
    s1, _, m1 = _port_step(kind, jstate, b, noise)
    n_plain, calls[:] = len(calls), []
    s2, _, m2 = _port_step(kind, jstate, b, noise, remat=True)
    # each resblock's forward runs once more, in the backward's recompute
    n_blocks = len(pcfg.model.upsample_rates) * len(pcfg.model.resblock_kernel_sizes)
    assert n_plain == n_blocks and len(calls) == 2 * n_blocks
    np.testing.assert_allclose(float(m2["loss_g"]), float(m1["loss_g"]), rtol=1e-4)
    for a, r in zip(ttrain.tree_leaves(s2.params_g), ttrain.tree_leaves(s1.params_g)):
        np.testing.assert_allclose(n(a), n(r), rtol=1e-3, atol=1e-6)


def test_bf16_remat_composes():
    jcfg, pcfg = configs("nsf")
    jstate = jax_state(jcfg, pcfg, seed=4)
    b = _batch_np(seed=8)
    state, _, m = _port_step("nsf", jstate, b, None, bf16=True, remat=True)
    assert np.isfinite(float(m["loss_g"])) and np.isfinite(float(m["loss_d"]))
    assert state.step == 1


def test_modes_come_from_the_train_config():
    """make_train_step reads bf16 and remat from cfg.train; the noise it
    draws itself follows the compute dtype."""
    _, pcfg = configs("nsf")
    cfg = dataclasses.replace(pcfg, train=dataclasses.replace(pcfg.train, bf16=True,
                                                              remat=True))
    state = ttrain.init_state(cfg, device="cpu", disc_width_div=DIV, seed=1)
    m = ttrain.make_train_step(cfg, DIV)(state, ttrain.Batch(**_batch_np(seed=9)).to(
        "cpu", torch.bfloat16), keep_grads=True)
    assert np.isfinite(float(m["loss_g"]))
    assert all(g.dtype == torch.float32 for g in m["grads_g"])
