"""The port's discriminators and GAN losses (models/discriminator.py) and
the pretrained-D loader (interop/pth.py) against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.interop import torch_import as jimport
from rvc_maker_tpu.models import discriminator as jdisc
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.interop import pth as tpth
from rvc_maker_tpu_torch.models import discriminator as tdisc
from rvc_maker_tpu_torch.pipelines.train import tree_leaves
from torch_port_util import n, rel_close, t, torch_threads  # noqa: F401


def _to_jax_layout(fmap):
    """The port's (B, C, T) / (B, C, H, W) feature map -> channels-last."""
    return n(fmap.permute(0, 2, 1) if fmap.dim() == 3 else fmap.permute(0, 2, 3, 1))


@pytest.mark.parametrize("version,width_div,T", [("v2", 16, 512), ("v1", 8, 777)])
def test_mpd_matches_jax(version, width_div, T):
    jtree = from_jax.random_discriminator_tree(version, width_div, seed=1)
    ttree = from_jax.discriminator_from_jax(jtree)
    rs = np.random.RandomState(2)
    y = (rs.randn(2, T, 1) * 0.3).astype(np.float32)
    y_hat = (rs.randn(2, T, 1) * 0.3).astype(np.float32)
    periods = tdisc.periods_for(version)
    ref = jax.jit(jdisc.mpd_apply, static_argnums=(3, 4))(
        jtree, jnp.asarray(y), jnp.asarray(y_hat), periods, width_div)
    with torch.no_grad():
        got = tdisc.mpd_apply(ttree, t(y), t(y_hat), periods, width_div)
    assert len(got[0]) == len(ref[0]) == 1 + len(periods)
    # logits and every fmap: <= 1e-4 x max(1, |ref|max)
    for i in range(2):
        for a, r in zip(got[i], ref[i]):
            assert tuple(a.shape) == r.shape
            rel_close(n(a), n(r), 1e-4, "logits")
    for i in (2, 3):
        for fa, fr in zip(got[i], ref[i]):
            assert len(fa) == len(fr)
            for a, r in zip(fa, fr):
                rel_close(_to_jax_layout(a), n(r), 1e-4, "fmap")
    # the losses on these outputs
    ref_losses = (jdisc.feature_loss(ref[2], ref[3]),
                  jdisc.discriminator_loss(ref[0], ref[1])[0],
                  jdisc.generator_loss(ref[1])[0])
    got_losses = (tdisc.feature_loss(got[2], got[3]),
                  tdisc.discriminator_loss(got[0], got[1])[0],
                  tdisc.generator_loss(got[1])[0])
    for a, r in zip(got_losses, ref_losses):
        np.testing.assert_allclose(float(a), float(r), rtol=1e-5)


def test_kl_loss_matches_jax():
    rs = np.random.RandomState(3)
    z_p, logs_q, m_p, logs_p = (rs.randn(2, 11, 6).astype(np.float32) * 0.5
                                for _ in range(4))
    mask = (np.arange(11)[None, :, None] < np.array([11, 7])[:, None, None]).astype(np.float32)
    ref = jdisc.kl_loss(*(jnp.asarray(a) for a in (z_p, logs_q, m_p, logs_p, mask)))
    got = tdisc.kl_loss(*(t(a) for a in (z_p, logs_q, m_p, logs_p, mask)))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def _reference_d_state_dict(jtree):
    """A reference MultiPeriodDiscriminator state dict (weight_g /
    weight_v / bias) from a JAX-layout tree."""
    sd = {}

    def wn(prefix, p):
        axes = (2, 1, 0) if np.asarray(p["v"]).ndim == 3 else (3, 2, 0, 1)
        sd[f"{prefix}.weight_g"] = np.transpose(p["g"], axes)
        sd[f"{prefix}.weight_v"] = np.transpose(p["v"], axes)
        sd[f"{prefix}.bias"] = p["b"]

    for j, c in enumerate(jtree["s"]["convs"]):
        wn(f"discriminators.0.convs.{j}", c)
    wn("discriminators.0.conv_post", jtree["s"]["post"])
    for i, dp in enumerate(jtree["p"], start=1):
        for j, c in enumerate(dp["convs"]):
            wn(f"discriminators.{i}.convs.{j}", c)
        wn(f"discriminators.{i}.conv_post", dp["post"])
    return {k: torch.as_tensor(np.ascontiguousarray(v, np.float32)) for k, v in sd.items()}


def test_load_pretrained_d_matches_jax(tmp_path):
    jtree = from_jax.random_discriminator_tree("v2", width_div=16, seed=4)
    path = str(tmp_path / "f0D48k.pth")
    torch.save({"model": _reference_d_state_dict(jtree), "iteration": 1}, path)
    got = tpth.load_pretrained_d(path, "v2")
    ref = from_jax.discriminator_from_jax(jimport.load_pretrained_d(path, "v2"))
    a, r = tree_leaves(got), tree_leaves(ref)
    assert len(a) == len(r) == 3 * (7 + 8 * 6)      # (g, v, b) per conv
    for x, y in zip(a, r):
        assert x.shape == y.shape
        np.testing.assert_array_equal(n(x), n(y))


def test_random_discriminator_tree_has_jax_shapes():
    ref = jax.eval_shape(lambda: jdisc.init_params(jax.random.PRNGKey(0), "v1", 4))
    got = from_jax.random_discriminator_tree("v1", width_div=4)
    assert (jax.tree_util.tree_map(lambda a: tuple(a.shape), ref)
            == jax.tree_util.tree_map(np.shape, got))
