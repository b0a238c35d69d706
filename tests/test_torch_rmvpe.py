"""The port's RMVPE (models/rmvpe.py) against the JAX package's: the
real structure at narrower widths (channels 4 -> 64), on about 1 s of
audio, with weights carried across by interop/from_jax.py (which
un-flips the decoder's transposed convs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.models import rmvpe as jrmvpe
from rvc_maker_tpu_torch.interop.from_jax import random_rmvpe_tree, rmvpe_from_jax
from rvc_maker_tpu_torch.models import rmvpe as trmvpe
from torch_port_util import n, rmvpe_state_dict, t, torch_threads  # noqa: F401

WIDTHS = (4, 8, 16, 32, 64)
INTER = 128


def _tree(seed=1234):
    tree = random_rmvpe_tree(seed, widths=WIDTHS, inter_width=INTER)
    rs = np.random.RandomState(seed + 1)

    def randomize_bn(node):
        if isinstance(node, dict):
            if set(node) == {"scale", "shift"}:
                c = node["scale"].shape[0]
                node["scale"] = rs.uniform(0.5, 1.5, c).astype(np.float32)
                node["shift"] = (rs.randn(c) * 0.1).astype(np.float32)
            else:
                for v in node.values():
                    randomize_bn(v)
        elif isinstance(node, list):
            for v in node:
                randomize_bn(v)

    randomize_bn(tree)
    return tree


@pytest.fixture(scope="module")
def params():
    tree = _tree()
    return jax.tree_util.tree_map(jnp.asarray, tree), rmvpe_from_jax(tree)


@pytest.fixture(scope="module")
def audio():
    tt = np.arange(16000) / 16000
    rs = np.random.RandomState(0)
    return (0.3 * np.sin(2 * np.pi * 220 * tt) + 0.05 * rs.randn(16000)
            ).astype(np.float32)[None]


def test_e2e_salience(params):
    jp, tp = params
    mel = np.random.RandomState(3).randn(1, 128, 64).astype(np.float32)
    ref = jrmvpe.e2e_apply(jp, jnp.asarray(mel))
    got = trmvpe.e2e_apply(tp, t(mel))
    assert got.shape == (1, 64, 360)
    np.testing.assert_allclose(n(got), n(ref), atol=1e-5)


def test_infer_f0(params, audio):
    jp, tp = params
    f0_ref = n(jrmvpe.infer(jp, jnp.asarray(audio)))
    f0, sal = trmvpe.infer(tp, t(audio), return_salience=True)
    assert f0.shape == f0_ref.shape == (1, 101)
    # the argmax class agrees on every frame, then the decoded f0
    mel = jrmvpe.rmvpe_mel(jnp.asarray(audio))
    pad_to = 32 * ((mel.shape[-1] - 1) // 32 + 1)
    mel = jnp.pad(mel, ((0, 0), (0, 0), (0, pad_to - mel.shape[-1])), mode="reflect")
    sal_ref = n(jrmvpe.e2e_apply(jp, mel))[:, :101]
    np.testing.assert_array_equal(n(sal).argmax(-1), sal_ref.argmax(-1))
    np.testing.assert_allclose(n(f0), f0_ref, atol=1e-2)


def test_decode_cents_ties_and_threshold():
    rs = np.random.RandomState(5)
    sal = (rs.rand(2, 40, 360) ** 4).astype(np.float32)
    sal[0, 3, [10, 200]] = 2.0          # tie: the first maximum wins
    sal[1, 5] = 0.01                     # under the threshold: unvoiced
    ref = n(jrmvpe.decode_cents(jnp.asarray(sal)))
    got = n(trmvpe.decode_cents(t(sal)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
    assert got[1, 5] == 0.0


def test_state_dict_loader_matches_jax_loader():
    sd = rmvpe_state_dict(random_rmvpe_tree(7, widths=WIDTHS, inter_width=INTER),
                     np.random.RandomState(8))
    jp = jrmvpe.params_from_state_dict(sd)
    tp = trmvpe.params_from_state_dict(sd)
    mel = np.random.RandomState(9).randn(1, 128, 32).astype(np.float32)
    np.testing.assert_allclose(n(trmvpe.e2e_apply(tp, t(mel))),
                               n(jrmvpe.e2e_apply(jp, jnp.asarray(mel))), atol=1e-5)
