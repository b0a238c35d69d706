"""The port's FCPE (models/fcpe.py) against the JAX package's on the same
weights and inputs, both checkpoint layouts: the mel front end <= 1e-4
(both of its pad branches), the salience <= 1e-4, the decode and the
whole estimator <= 1e-2 Hz; and reference-layout checkpoint files,
plain and encrypted, loading to the tree JAX loads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.models import fcpe as jfcpe
from rvc_maker_tpu_torch.interop import from_jax, modelcrypt
from rvc_maker_tpu_torch.models import fcpe as tfcpe
from torch_port_util import fcpe_state_dict, n, t, torch_threads, voice  # noqa: F401

F0_HZ = 1e-2


def _tree(legacy, hidden=128, n_layers=2, seed=3):
    return from_jax.random_fcpe_tree(seed=seed, hidden=hidden, n_layers=n_layers,
                                     legacy=legacy)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def assert_trees_equal(got, ref, rtol=0.0):
    """Port tree `got` against `ref`, leaf by leaf (None where ref has None)."""
    g, r = dict(_leaves(got)), dict(_leaves(ref))
    assert g.keys() == r.keys()
    for k, v in r.items():
        if v is None:
            assert g[k] is None, k
            continue
        assert tuple(g[k].shape) == tuple(v.shape), k
        np.testing.assert_allclose(n(g[k]), n(v), rtol=rtol, atol=0, err_msg=k)


@pytest.mark.parametrize("length", [200, 32000], ids=["constant-pad", "reflect-pad"])
def test_fcpe_mel_matches_jax(length):
    audio = (np.random.RandomState(length).randn(2, length) * 0.3).astype(np.float32)
    ref = n(jax.jit(jfcpe.fcpe_mel)(jnp.asarray(audio)))
    got = n(tfcpe.fcpe_mel(t(audio)))
    assert got.shape == ref.shape == (2, length // 160 + 1, 128)
    err = np.abs(got - ref).max()
    print(f"fcpe_mel L={length}: max abs err {err:.3e}")
    assert err <= 1e-4, err


def test_group_norm_matches_jax_on_a_non_square_layout():
    """F.group_norm on (B, C, T) against JAX's over (C/4 x T) on (B, T, C)."""
    rs = np.random.RandomState(0)
    x = (rs.randn(2, 7, 12) * 2 + 1).astype(np.float32)
    gamma, beta = rs.rand(12).astype(np.float32), rs.randn(12).astype(np.float32)
    ref = n(jfcpe._group_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta)))
    got = n(tfcpe._group_norm(t(x).transpose(1, 2), t(gamma), t(beta)).transpose(1, 2))
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("legacy", [False, True], ids=["current", "legacy"])
def test_salience_and_decode_match_jax(legacy):
    """Width 128, 2 layers (legacy: FAVOR+ attention in each), on the mel of
    2 s of a tone: the salience <= 1e-4; decode_local on the same salience
    <= 1e-2 Hz."""
    tree = _tree(legacy)
    mel = np.asarray(jfcpe.fcpe_mel(jnp.asarray(voice(2.0, 220.0, 1)[None])))
    ref = n(jax.jit(jfcpe.salience)(_jax(tree), jnp.asarray(mel)))
    port = from_jax.fcpe_from_jax(tree)
    got = n(tfcpe.salience(port, t(mel)))
    err = np.abs(got - ref).max()
    print(f"salience legacy={legacy}: max abs err {err:.3e}")
    assert got.shape == ref.shape == (1, 201, 360) and err <= 1e-4, err
    f0_ref = n(jfcpe.decode_local(jnp.asarray(ref), jnp.asarray(tree["cent_table"]), 0.03))
    f0 = n(tfcpe.decode_local(t(ref), port["cent_table"], 0.03))
    assert (f0 > 0).any()
    np.testing.assert_allclose(f0, f0_ref, atol=F0_HZ)


@pytest.mark.parametrize("legacy", [False, True], ids=["current", "legacy"])
def test_infer_matches_jax(legacy):
    """The whole estimator on 2 rows of 2 s at the pipeline's threshold,
    at its own frame count and interpolated to another (zeros as gaps)."""
    tree = _tree(legacy, seed=5)
    audio = np.stack([voice(2.0, 180.0, 2), voice(2.0, 300.0, 3)])
    audio[1, 12000:20000] = 0.0
    port = from_jax.fcpe_from_jax(tree)
    for p_len in (None, 150):
        ref = n(jfcpe.infer(_jax(tree), jnp.asarray(audio), threshold=0.03, p_len=p_len))
        got = n(tfcpe.infer(port, t(audio), threshold=0.03, p_len=p_len))
        assert got.shape == ref.shape == (2, p_len or 201)
        err = np.abs(got - ref).max()
        print(f"infer legacy={legacy} p_len={p_len}: max abs err {err:.3e} Hz")
        assert err <= F0_HZ, err


def test_interp_to_length_matches_jax():
    f0 = np.random.RandomState(1).uniform(80, 400, (2, 50)).astype(np.float32)
    f0[0, 10:20] = 0.0
    f0[1, :3] = 0.0
    ref = n(jfcpe.interp_to_length(jnp.asarray(f0), 173))
    got = n(tfcpe.interp_to_length(t(f0), 173))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("legacy", [False, True], ids=["current", "legacy"])
def test_full_width_salience_matches_jax(legacy):
    """The reference widths, 512 wide and 6 layers (legacy with 8 heads of
    64 and a 266 x 64 projection), on 20 frames."""
    tree = _tree(legacy, hidden=512, n_layers=6, seed=7)
    assert legacy == (tree["layers"][0]["attn"] is not None)
    mel = (np.random.RandomState(2).randn(1, 20, 128) * 2 - 4).astype(np.float32)
    ref = n(jax.jit(jfcpe.salience)(_jax(tree), jnp.asarray(mel)))
    got = n(tfcpe.salience(from_jax.fcpe_from_jax(tree), t(mel)))
    err = np.abs(got - ref).max()
    print(f"salience 512 x 6 legacy={legacy}: max abs err {err:.3e}")
    assert err <= 1e-4, err


@pytest.mark.parametrize("legacy", [False, True], ids=["current", "legacy"])
def test_load_fcpe_ckpt_matches_jax(tmp_path, legacy):
    """A checkpoint in the reference's key layout (weight-normed output
    projection) loads through the port into the tree that JAX's loader
    gives, carried across; the same file encrypted with the port's
    modelcrypt loads to the same tree."""
    tree = _tree(legacy, seed=9)
    ckpt = {"model": fcpe_state_dict(tree, legacy),
            ("config" if legacy else "config_dict"): {"model": {}}}
    path = tmp_path / "fcpe.pt"
    torch.save(ckpt, path)
    jtree, jlegacy = jfcpe.load_fcpe_ckpt(str(path))
    ref = from_jax.fcpe_from_jax(jtree)
    got, plegacy = tfcpe.load_fcpe_ckpt(str(path))
    assert plegacy == jlegacy == legacy
    assert_trees_equal(got, ref, rtol=1e-6)
    enc = tmp_path / "fcpe_enc.pt"
    enc.write_bytes(modelcrypt.encrypt_model_bytes(path.read_bytes(), iv=b"\x01" * 16))
    assert enc.read_bytes()[:2] != b"PK"
    got_enc, _ = tfcpe.load_fcpe_ckpt(str(enc))
    assert_trees_equal(got_enc, got)
