"""The port's Demucs (`rvc_maker_tpu_torch/models/demucs.py`) against the
JAX package's on the CPU, on the same weights and seeded inputs.

The weights are `interop/from_jax.py` `random_demucs_state_dict`, a
reference-named state dict: JAX's importer reads it (every key, which the
tests check), the port's importer reads it, and `demucs_from_jax` carries
JAX's tree over to the same port tree.  Three small models: HTDemucs
(channels 8, nfft 2048, depth 4, 3 transformer layers, 0.3 s segment),
HDemucs (channels 8, depth 6, BLSTM and LocalState from layer 4) and a
`cac=False` HDemucs through Wiener EM (1 iteration, residual).  Each JAX
forward is jitted once per module.  Bounds: single modules 1e-4 max
abs, whole forwards 1e-3 at mix amplitude 0.1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.models import demucs as jd
from rvc_maker_tpu_torch.interop.from_jax import demucs_from_jax, random_demucs_state_dict
from rvc_maker_tpu_torch.models import demucs as pd
from torch_port_util import n, torch_threads  # noqa: F401

MODULE_TOL = 1e-4
FORWARD_TOL = 1e-3

CONFIGS = {
    "htdemucs": (pd.DemucsConfig(nfft=2048, depth=4, segment=0.3, use_train_segment=True),
                 dict(channels=8, t_layers=3), 13000),
    "hdemucs": (pd.DemucsConfig(nfft=4096, depth=6, has_transformer=False, segment=0.4,
                                use_train_segment=False), dict(channels=8), 12288),
    "mask": (pd.DemucsConfig(nfft=4096, depth=6, has_transformer=False, cac=False,
                             wiener_iters=1, wiener_residual=True, segment=0.4,
                             use_train_segment=False), dict(channels=8), 12288),
}


def jax_cfg(cfg):
    return jd.DemucsConfig(**cfg.__dict__)


class _Recording(dict):
    """A dict that records the keys read from it."""

    def __init__(self, d):
        super().__init__(d)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


@pytest.fixture(scope="module")
def models():
    """name -> (cfg, state dict, keys JAX read, JAX tree, port tree, mix,
    JAX's forward on mix)."""
    out = {}
    for name, (cfg, kw, length) in CONFIGS.items():
        sd = random_demucs_state_dict(cfg, seed=len(name), **kw)
        rec = _Recording({k: v.numpy() for k, v in sd.items()})
        jtree = jd.htdemucs_params_from_state_dict(rec, jax_cfg(cfg))
        ptree = pd.params_from_state_dict(sd, cfg)
        mix = (np.random.RandomState(2).randn(1, 2, length) * 0.1).astype(np.float32)
        ref = np.asarray(jax.jit(lambda m, jt=jtree, c=jax_cfg(cfg): jd.apply_model_single(
            jt, c, m))(jnp.asarray(mix)))
        out[name] = (cfg, sd, rec.read, jtree, ptree, mix, ref)
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_random_state_dict_is_read_whole_by_jax(models, name):
    cfg, sd, read, *_ = models[name]
    assert set(sd) == read, sorted(set(sd) - read)[:10]


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.nn.Module):
        sa, sb = a.state_dict(), b.state_dict()
        assert set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa), path
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_demucs_from_jax_equals_the_port_importer(models, name):
    """JAX's tree carried over is the port importer's tree, leaf for leaf."""
    cfg, _, _, jtree, ptree, *_ = models[name]
    _assert_trees_equal(demucs_from_jax(jtree, cfg), ptree)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_apply_model_single_matches_jax(models, name):
    """HTDemucs, HDemucs (BLSTM + LocalState) and the Wiener mask path."""
    cfg, _, _, _, ptree, mix, ref = models[name]
    with torch.inference_mode():
        got = n(pd.apply_model_single(ptree, cfg, torch.as_tensor(mix)))
    assert got.shape == ref.shape == (1, 4, 2, mix.shape[-1])
    err = float(np.abs(got - ref).max())
    print(f"{name}: max abs {err:.3e}, |ref| std {ref.std():.3e}")
    assert ref.std() > 0.02, "the stems must carry signal for the bound to mean something"
    assert err <= FORWARD_TOL


def test_spectro_and_ispectro_match_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 4096).astype(np.float32)
    ref = np.asarray(jd._spectro(jnp.asarray(x), 512, 128))
    got = n(pd._spectro(torch.as_tensor(x), 512, 128))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= MODULE_TOL
    z = (rs.randn(2, 257, 30) + 1j * rs.randn(2, 257, 30)).astype(np.complex64)
    ref = np.asarray(jd._ispectro(jnp.asarray(z), 128, 3500))
    got = n(pd._ispectro(torch.as_tensor(z), 128, 3500))
    assert got.shape == ref.shape == (2, 3500)
    assert np.abs(got - ref).max() <= MODULE_TOL


@pytest.mark.parametrize("length,pads", [(100, (30, 40)), (20, (30, 40)), (5, (0, 9))],
                         ids=["long", "short", "shorter"])
def test_pad1d_reflect_matches_jax(length, pads):
    """Reflect padding, with the zero-padded fallback for a short input."""
    x = np.random.RandomState(1).randn(2, 3, length).astype(np.float32)
    ref = np.asarray(jd._pad1d(jnp.asarray(x), *pads, mode="reflect"))
    got = n(pd._pad1d(torch.as_tensor(x), *pads, mode="reflect"))
    np.testing.assert_array_equal(got, ref)


def _first_with(tree, key):
    for layer in tree["encoder"]:
        for dl in layer.get("dconv", {}).get("layers", []):
            if key in dl:
                return dl[key]
    raise AssertionError(key)


@pytest.mark.parametrize("t", [150, 450], ids=["one-frame", "framed"])
def test_blstm_matches_jax(models, t):
    """The 2-layer BLSTM with its linear and skip, in one piece (T <= 200)
    and in half-overlapping 200-step frames."""
    _, _, _, jtree, ptree, *_ = models["hdemucs"]
    jp, pp = _first_with(jtree, "lstm"), _first_with(ptree, "lstm")
    c = pp["linear"]["w"].shape[0]
    x = np.random.RandomState(3).randn(2, c, t).astype(np.float32)
    ref = np.asarray(jd._blstm_apply(jp, jnp.asarray(x.transpose(0, 2, 1)))).transpose(0, 2, 1)
    with torch.inference_mode():
        got = n(pd._blstm_apply(pp, torch.as_tensor(x)))
    assert np.abs(got - ref).max() <= MODULE_TOL


def test_local_state_matches_jax(models):
    _, _, _, jtree, ptree, *_ = models["hdemucs"]
    jp, pp = _first_with(jtree, "attn"), _first_with(ptree, "attn")
    c = pp["proj"]["w"].shape[0]
    x = np.random.RandomState(4).randn(2, c, 37).astype(np.float32)
    ref = np.asarray(jd._local_state_apply(jp, jnp.asarray(x.transpose(0, 2, 1))))
    got = n(pd._local_state_apply(pp, torch.as_tensor(x)))
    assert np.abs(got - ref.transpose(0, 2, 1)).max() <= MODULE_TOL


@pytest.mark.parametrize("layer", [0, 1], ids=["self", "cross"])
def test_transformer_layer_matches_jax(models, layer):
    """A self layer (even index) and a cross layer (odd: norm2 on the keys,
    norm3 before the feed-forward), each branch."""
    _, _, _, jtree, ptree, *_ = models["htdemucs"]
    rs = np.random.RandomState(5 + layer)
    c = ptree["transformer"]["layers"][0]["z"]["fc1"]["w"].shape[1]
    x = rs.randn(2, 24, c).astype(np.float32)
    kv = rs.randn(2, 17, c).astype(np.float32) if layer else None
    for branch in ("z", "t"):
        jp = jtree["transformer"]["layers"][layer][branch]
        pp = ptree["transformer"]["layers"][layer][branch]
        ref = np.asarray(jd._t_layer(jp, jnp.asarray(x), 8,
                                     cross_k=None if kv is None else jnp.asarray(kv)))
        got = n(pd._t_layer(pp, torch.as_tensor(x), 8,
                            cross_k=None if kv is None else torch.as_tensor(kv)))
        assert np.abs(got - ref).max() <= MODULE_TOL, branch


def test_cross_transformer_matches_jax(models):
    _, _, _, jtree, ptree, *_ = models["htdemucs"]
    c = ptree["transformer"]["norm_in"]["gamma"].shape[0]
    rs = np.random.RandomState(7)
    x = rs.randn(1, c, 4, 9).astype(np.float32)
    xt = rs.randn(1, c, 21).astype(np.float32)
    rz, rt = jd._cross_transformer(jtree["transformer"], jnp.asarray(x.transpose(0, 2, 3, 1)),
                                   jnp.asarray(xt.transpose(0, 2, 1)), 8)
    gz, gt = pd._cross_transformer(ptree["transformer"], torch.as_tensor(x),
                                   torch.as_tensor(xt), 8)
    assert np.abs(n(gz) - np.asarray(rz).transpose(0, 3, 1, 2)).max() <= MODULE_TOL
    assert np.abs(n(gt) - np.asarray(rt).transpose(0, 2, 1)).max() <= MODULE_TOL


@pytest.mark.parametrize("residual", [False, True])
def test_wiener_matches_jax(residual):
    """Wiener EM on one window (2 iterations, stereo, 3 sources)."""
    rs = np.random.RandomState(8)
    mags = np.abs(rs.randn(40, 33, 2, 3)).astype(np.float32)
    mix = (rs.randn(40, 33, 2) + 1j * rs.randn(40, 33, 2)).astype(np.complex64) * 20
    ref = np.asarray(jd.wiener(jnp.asarray(mags), jnp.asarray(mix), 2, residual=residual))
    got = n(pd.wiener(torch.as_tensor(mags), torch.as_tensor(mix), 2, residual=residual))
    assert got.shape == ref.shape == (40, 33, 2, 3 + residual)
    assert np.abs(got - ref).max() <= MODULE_TOL * max(1.0, np.abs(ref).max())


def test_wiener_mask_windows_match_jax():
    """Over more than one 300-frame window (the last one zero-padded)."""
    rs = np.random.RandomState(9)
    mags = np.abs(rs.randn(1, 2, 2, 17, 310)).astype(np.float32)
    mix = (rs.randn(1, 2, 17, 310) + 1j * rs.randn(1, 2, 17, 310)).astype(np.complex64)
    ref = np.asarray(jd.wiener_mask(jnp.asarray(mags), jnp.asarray(mix), 1, residual=True))
    got = n(pd.wiener_mask(torch.as_tensor(mags), torch.as_tensor(mix), 1, residual=True))
    assert got.shape == ref.shape == (1, 2, 2, 17, 310)
    assert np.abs(got - ref).max() <= MODULE_TOL


def test_invert_2x2():
    rs = np.random.RandomState(10)
    m = (rs.randn(5, 2, 2) + 1j * rs.randn(5, 2, 2)).astype(np.complex64)
    got = n(pd._invert_2x2(torch.as_tensor(m)))
    np.testing.assert_allclose(got @ m, np.broadcast_to(np.eye(2), (5, 2, 2)), atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jd._invert_2x2(jnp.asarray(m))), atol=1e-5)
