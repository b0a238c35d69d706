"""The port's CREPE (models/crepe.py) against the JAX package's: the
framing <= 1e-6, the network's probabilities <= 1e-5 (tiny on 1 s, full
on 8 frames), the host decode exact on the same numpy input, and a
reference-layout crepe_<capacity>.pth loading to the tree JAX loads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.models import crepe as jcrepe
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.models import crepe as tcrepe
from torch_port_util import crepe_state_dict, n, t, torch_threads, voice  # noqa: F401


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("hop", [160, 128])
def test_frame_audio_matches_jax(hop):
    audio = np.stack([voice(0.5, 200.0, 1), np.zeros(8000, np.float32)])
    ref = n(jcrepe.frame_audio(jnp.asarray(audio), hop))
    got = n(tcrepe.frame_audio(t(audio), hop))
    assert got.shape == ref.shape == (2, 1 + 8000 // hop, 1024)
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("capacity,seconds", [("tiny", 1.0), ("full", 8 * 160 / 16000 - 1e-4)])
def test_predict_probs_matches_jax(capacity, seconds):
    """tiny on 101 frames; full (1024/128/128/128/256/512 channels) on 8."""
    tree = from_jax.random_crepe_tree(seed=2, capacity=capacity)
    audio = voice(seconds, 240.0, 3)[None]
    ref = n(jax.jit(jcrepe.predict_probs, static_argnames="hop_length")(
        _jax(tree), jnp.asarray(audio), hop_length=160))
    got = n(tcrepe.predict_probs(from_jax.crepe_from_jax(tree), t(audio), 160))
    assert got.shape == ref.shape == (1, 1 + audio.shape[1] // 160, 360)
    err = np.abs(got - ref).max()
    print(f"predict_probs {capacity}: max abs err {err:.3e}")
    assert err <= 1e-5, err


def test_host_decode_equals_jax():
    """viterbi_decode, decode with and without periodicity, the filters:
    the same numpy input gives the same arrays."""
    rs = np.random.RandomState(4)
    probs = rs.rand(2, 60, 360).astype(np.float32) ** 4
    probs[:, :, 150:160] += 0.5
    np.testing.assert_array_equal(tcrepe.viterbi_decode(probs[0]),
                                  jcrepe.viterbi_decode(probs[0]))
    np.testing.assert_array_equal(tcrepe.decode(probs, 50.0, 1100.0),
                                  jcrepe.decode(probs, 50.0, 1100.0))
    for a, b in zip(tcrepe.decode(probs, 50.0, 1100.0, return_periodicity=True),
                    jcrepe.decode(probs, 50.0, 1100.0, return_periodicity=True)):
        np.testing.assert_array_equal(a, b)
    sig = rs.uniform(80, 400, (2, 40)).astype(np.float32)
    sig[0, 5:9] = np.nan
    np.testing.assert_array_equal(tcrepe.mean_filter(sig, 3), jcrepe.mean_filter(sig, 3))
    np.testing.assert_array_equal(tcrepe.median_filter(sig, 3), jcrepe.median_filter(sig, 3))
    np.testing.assert_array_equal(tcrepe.bins_to_frequency(np.arange(360)),
                                  jcrepe.bins_to_frequency(np.arange(360)))


@pytest.mark.parametrize("capacity", ["tiny", "small"])
def test_load_crepe_pth_matches_jax(tmp_path, capacity):
    tree = from_jax.random_crepe_tree(seed=5, capacity=capacity)
    path = tmp_path / f"crepe_{capacity}.pth"
    torch.save(crepe_state_dict(tree, np.random.RandomState(6)), path)
    ref = from_jax.crepe_from_jax(jcrepe.load_crepe_pth(str(path), capacity))
    got = tcrepe.load_crepe_pth(str(path), capacity)
    for key in ("convs", "bns"):
        for g, r in zip(got[key], ref[key]):
            for k in r:
                assert g[k].shape == r[k].shape
                np.testing.assert_allclose(n(g[k]), n(r[k]), rtol=1e-6, atol=0)
    for k in ("w", "b"):
        np.testing.assert_array_equal(n(got["classifier"][k]), n(ref["classifier"][k]))
