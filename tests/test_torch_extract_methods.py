"""The port's training extract (pipelines/extract.py `extract_f0`) with
every F0 method of the JAX package's extract, against the JAX
`extract_f0` on the same 16 kHz segments and weights (a narrow RMVPE,
FCPE at width 128 in both layouts, CREPE tiny): f0 <= 1e-2 Hz on every
frame and the coarse codes equal, as tests/test_torch_convert_f0.py
holds the conversion's f0.  The port also takes device methods inside a
hybrid (hybrid[rmvpe+yin]), which the JAX extract does not."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rvc_maker_tpu.pipelines import extract as jextract
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.pipelines import extract as textract
from rvc_maker_tpu_torch.utils.audio import save_wav
from torch_port_util import torch_threads, voice  # noqa: F401

F0_HZ = 1e-2
METHODS = ["rmvpe", "rmvpe-legacy", "yin", "fcpe", "fcpe-legacy", "crepe-tiny",
           "mangio-crepe-tiny", "pyin", "dio", "harvest", "swipe", "pm", "hybrid[pm+swipe]"]


@pytest.fixture(scope="module")
def trees():
    crepe = from_jax.random_crepe_tree(seed=4, capacity="tiny")
    crepe["classifier"]["w"] *= 8.0     # peaked bins: a Viterbi path with a clear best
    return {"rmvpe": from_jax.random_rmvpe_tree(seed=2, widths=(4, 8, 16, 32, 64),
                                                inter_width=128),
            "fcpe": from_jax.random_fcpe_tree(seed=3, hidden=128, n_layers=2),
            "fcpe-legacy": from_jax.random_fcpe_tree(seed=5, hidden=128, n_layers=2,
                                                     legacy=True),
            "crepe": crepe}


@pytest.fixture(scope="module")
def segments(tmp_path_factory):
    """16 kHz segments of 0.7, 1.0 and 1.6 s (buckets of 1 and 2 s), a
    voice with an unvoiced gap."""
    d = tmp_path_factory.mktemp("seg") / "sliced_audios_16k"
    os.makedirs(d)
    for i, (sec, hz) in enumerate(((0.7, 150.0), (1.0, 210.0), (1.6, 120.0))):
        a = voice(sec, hz, seed=i)
        a[len(a) // 3 : len(a) // 2] *= 0.01
        save_wav(str(d / f"0_{i}.wav"), a, 16000, subtype="float32")
    return d


def _exp(root, segments):
    os.makedirs(root)
    os.symlink(segments, root / "sliced_audios_16k")
    return str(root)


def _nets(trees, method):
    fcpe = trees["fcpe-legacy" if "legacy" in method and "fcpe" in method else "fcpe"]
    return fcpe, trees["rmvpe"], trees["crepe"]


@pytest.mark.parametrize("method", METHODS)
def test_extract_f0_matches_jax(method, trees, segments, tmp_path):
    fcpe, rmvpe, crepe = _nets(trees, method)
    jp = jax.tree_util.tree_map(jnp.asarray, dict(fcpe=fcpe, rmvpe=rmvpe, crepe=crepe))
    ref = _exp(tmp_path / "jax", segments)
    got = _exp(tmp_path / "port", segments)
    assert jextract.extract_f0(ref, method=method, rmvpe_params=jp["rmvpe"],
                               crepe_params=jp["crepe"], fcpe_params=jp["fcpe"]) == 3
    assert textract.extract_f0(
        got, from_jax.rmvpe_from_jax(rmvpe), method=method,
        fcpe_params=from_jax.fcpe_from_jax(fcpe), crepe_params=from_jax.crepe_from_jax(crepe),
        device="cpu") == 3
    voiced = 0
    for name in sorted(os.listdir(os.path.join(ref, "f0_voiced"))):
        f0 = np.load(os.path.join(got, "f0_voiced", name))
        f0_ref = np.load(os.path.join(ref, "f0_voiced", name))
        assert f0.shape == f0_ref.shape, name
        # extract f0: <= 1e-2 Hz on every frame, coarse codes equal
        np.testing.assert_allclose(f0, f0_ref, atol=F0_HZ, rtol=0, err_msg=name)
        np.testing.assert_array_equal(np.load(os.path.join(got, "f0", name)),
                                      np.load(os.path.join(ref, "f0", name)), err_msg=name)
        voiced += int((f0_ref > 0).sum())
    assert voiced > 0


def test_extract_hybrid_with_device_members(trees, segments, tmp_path):
    """hybrid[rmvpe+yin]: each member's f0 on its own, zeros taken as
    missing, the per-frame nanmedian (JAX extract's hybrid rule)."""
    rmvpe = from_jax.rmvpe_from_jax(trees["rmvpe"])
    out = {}
    for method in ("rmvpe", "yin", "hybrid[rmvpe+yin]"):
        exp = _exp(tmp_path / method.replace("[", "_").replace("]", "_").replace("+", "_"),
                   segments)
        textract.extract_f0(exp, rmvpe, method=method, device="cpu")
        out[method] = {n: np.load(os.path.join(exp, "f0_voiced", n))
                       for n in sorted(os.listdir(os.path.join(exp, "f0_voiced")))}
    for name, hyb in out["hybrid[rmvpe+yin]"].items():
        stack = np.vstack([out["rmvpe"][name], out["yin"][name]]).astype(np.float64)
        want = np.nan_to_num(np.nanmedian(np.where(stack < 0.001, np.nan, stack), axis=0))
        np.testing.assert_allclose(hyb, want, atol=1e-3, rtol=0, err_msg=name)


def test_extract_f0_needs_the_method_weights(segments, tmp_path):
    exp = _exp(tmp_path / "e", segments)
    for method, name in (("rmvpe", "rmvpe"), ("fcpe", "fcpe"), ("crepe-tiny", "crepe")):
        with pytest.raises(ValueError, match=f"{name}_params not loaded"):
            textract.extract_f0(exp, method=method, device="cpu")
    with pytest.raises(ValueError, match="unknown f0 method"):
        textract.extract_f0(exp, method="nope", device="cpu")
