"""`.onnx` HuBERT embedders in the port: the JAX package's static and
dynamic exports and the port's own dynamic export, each through the
port's `OnnxEmbedder`, against JAX `extract_features` (jitted) on the
same weights, rtol 1e-3 / atol 1e-4; capacity overflow; the front-end
frame count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.interop import onnx_embedder as jemb
from rvc_maker_tpu.models import hubert as jhubert
from rvc_maker_tpu_torch.interop.from_jax import hubert_from_jax, random_hubert_tree
from rvc_maker_tpu_torch.interop.onnx_embedder import (DYNAMIC_MIN_SAMPLES, MIN_SAMPLES,
                                                       OnnxEmbedder, export_embedder,
                                                       load_embedder, n_frames)
from torch_port_util import n, torch_threads  # noqa: F401

CAP = 4000


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    td = tmp_path_factory.mktemp("onnx_emb")
    tree = random_hubert_tree(seed=0, n_layers=2)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    out = {"jax_static": str(td / "jax_static.onnx"), "jax_dynamic": str(td / "jax_dyn.onnx"),
           "port": str(td / "port.onnx")}
    jemb.export_embedder(jp, out["jax_static"], max_samples=CAP, dynamic=False)
    jemb.export_embedder(jp, out["jax_dynamic"])
    export_embedder(hubert_from_jax(tree), out["port"])
    fn = jax.jit(lambda a, ln: jhubert.extract_features(jp, a, ln, output_layer=12)[0])
    return out, lambda a, ln: np.asarray(fn(jnp.asarray(a), jnp.asarray(ln)))


@pytest.mark.parametrize("which,L", [("jax_static", 3200), ("jax_dynamic", 1600),
                                     ("jax_dynamic", 3200), ("port", 1600), ("port", 3200),
                                     ("port", 500)])
def test_features_match_jax(files, which, L):
    paths, ref_fn = files
    emb = load_embedder(paths[which], device="cpu")
    assert isinstance(emb, OnnxEmbedder) and emb.version == "v2"
    assert emb.dynamic == (which != "jax_static")
    rs = np.random.RandomState(L)
    audio = (rs.randn(2, L) * 0.1).astype(np.float32)
    lengths = np.asarray([L, L - 100], np.int32)
    got = n(emb.features(torch.as_tensor(audio), torch.as_tensor(lengths)))
    ref = ref_fn(audio, lengths)
    assert got.shape == ref.shape == (2, n_frames(L), 768)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_port_export_metadata(files):
    emb = OnnxEmbedder(files[0]["port"], device="cpu")
    assert emb.max_samples is None and emb.min_samples == DYNAMIC_MIN_SAMPLES
    assert emb.graph.input_names == ["source", "lengths"]
    assert jemb.OnnxEmbedder(files[0]["port"]).dynamic   # the JAX loader takes it
    assert MIN_SAMPLES == jemb.MIN_SAMPLES
    assert [n_frames(L) for L in (400, 3200, 4000)] == [jemb.n_frames(L)
                                                        for L in (400, 3200, 4000)]


def test_static_capacity_overflow_raises(files):
    emb = OnnxEmbedder(files[0]["jax_static"], device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        emb.features(torch.zeros(1, CAP + 320), torch.tensor([CAP]))
