"""The port's HuBERT/ContentVec encoder (models/hubert.py) against the
JAX package's, on the same weights carried across by
interop/from_jax.py `hubert_from_jax` (which unstacks the layer axis)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.models import hubert as jhubert
from rvc_maker_tpu_torch.interop.from_jax import hubert_from_jax, random_hubert_tree
from rvc_maker_tpu_torch.models import hubert as thubert
from torch_port_util import n, t, torch_threads  # noqa: F401

ATOL = 1e-4
N_LAYERS = 10      # enough to tell layer 9 from layer 12 (= all layers)


@pytest.fixture(scope="module")
def params():
    tree = random_hubert_tree(seed=0, n_layers=N_LAYERS)
    return jax.tree_util.tree_map(jnp.asarray, tree), hubert_from_jax(tree)


@pytest.mark.parametrize("output_layer", [12, 9])
def test_extract_features(params, output_layer):
    jp, tp = params
    audio = (np.random.RandomState(1).randn(2, 4000) * 0.1).astype(np.float32)
    lengths = np.array([4000, 3100])
    ref, fl_ref = jhubert.extract_features(jp, jnp.asarray(audio), jnp.asarray(lengths),
                                           output_layer=output_layer)
    got, fl = thubert.extract_features(tp, t(audio), torch.as_tensor(lengths),
                                       output_layer=output_layer)
    np.testing.assert_array_equal(n(fl), n(fl_ref))
    np.testing.assert_allclose(n(got), n(ref), atol=ATOL, rtol=1e-4)


def test_final_proj(params):
    jp, tp = params
    x = np.random.RandomState(2).randn(1, 7, 768).astype(np.float32)
    np.testing.assert_allclose(n(thubert.final_proj(tp, t(x))),
                               n(jhubert.final_proj(jp, jnp.asarray(x))), atol=ATOL)


def test_padded_batch_matches_unpadded(params):
    """A right-padded row gives the features of the same audio alone on
    its valid frames (the JAX package's invariant)."""
    _, tp = params
    short = (np.random.RandomState(3).randn(1, 2560) * 0.1).astype(np.float32)
    padded = np.zeros((1, 3200), np.float32)
    padded[:, :2560] = short
    alone, fl_a = thubert.extract_features(tp, t(short))
    got, fl_p = thubert.extract_features(tp, t(padded), torch.as_tensor([2560]))
    k = int(fl_a[0])
    assert int(fl_p[0]) == k
    np.testing.assert_allclose(n(got)[0, :k], n(alone)[0, :k], atol=ATOL, rtol=1e-3)


def test_fairseq_loader_matches_jax_loader(params):
    """A synthetic fairseq-layout state dict (random values, weight-norm
    split positional conv) through the JAX importer and the port's."""
    rs = np.random.RandomState(4)
    sd = {}

    def put(name, *shape):
        sd[name] = torch.as_tensor(rs.randn(*shape).astype(np.float32) * 0.05)

    cin = 1
    for i, (dim, k, _) in enumerate(jhubert.CONV_LAYERS):
        put(f"feature_extractor.conv_layers.{i}.0.weight", dim, cin, k)
        cin = dim
    put("feature_extractor.conv_layers.0.2.weight", 512)
    put("feature_extractor.conv_layers.0.2.bias", 512)
    for name, c in (("layer_norm", 512), ("encoder.layer_norm", 768)):
        put(f"{name}.weight", c)
        put(f"{name}.bias", c)
    put("post_extract_proj.weight", 768, 512)
    put("post_extract_proj.bias", 768)
    put("encoder.pos_conv.0.weight_g", 1, 1, 128)
    put("encoder.pos_conv.0.weight_v", 768, 48, 128)
    put("encoder.pos_conv.0.bias", 768)
    for i in range(2):
        p = f"encoder.layers.{i}"
        for m in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put(f"{p}.self_attn.{m}.weight", 768, 768)
            put(f"{p}.self_attn.{m}.bias", 768)
        for m in ("self_attn_layer_norm", "final_layer_norm"):
            put(f"{p}.{m}.weight", 768)
            put(f"{p}.{m}.bias", 768)
        put(f"{p}.fc1.weight", 3072, 768)
        put(f"{p}.fc1.bias", 3072)
        put(f"{p}.fc2.weight", 768, 3072)
        put(f"{p}.fc2.bias", 768)
    # the JAX importer reads a fixed 12 layers; layers 2..11 repeat 0..1
    full = dict(sd)
    for i in range(2, 12):
        for k, v in sd.items():
            if k.startswith(f"encoder.layers.{i % 2}."):
                full[k.replace(f"encoder.layers.{i % 2}.", f"encoder.layers.{i}.")] = v
    jp = jhubert.params_from_fairseq_state_dict(full)
    tp = thubert.params_from_fairseq_state_dict(sd, n_layers=2)
    audio = (rs.randn(1, 3200) * 0.1).astype(np.float32)
    ref, _ = jhubert.extract_features(jp, jnp.asarray(audio), output_layer=2)
    got, _ = thubert.extract_features(tp, t(audio), output_layer=2)
    np.testing.assert_allclose(n(got), n(ref), atol=ATOL, rtol=1e-4)
