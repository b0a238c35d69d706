"""The port's primitives (ops/nn.py, ops/stft.py, f0/common.py) against
the JAX package's, on the same numpy inputs.  Also: the port imports no
JAX and nothing of the JAX package."""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.f0 import common as jf0
from rvc_maker_tpu.ops import nn as jnn
from rvc_maker_tpu.ops import stft as jstft
from rvc_maker_tpu_torch.f0 import common as tf0
from rvc_maker_tpu_torch.ops import nn as tnn
from rvc_maker_tpu_torch.ops import stft as tstft
from torch_port_util import n, t, torch_threads  # noqa: F401

ATOL = 1e-5
REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("stride,dilation,padding,groups", [
    (1, 1, 3, 1), (1, 3, 3, 1), (2, 1, (1, 2), 1), (5, 1, 0, 1), (1, 1, 4, 4),
])
def test_conv1d(stride, dilation, padding, groups):
    rs = np.random.RandomState(0)
    x = rs.randn(2, 37, 8).astype(np.float32)
    w = rs.randn(7, 8 // groups, 12).astype(np.float32) * 0.3
    b = rs.randn(12).astype(np.float32)
    ref = jnn.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                     dilation=dilation, padding=padding, groups=groups)
    got = tnn.conv1d(t(x).transpose(1, 2), t(w).permute(2, 1, 0), t(b),
                     stride=stride, dilation=dilation, padding=padding,
                     groups=groups).transpose(1, 2)
    np.testing.assert_allclose(n(got), n(ref), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("u,k", [(12, 24), (10, 20), (2, 4), (5, 10), (3, 6)])
def test_conv_transpose1d_stage_paddings(u, k):
    """Even and odd strides with the padding / output_padding that
    _stage_paddings gives (output_padding = u % 2)."""
    convt_pad = ((k - u) // 2) if u % 2 == 0 else (u // 2 + u % 2)
    out_pad = u % 2
    rs = np.random.RandomState(u)
    x = rs.randn(2, 9, 6).astype(np.float32)
    w = rs.randn(k, 6, 4).astype(np.float32) * 0.3      # JAX (K, Cin, Cout)
    b = rs.randn(4).astype(np.float32)
    ref = jnn.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               stride=u, padding=convt_pad,
                               output_padding=out_pad)
    got = tnn.conv_transpose1d(t(x).transpose(1, 2), t(w).permute(1, 2, 0), t(b),
                               stride=u, padding=convt_pad,
                               output_padding=out_pad).transpose(1, 2)
    assert got.shape[1] == 9 * u
    np.testing.assert_allclose(n(got), n(ref), atol=ATOL, rtol=1e-5)


def test_dense_ops():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 5, 6).astype(np.float32)
    w = rs.randn(6, 3).astype(np.float32)
    b = rs.randn(3).astype(np.float32)
    np.testing.assert_allclose(n(tnn.linear(t(x), t(w.T), t(b))),
                               n(jnn.linear(x, w, b)), atol=ATOL)
    g, be = rs.randn(6).astype(np.float32), rs.randn(6).astype(np.float32)
    np.testing.assert_allclose(n(tnn.layer_norm(t(x), t(g), t(be))),
                               n(jnn.layer_norm(x, g, be)), atol=ATOL)
    table = rs.randn(10, 4).astype(np.float32)
    ids = rs.randint(0, 10, (2, 7))
    np.testing.assert_array_equal(n(tnn.embedding(t(table), torch.as_tensor(ids))),
                                  n(jnn.embedding(table, ids)))
    lengths = np.array([3, 7])
    np.testing.assert_array_equal(
        n(tnn.sequence_mask(torch.as_tensor(lengths), 9)),
        n(jnn.sequence_mask(jnp.asarray(lengths), 9)))
    gx = rs.randn(2, 5, 8).astype(np.float32)
    gg = rs.randn(2, 1, 8).astype(np.float32)
    np.testing.assert_allclose(n(tnn.fused_gate(t(gx), t(gg))),
                               n(jnn.fused_gate(gx, gg)), atol=ATOL)
    np.testing.assert_array_equal(n(tnn.interp_nearest_x2(t(x))),
                                  n(jnn.interp_nearest_x2(x)))
    for slope in (0.1, 0.01):
        np.testing.assert_allclose(n(tnn.leaky_relu(t(x), slope)),
                                   n(jnn.leaky_relu(x, slope)), atol=0)


def test_rmvpe_mel():
    rs = np.random.RandomState(2)
    audio = (rs.randn(2, 8000) * 0.3).astype(np.float32)
    ref = n(jstft.rmvpe_mel(jnp.asarray(audio)))
    got = n(tstft.rmvpe_mel(t(audio)))
    assert got.shape == ref.shape == (2, 128, 51)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(tstft.mel_filterbank(16000, 1024, 128, 30.0, 8000.0, True),
                                  jstft.mel_filterbank(16000, 1024, 128, 30.0, 8000.0, True))


def test_f0_common():
    rs = np.random.RandomState(3)
    f0 = np.concatenate([rs.uniform(40, 1200, 200), [0.0, 0.0]]).astype(np.float32)
    f0 = f0[None]
    np.testing.assert_array_equal(n(tf0.coarse_f0(t(f0))), n(jf0.coarse_f0(jnp.asarray(f0))))
    # coarse_f0 rounds half to even on both sides (torch.round, jnp.rint)
    halves = np.array([0.5, 1.5, 2.5, 100.5, 101.5], np.float32)
    np.testing.assert_array_equal(n(torch.round(t(halves))), n(jnp.rint(halves)))
    np.testing.assert_allclose(n(tf0.shift_f0(t(f0), 3)),
                               n(jf0.shift_f0(jnp.asarray(f0), 3)), rtol=1e-6)
    np.testing.assert_allclose(n(tf0.autotune_f0(t(f0), 0.7)),
                               n(jf0.autotune_f0(jnp.asarray(f0), 0.7)), rtol=1e-6)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("root", ["rvc_maker_tpu_torch", "chip_smoke.py"])
def test_port_imports_no_jax(root):
    path = REPO / root
    files = [path] if path.is_file() else sorted(path.rglob("*.py"))
    assert files
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "rvc_maker_tpu"), (f, mod)
