"""The port's resblock (ops/resblock.py) against the JAX package's.

On the CPU `fused_resblock` runs its plain version, `_resblock`, which
is held against JAX `_resblock` (models/synthesizer.py) and against the
Pallas kernel in interpret mode.  The CUDA kernel itself is checked on
the card by tests/test_torch_gpu.py and by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.models.synthesizer import _resblock as jax_resblock
from rvc_maker_tpu.ops.pallas_resblock import fused_resblock as pallas_resblock
from rvc_maker_tpu.ops.pallas_resblock import pack_resblock_weights
from rvc_maker_tpu_torch.ops import resblock as trb
from torch_port_util import (n, packed_resblock, resblock_params, resblock_x, t, tree_np,
                             torch_threads)  # noqa: F401

SHAPES = [
    (3, (1, 3, 5), 32, 700),
    (3, (1, 3, 5), 128, 512),
    (7, (1, 3, 5), 64, 1030),
    (11, (1, 3, 5), 32, 300),
    (3, (1, 2), 96, 450),
]


@pytest.mark.parametrize("k,dils,C,T", SHAPES)
def test_plain_matches_jax_resblock(k, dils, C, T):
    p = resblock_params(k * 1000 + C, k, C, len(dils))
    x = resblock_x(T, C)
    ref = jax_resblock(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                       kernel_size=k, dilations=dils)
    got = trb.fused_resblock(t(x).transpose(1, 2).contiguous(), *packed_resblock(p),
                             kernel_size=k, dilations=dils)
    np.testing.assert_allclose(n(got.transpose(1, 2)), n(ref), atol=2e-5, rtol=2e-5)


def test_plain_matches_pallas_interpret():
    k, dils, C, T = 3, (1, 3, 5), 32, 300
    p = resblock_params(5, k, C, len(dils))
    x = resblock_x(T, C, b=1)
    w1, b1, w2, b2 = pack_resblock_weights(jax.tree_util.tree_map(jnp.asarray, p),
                                           kernel_size=k, dilations=dils)
    ref = pallas_resblock(jnp.asarray(x), w1, b1, w2, b2, kernel_size=k,
                          dilations=dils, interpret=True, t_tile=256)
    got = trb._resblock(t(x).transpose(1, 2), *packed_resblock(p), kernel_size=k,
                        dilations=dils)
    np.testing.assert_allclose(n(got.transpose(1, 2)), n(ref), atol=2e-5, rtol=2e-5)


def test_cpu_tensor_takes_plain_version_without_launch():
    k, dils, C, T = 7, (1, 3, 5), 32, 200
    p = resblock_params(6, k, C, len(dils))
    x = t(resblock_x(T, C)).transpose(1, 2).contiguous()
    before = trb.resblock_launches
    got = trb.fused_resblock(x, *packed_resblock(p), kernel_size=k, dilations=dils)
    assert trb.resblock_launches == before
    torch.testing.assert_close(got, trb._resblock(x, *packed_resblock(p), kernel_size=k,
                                                   dilations=dils), rtol=0, atol=0)


def test_other_devices_raise():
    x = torch.zeros(1, 32, 10, device="meta")
    w = torch.zeros(1, 3, 32, 32, device="meta")
    b = torch.zeros(1, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        trb.fused_resblock(x, w, b, w, b, kernel_size=3, dilations=(1,))


def test_pipeline_on_cuda_raises_without_card():
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline

    if torch.cuda.is_available():
        pytest.skip("a card is present: the pipeline would run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        ConvertPipeline({}, None, {}, rmvpe_params={}, device="cuda")


def test_resblock_flops():
    assert trb.resblock_flops(1, 12000, 256, 11, 3) == 2 * 2 * 3 * 12000 * 11 * 256 * 256


@pytest.mark.parametrize("k,dils,C,T", [(3, (1, 3, 5), 16, 120), (7, (1, 3, 5), 32, 90),
                                        (11, (1, 3, 5), 16, 150)])
def test_autograd_matches_jax_grad(k, dils, C, T):
    """Gradients of the port's fused_resblock (its autograd backward) in
    x and every packed weight and bias, against jax.grad of the JAX
    `_resblock`: <= 1e-4 x max(1, |ref|max)."""
    p = resblock_params(k + C, k, C, len(dils))
    x = resblock_x(T, C)
    cot = np.random.RandomState(k).randn(*x.shape).astype(np.float32)

    def loss(params, xx):
        out = jax_resblock(params, xx, kernel_size=k, dilations=dils)
        return jnp.sum(out * jnp.asarray(cot))

    gp, gx = jax.grad(loss, argnums=(0, 1))(jax.tree_util.tree_map(jnp.asarray, p),
                                            jnp.asarray(x))
    ref = {"x": n(gx)}
    ref.update(zip(("w1", "b1", "w2", "b2"), (n(a) for a in packed_resblock(tree_np(gp)))))

    xt = t(x).transpose(1, 2).contiguous().requires_grad_(True)
    ws = [a.requires_grad_(True) for a in packed_resblock(p)]
    out = trb.fused_resblock(xt, *ws, kernel_size=k, dilations=dils)
    assert out.grad_fn is not None
    out.backward(t(cot).transpose(1, 2))
    got = {"x": n(xt.grad.transpose(1, 2))}
    got.update(zip(("w1", "b1", "w2", "b2"), (n(w.grad) for w in ws)))
    for name, r in ref.items():
        err = np.abs(got[name] - r).max()
        assert err <= 1e-4 * max(1.0, np.abs(r).max()), (name, err)


def test_autograd_matches_plain_chain_grads():
    """The recomputing backward equals autograd through the plain chain."""
    k, dils, C, T = 3, (1, 2), 32, 64
    p = resblock_params(9, k, C, len(dils))
    x = t(resblock_x(T, C)).transpose(1, 2).contiguous()
    grads = []
    for fn in (trb.fused_resblock, trb._resblock):
        xi = x.clone().requires_grad_(True)
        ws = [a.requires_grad_(True) for a in packed_resblock(p)]
        fn(xi, *ws, kernel_size=k, dilations=dils).square().sum().backward()
        grads.append([n(v.grad) for v in (xi, *ws)])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
