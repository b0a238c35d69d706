"""ONNX F0 predictors in the port (the reference's --f0_onnx): the port's
RMVPE exported with a dynamic frame axis (its BiGRU one ONNX GRU node)
through `rmvpe_onnx_infer` against JAX RMVPE's f0 within 1e-2 Hz at two
lengths, and the pipeline's F0 stage routed to the graph; CREPE and FCPE
stub graphs with the reference's I/O, as JAX `test_f0_onnx.py` has them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.models import rmvpe as jrmvpe
from rvc_maker_tpu_torch.f0.onnx_predictor import (crepe_onnx_infer, fcpe_onnx_infer,
                                                   rmvpe_onnx_infer)
from rvc_maker_tpu_torch.interop.from_jax import random_rmvpe_tree, rmvpe_from_jax
from rvc_maker_tpu_torch.interop.onnx_export import export_onnx
from rvc_maker_tpu_torch.interop.onnx_run import OnnxGraph
from rvc_maker_tpu_torch.models import rmvpe as trmvpe
from torch_port_util import n, torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def rmvpe():
    tree = random_rmvpe_tree(7, widths=(4, 8, 16, 32, 64), inter_width=128)
    tp = rmvpe_from_jax(tree)
    model = export_onnx(trmvpe.e2e_apply, (torch.zeros(2, 128, 64),), params=tp,
                        input_names=["mel"], output_names=["hidden"],
                        dynamic_axes={"mel": {0: "b", 2: "32*t"}})
    return jax.tree_util.tree_map(jnp.asarray, tree), tp, model


def _audio(L, seed):
    tt = np.arange(L) / 16000
    rs = np.random.RandomState(seed)
    return (0.3 * np.sin(2 * np.pi * 220 * tt) + 0.05 * rs.randn(L)).astype(np.float32)[None]


@pytest.mark.parametrize("L", [16000, 7000])
def test_rmvpe_onnx_matches_jax(rmvpe, L):
    jp, _, model = rmvpe
    assert sum(nd.op_type == "GRU" for nd in model.graph.node) == 1
    graph = OnnxGraph(model, device="cpu")
    audio = _audio(L, L)
    ref = np.asarray(jax.jit(lambda a: jrmvpe.infer(jp, a))(jnp.asarray(audio)))
    got = n(rmvpe_onnx_infer(graph, torch.as_tensor(audio)))
    assert got.shape == ref.shape == (1, L // 160 + 1)
    assert np.abs(got - ref).max() <= 1e-2


def test_pipeline_f0_stage_routes_to_the_graph(rmvpe):
    from rvc_maker_tpu_torch.pipelines.convert import device_f0

    _, tp, model = rmvpe
    graph = OnnxGraph(model, device="cpu")
    audio = torch.as_tensor(_audio(16000, 3))
    for method, kw in (("rmvpe", {}), ("rmvpe-legacy", {"f0_min": 50.0, "f0_max": 1100.0})):
        got = device_f0(method, audio, lambda name, m: graph)
        ref = trmvpe.infer(tp, audio, **kw)
        assert np.abs(n(got) - n(ref)).max() <= 1e-2


def test_crepe_onnx_dispatch():
    """Stub graph: frames (N, 1024) -> probs (N, 360) peaked at a fixed
    bin; the decode recovers that bin's frequency, in both modes and
    through the pipeline's CREPE member."""
    from rvc_maker_tpu_torch.models.crepe import bins_to_frequency
    from rvc_maker_tpu_torch.pipelines.convert import host_f0_member

    target = 150
    w = torch.zeros(1024, 360)
    w[:, target] = 0.01
    bias = torch.zeros(360)
    bias[target] = 4.0
    model = export_onnx(lambda p, frames: torch.sigmoid(frames @ p["w"] + p["b"]),
                        (torch.zeros(26, 1024),), params={"w": w, "b": bias},
                        input_names=["frames"], output_names=["probs"],
                        dynamic_axes={"frames": {0: "n"}})
    graph = OnnxGraph(model, device="cpu")
    audio = (np.random.RandomState(1).randn(4000) * 0.1).astype(np.float32)
    want = bins_to_frequency(np.array([target]), dither=np.zeros(1))[0]
    for mangio in (False, True):
        f0 = crepe_onnx_infer(graph, audio, mangio=mangio)
        assert len(f0) == len(audio) // 160 + 1
        assert (f0 > 0).any() and np.allclose(f0[f0 > 0], want, atol=20.0)
    f0 = host_f0_member("crepe-full", audio, hop_length=160, params=lambda name, m: graph,
                        device=torch.device("cpu"))
    assert (f0 > 0).any() and np.allclose(f0[f0 > 0], want, atol=20.0)


def test_fcpe_onnx_dispatch():
    """Stub graph with the fcpe.onnx contract: (mel, threshold) -> f0."""
    from rvc_maker_tpu_torch.pipelines.convert import device_f0

    def net(mel, threshold):
        return (torch.full(mel.shape[:2], 220.0)
                * torch.clamp(threshold * 0 + 1.0, min=1.0))[..., None]

    model = export_onnx(net, (torch.zeros(1, 101, 128), torch.tensor(0.03)),
                        input_names=["mel", "threshold"], output_names=["f0"])
    graph = OnnxGraph(model, device="cpu")
    audio = torch.as_tensor((np.random.RandomState(2).randn(1, 16000) * 0.1).astype(np.float32))
    f0 = n(fcpe_onnx_infer(graph, audio, p_len=101))
    assert f0.shape == (1, 101) and np.allclose(f0, 220.0, atol=1.0)
    f0 = n(device_f0("fcpe", audio, lambda name, m: graph))
    assert f0.shape == (1, 101) and np.allclose(f0, 220.0, atol=1.0)
