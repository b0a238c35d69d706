"""The port's exporter (`interop/onnx_export.py`): small functions with the
ops of the port's three exported models (the synthesizer's, HuBERT's and
RMVPE's), exported with dynamic axes and run by the port's executor and
by the JAX package's, against the eager port function at two lengths
(atol 1e-5); an op with no translation raises, naming it."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rvc_maker_tpu.interop import onnx_proto as jop
from rvc_maker_tpu.interop.onnx_run import OnnxGraph as JaxGraph
from rvc_maker_tpu_torch.interop import onnx_proto as top
from rvc_maker_tpu_torch.interop.onnx_export import export_onnx
from rvc_maker_tpu_torch.interop.onnx_run import OnnxGraph
from rvc_maker_tpu_torch.models.synthesizer import _absolute_to_relative, _relative_to_absolute
from torch_port_util import torch_threads  # noqa: F401

TOL = 1e-5
RS = np.random.RandomState(0)


def _w(*shape, scale=0.3):
    return torch.as_tensor(RS.randn(*shape).astype(np.float32) * scale)


def hubert_like(p, x):
    """The grouped positional conv (trimmed), exact GELU, GroupNorm and
    LayerNorm, a masked softmax over time and an integer frame count."""
    h = F.conv1d(x, p["conv"], p["b"], padding=4, groups=4)[:, :, :-1]
    h = F.gelu(F.group_norm(h, 4, p["gn_w"], p["gn_b"]))
    h = F.layer_norm(h.transpose(1, 2), (8,), p["ln_w"], p["ln_b"])
    t = h.shape[1]
    mask = torch.arange(t)[None, :] < torch.div(torch.tensor([t]), 2, rounding_mode="floor") + 1
    s = torch.softmax(torch.where(mask[:, :, None], h, -1e4), dim=1)
    return F.pad(s, (0, 0, 0, t % 2))


def rmvpe_like(p, mel):
    """conv2d + BN-style affine, avg_pool2d, conv_transpose2d, a skip
    concat and a BiGRU over time, then a sigmoid head."""
    x = torch.relu(F.conv2d(mel.transpose(1, 2)[:, None], p["c1"], padding=1)
                   * p["s"][None, :, None, None])
    y = F.avg_pool2d(x, 2)
    y = F.conv_transpose2d(y, p["ct"], stride=2, padding=1, output_padding=1)
    x = torch.cat([x, y], dim=1)
    b, c, t, f = x.shape
    x = x.transpose(1, 2).reshape(b, t, c * f)
    return torch.sigmoid(F.linear(p["gru"](x)[0], p["fc"]))


def synth_like(p, phone, f0):
    """The synthesizer's rel-attention reshapes, an embedding, the sine
    source's cumsum / remainder / sin, flip, a repeat and a chunk."""
    t = phone.shape[1]
    e = F.embedding(torch.clamp(f0.to(torch.int64), 0, 9), p["emb"])
    x = phone + e
    scores = torch.einsum("btc,bsc->bts", x, x)[:, None]
    rel = _absolute_to_relative(torch.softmax(scores, -1))          # (B, 1, T, 2T-1)
    back = _relative_to_absolute(rel)
    rad = torch.remainder(torch.cumsum(f0 / 16000.0, dim=1), 1.0)
    src = torch.sin(2 * np.pi * rad)[:, :, None]
    a, b = torch.chunk(torch.flip(x, dims=[-1]), 2, dim=-1)
    up = torch.repeat_interleave(src, 2, dim=1)[:, :t]
    return back[:, 0].sum(-1, keepdim=True) + a.mean(-1, keepdim=True) * b[..., :1] + up


def _gru():
    torch.manual_seed(0)
    return torch.nn.GRU(8 * 16, 6, batch_first=True, bidirectional=True).eval()


CASES = {
    "hubert_like": (hubert_like,
                    {"conv": _w(8, 2, 9), "b": _w(8), "gn_w": _w(8) + 1, "gn_b": _w(8),
                     "ln_w": _w(8) + 1, "ln_b": _w(8)},
                    lambda n: (_w(1, 8, n, scale=1.0),), ["x"], {"x": {2: "t"}}, ["t >= 8"],
                    (24, 37)),
    "rmvpe_like": (rmvpe_like,
                   {"c1": _w(4, 1, 3, 3), "s": _w(4) + 1, "ct": _w(4, 4, 3, 3), "gru": _gru(),
                    "fc": _w(10, 12)},
                   lambda n: (_w(2, 16, n, scale=1.0),), ["mel"], {"mel": {0: "b", 2: "2*t"}},
                   ["t >= 4"], (32, 46)),
    "synth_like": (synth_like, {"emb": _w(10, 6)},
                   lambda n: (_w(1, n, 6, scale=1.0),
                              torch.as_tensor(RS.uniform(50, 900, (1, n)).astype(np.float32))),
                   ["phone", "f0"], {"phone": {1: "t"}, "f0": {1: "t"}}, ["t >= 21"], (21, 33)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_runs_in_both_executors_at_two_lengths(case):
    fn, params, make, names, dyn, constraints, lengths = CASES[case]
    model = export_onnx(fn, make(lengths[0] + 2), params=params, input_names=names,
                        output_names=["y"], dynamic_axes=dyn, dim_constraints=constraints)
    data = top.encode(model)
    ours, jax_graph = OnnxGraph(data, device="cpu"), JaxGraph(jop.decode(jop.ModelProto, data))
    if case == "rmvpe_like":
        assert [n.op_type for n in model.graph.node].count("GRU") == 1
    for n in lengths:
        args = make(n)
        with torch.no_grad():
            ref = fn(params, *args).numpy()
        feeds = dict(zip(names, args))
        got = ours.run(feeds)[0].numpy()
        got_jax = np.asarray(jax_graph.run({k: v.numpy() for k, v in feeds.items()})[0])
        assert got.shape == got_jax.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got_jax, ref, rtol=TOL, atol=TOL)


def test_untranslated_op_raises_naming_it():
    with pytest.raises(NotImplementedError, match="atan2"):
        export_onnx(lambda x, y: torch.atan2(x, y), (torch.ones(3), torch.ones(3)),
                    input_names=["x", "y"], output_names=["z"])
