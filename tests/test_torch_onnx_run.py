"""The port's ONNX codec and executor against the JAX package's.

Codec: a file either package writes decodes and re-encodes byte for byte
in the other.  Executor: each case is one small graph, built with the
codec from numpy inputs made from a seed, run by JAX's `OnnxGraph.run`
and by the port's on the CPU; outputs within 1e-5, the seeded random
ops' samples equal.  Together the cases reach every op the JAX executor
registers, and Loop and If."""

import numpy as np
import pytest
import torch

from rvc_maker_tpu.interop import onnx_proto as jop
from rvc_maker_tpu.interop.onnx_run import OnnxGraph as JaxGraph
from rvc_maker_tpu.interop.onnx_run import _OPS as JAX_OPS
from rvc_maker_tpu_torch.interop import onnx_proto as top
from rvc_maker_tpu_torch.interop.onnx_run import _CONTROL, _OPS, OnnxGraph
from torch_port_util import torch_threads  # noqa: F401

TOL = 1e-5


def node(op_type, inputs, outputs, **attrs):
    n = jop.NodeProto(op_type=op_type, input=list(inputs), output=list(outputs))
    for k, v in attrs.items():
        a = jop.AttributeProto(name=k)
        if isinstance(v, jop.GraphProto):
            a.type, a.g = jop.ATTR_GRAPH, v
        elif isinstance(v, float):
            a.type, a.f = jop.ATTR_FLOAT, v
        elif isinstance(v, (bool, int)):
            a.type, a.i = jop.ATTR_INT, int(v)
        elif isinstance(v, str):
            a.type, a.s = jop.ATTR_STRING, v.encode()
        elif isinstance(v, np.ndarray):
            a.type, a.t = jop.ATTR_TENSOR, jop.tensor_from_array(v)
        elif isinstance(v, (list, tuple)) and v and isinstance(v[0], float):
            a.type, a.floats = jop.ATTR_FLOATS, list(v)
        else:
            a.type, a.ints = jop.ATTR_INTS, [int(i) for i in v]
        n.attribute.append(a)
    return n


def subgraph(nodes, inputs, outputs, inits=None):
    return jop.GraphProto(
        name="body", node=nodes, input=[jop.ValueInfoProto(name=i) for i in inputs],
        output=[jop.ValueInfoProto(name=o) for o in outputs],
        initializer=[jop.tensor_from_array(v, k) for k, v in (inits or {}).items()])


def model_bytes(nodes, inputs, outputs, inits=None) -> bytes:
    g = subgraph(nodes, inputs, outputs, inits)
    g.name = "t"
    return jop.encode(jop.ModelProto(ir_version=8, graph=g,
                                     opset_import=[jop.OperatorSetIdProto(version=17)]))


RS = np.random.RandomState(0)


def f32(*shape, lo=None):
    a = RS.randn(*shape).astype(np.float32)
    return np.abs(a) + lo if lo is not None else a


def i64(*v):
    return np.asarray(v, np.int64)


def _unary(op_type, x=None, **attrs):
    return ([node(op_type, ["x"], ["y"], **attrs)], {"x": f32(3, 5) if x is None else x},
            ["y"], {})


def _binary(op_type, a=None, b=None, **attrs):
    return ([node(op_type, ["a", "b"], ["y"], **attrs)],
            {"a": f32(2, 3, 4) if a is None else a, "b": f32(3, 4) if b is None else b},
            ["y"], {})


def _gru_weights(dirs, H, I):
    return {"W": f32(dirs, 3 * H, I) * 0.5, "R": f32(dirs, 3 * H, H) * 0.5,
            "B": f32(dirs, 6 * H) * 0.1}


def _lstm_weights(dirs, H, I):
    return {"W": f32(dirs, 4 * H, I) * 0.5, "R": f32(dirs, 4 * H, H) * 0.5,
            "B": f32(dirs, 8 * H) * 0.1}


def _loop_scan():
    body = subgraph([node("Add", ["v_in", "step"], ["v_out"]),
                     node("Identity", ["cond_in"], ["cond_out"]),
                     node("Unsqueeze", ["v_out", "axes0"], ["scan_el"])],
                    ["iter", "cond_in", "v_in"], ["cond_out", "v_out", "scan_el"],
                    {"axes0": i64(0)})
    return ([node("Loop", ["M", "cond", "v0"], ["vf", "scans"], body=body)],
            {"M": np.asarray(4, np.int64), "v0": np.zeros(2, np.float32)}, ["vf", "scans"],
            {"step": np.asarray([1.0, 2.0], np.float32), "cond": np.asarray(True)})


def _loop_early_stop():
    body = subgraph([node("Add", ["v_in", "one"], ["v_out"]),
                     node("Less", ["v_out", "limit"], ["cond_out"])],
                    ["iter", "cond_in", "v_in"], ["cond_out", "v_out"],
                    {"one": np.asarray(1.0, np.float32), "limit": np.asarray(3.5, np.float32)})
    return ([node("Loop", ["M", "cond", "v0"], ["vf"], body=body)],
            {"M": np.asarray(100, np.int64), "v0": np.asarray(0.0, np.float32)}, ["vf"],
            {"cond": np.asarray(True)})


def _loop_shape_trip():
    body = subgraph([node("Add", ["acc", "row_sum"], ["acc_out"]),
                     node("Identity", ["cond_in"], ["cond_out"])],
                    ["iter", "cond_in", "acc"], ["cond_out", "acc_out"])
    return ([node("Shape", ["x"], ["xs"]), node("Gather", ["xs", "zero"], ["M"], axis=0),
             node("ReduceSum", ["x"], ["row_sum"], keepdims=0),
             node("Loop", ["M", "cond", "v0"], ["vf"], body=body)],
            {"x": f32(3, 4), "v0": np.asarray(0.0, np.float32)}, ["vf"],
            {"zero": np.asarray(0, np.int64), "cond": np.asarray(True)})


def _if(c):
    then_g = subgraph([node("Mul", ["x", "two"], ["o"])], [], ["o"],
                      {"two": np.asarray(2.0, np.float32)})
    else_g = subgraph([node("Neg", ["x"], ["o"])], [], ["o"])
    return ([node("If", ["c"], ["y"], then_branch=then_g, else_branch=else_g)],
            {"c": np.asarray(c), "x": f32(4)}, ["y"], {})


CASES = {
    **{f"unary_{o}": (lambda o=o: _unary(o)) for o in
       ("Exp", "Neg", "Abs", "Sin", "Cos", "Tanh", "Floor", "Ceil", "Sign", "Round", "Erf",
        "Relu", "Sigmoid", "Softplus", "Identity")},
    **{f"unary_{o}": (lambda o=o: _unary(o, f32(3, 5, lo=0.1))) for o in
       ("Log", "Sqrt", "Reciprocal")},
    "unary_Not": lambda: _unary("Not", f32(3, 5) > 0),
    "gelu_erf": lambda: _unary("Gelu"),
    "gelu_tanh": lambda: _unary("Gelu", approximate="tanh"),
    "elu": lambda: _unary("Elu", alpha=0.7),
    "hard_sigmoid": lambda: _unary("HardSigmoid", alpha=0.3, beta=0.4),
    "leaky_relu": lambda: _unary("LeakyRelu", alpha=0.2),
    "softmax": lambda: _unary("Softmax", axis=0),
    "log_softmax": lambda: _unary("LogSoftmax", axis=-1),
    "dropout": lambda: ([node("Dropout", ["x"], ["y", "m"])], {"x": f32(3, 4)}, ["y", "m"], {}),
    "cast_int64": lambda: _unary("Cast", f32(3, 5) * 4, to=jop.INT64),
    "cast_float": lambda: _unary("Cast", np.arange(6, dtype=np.int64), to=jop.FLOAT),
    **{f"binary_{o}": (lambda o=o: _binary(o)) for o in
       ("Add", "Sub", "Mul", "Div", "Equal", "Greater", "GreaterOrEqual", "Less",
        "LessOrEqual", "PRelu", "Min", "Max", "Sum")},
    "binary_Pow": lambda: _binary("Pow", f32(2, 3, 4, lo=0.5), f32(3, 4)),
    "div_int_floor": lambda: _binary("Div", i64(7, -7, 9), i64(2, 2, -4)),
    "mod": lambda: _binary("Mod", f32(2, 3, 4) * 3, f32(3, 4, lo=0.5)),
    "mod_fmod": lambda: _binary("Mod", f32(2, 3, 4) * 3, f32(3, 4, lo=0.5), fmod=1),
    "and_or": lambda: ([node("And", ["a", "b"], ["y"]), node("Or", ["a", "b"], ["z"])],
                       {"a": f32(4, 4) > 0, "b": f32(4, 4) > 0}, ["y", "z"], {}),
    "sum3_min3": lambda: ([node("Sum", ["a", "b", "c"], ["y"]),
                           node("Min", ["a", "b", "c"], ["z"])],
                          {"a": f32(3, 4), "b": f32(4), "c": f32(3, 1)}, ["y", "z"], {}),
    "clip_inputs": lambda: ([node("Clip", ["x", "lo", "hi"], ["y"])], {"x": f32(4, 5)}, ["y"],
                            {"lo": np.asarray(-0.3, np.float32),
                             "hi": np.asarray(0.5, np.float32)}),
    "constant": lambda: ([node("Constant", [], ["c"], value=f32(2, 3)),
                          node("Add", ["x", "c"], ["y"])], {"x": f32(2, 3)}, ["y"], {}),
    "constant_of_shape": lambda: ([node("Shape", ["x"], ["s"]),
                                  node("ConstantOfShape", ["s"], ["c"],
                                       value=np.asarray([2.5], np.float32)),
                                  node("Mul", ["x", "c"], ["y"])], {"x": f32(2, 3)}, ["y"], {}),
    "shape_slice_size": lambda: ([node("Shape", ["x"], ["s"], start=1, end=3),
                                  node("Size", ["x"], ["n"])],
                                 {"x": f32(2, 3, 4, 5)}, ["s", "n"], {}),
    "shape_reshape_idiom": lambda: ([node("Shape", ["x"], ["shp"]),
                                     node("Gather", ["shp", "i0"], ["d0"], axis=0),
                                     node("Unsqueeze", ["d0", "ax0"], ["d0u"]),
                                     node("Concat", ["d0u", "m1"], ["tgt"], axis=0),
                                     node("Reshape", ["x", "tgt"], ["y"])],
                                    {"x": f32(3, 4, 5)}, ["y"],
                                    {"i0": np.asarray(0, np.int64), "ax0": i64(0),
                                     "m1": i64(-1)}),
    "reshape_zero": lambda: ([node("Reshape", ["x", "s"], ["y"])], {"x": f32(2, 3, 4)}, ["y"],
                             {"s": i64(0, -1)}),
    "transpose": lambda: _unary("Transpose", f32(2, 3, 4), perm=[2, 0, 1]),
    "transpose_default": lambda: _unary("Transpose", f32(2, 3, 4)),
    "squeeze_unsqueeze": lambda: ([node("Squeeze", ["x", "a1"], ["s"]),
                                   node("Unsqueeze", ["s", "a2"], ["y"])],
                                  {"x": f32(3, 1, 4)}, ["y"], {"a1": i64(1), "a2": i64(0, -1)}),
    "flatten": lambda: _unary("Flatten", f32(2, 3, 4, 5), axis=2),
    "concat": lambda: ([node("Concat", ["a", "b"], ["y"], axis=1)],
                       {"a": f32(2, 3), "b": f32(2, 5)}, ["y"], {}),
    "split_equal": lambda: ([node("Split", ["x"], ["a", "b"], axis=1)], {"x": f32(2, 6)},
                            ["a", "b"], {}),
    "split_sizes": lambda: ([node("Split", ["x", "sz"], ["a", "b"], axis=1)],
                            {"x": f32(4, 10)}, ["a", "b"], {"sz": i64(3, 7)}),
    "slice_neg_step": lambda: ([node("Slice", ["x", "st", "en", "ax", "sp"], ["y"])],
                               {"x": f32(4, 10, 6)}, ["y"],
                               {"st": i64(-1), "en": i64(-(2**63)), "ax": i64(1),
                                "sp": i64(-2)}),
    "slice_open_end": lambda: ([node("Slice", ["x", "st", "en", "ax"], ["y"])],
                               {"x": f32(4, 10)}, ["y"],
                               {"st": i64(2, 1), "en": i64(2**63 - 1, -1), "ax": i64(1, 0)}),
    "gather_neg": lambda: ([node("Gather", ["x", "i"], ["y"], axis=1)], {"x": f32(3, 5, 2)},
                           ["y"], {"i": np.asarray([[0, -1], [2, 4]], np.int64)}),
    "gather_elements": lambda: ([node("GatherElements", ["x", "i"], ["y"], axis=1)],
                                {"x": f32(3, 5)}, ["y"],
                                {"i": np.asarray([[0, 4], [1, 1], [3, 2]], np.int64)}),
    "expand_where": lambda: ([node("Expand", ["c", "shape"], ["ce"]),
                              node("Where", ["ce", "x", "negx"], ["y"])],
                             {"c": f32(4, 10, 1) > 0, "x": f32(4, 10, 6),
                              "negx": f32(4, 10, 6)}, ["y"], {"shape": i64(4, 10, 6)}),
    "tile": lambda: ([node("Tile", ["x", "r"], ["y"])], {"x": f32(2, 3)}, ["y"],
                     {"r": i64(2, 3)}),
    "range": lambda: ([node("Range", ["s", "l", "d"], ["y"])], {}, ["y"],
                      {"s": np.asarray(1, np.int64), "l": np.asarray(11, np.int64),
                       "d": np.asarray(3, np.int64)}),
    "cumsum": lambda: ([node("CumSum", ["x", "ax"], ["y"])], {"x": f32(3, 5, 7)}, ["y"],
                       {"ax": np.asarray(2, np.int64)}),
    "einsum": lambda: ([node("Einsum", ["a", "b"], ["y"], equation="bij,bjk->bik")],
                       {"a": f32(2, 3, 4), "b": f32(2, 4, 5)}, ["y"], {}),
    "random_normal": lambda: ([node("RandomNormal", [], ["y"], shape=[16, 8], mean=1.5,
                                    scale=0.5, dtype=1)], {}, ["y"], {}),
    "random_normal_seeded": lambda: ([node("RandomNormal", [], ["y"], shape=[5], seed=3.0)],
                                     {}, ["y"], {}),
    "random_normal_like": lambda: ([node("RandomNormalLike", ["x"], ["y"])],
                                   {"x": f32(6, 7)}, ["y"], {}),
    "random_uniform": lambda: ([node("RandomUniform", [], ["y"], shape=[4, 9], low=-1.0,
                                     high=2.0)], {}, ["y"], {}),
    "random_uniform_like": lambda: ([node("RandomUniformLike", ["x"], ["y"], low=2.0,
                                          high=3.0)], {"x": f32(5, 4)}, ["y"], {}),
    "gru_forward_lbr": lambda: ([node("GRU", ["x", "W", "R", "B"], ["Y", "Yh"], hidden_size=5,
                                      linear_before_reset=1)],
                                {"x": f32(9, 3, 6)}, ["Y", "Yh"], _gru_weights(1, 5, 6)),
    "gru_bidirectional_lbr": lambda: ([node("GRU", ["x", "W", "R", "B"], ["Y", "Yh"],
                                            hidden_size=5, linear_before_reset=1,
                                            direction="bidirectional")],
                                      {"x": f32(9, 3, 6)}, ["Y", "Yh"],
                                      _gru_weights(2, 5, 6)),
    "gru_reverse_plain": lambda: ([node("GRU", ["x", "W", "R", "B", "", "h0"], ["Y"],
                                        hidden_size=4, direction="reverse")],
                                  {"x": f32(7, 2, 3), "h0": f32(1, 2, 4)}, ["Y"],
                                  _gru_weights(1, 4, 3)),
    **{f"lstm_{d}": (lambda d=d: ([node("LSTM", ["x", "W", "R", "B"], ["Y", "Yh", "Yc"],
                                        hidden_size=7, direction=d)],
                                  {"x": f32(8, 2, 4)}, ["Y", "Yh", "Yc"],
                                  _lstm_weights(2 if d == "bidirectional" else 1, 7, 4)))
       for d in ("forward", "reverse", "bidirectional")},
    **{f"reduce_{o}": (lambda o=o: _unary(o, f32(3, 5, 7, lo=0.5), axes=[-1, 1], keepdims=1))
       for o in ("ReduceMean", "ReduceMax", "ReduceMin", "ReduceProd", "ReduceL2")},
    "reduce_sum_input_axes": lambda: ([node("ReduceSum", ["x", "ax"], ["y"], keepdims=0)],
                                      {"x": f32(3, 5, 7)}, ["y"], {"ax": i64(0, 2)}),
    "reduce_mean_all": lambda: _unary("ReduceMean", f32(3, 5), keepdims=0),
    "argmax": lambda: _unary("ArgMax", f32(3, 5, 7), axis=1, keepdims=0),
    "matmul": lambda: ([node("MatMul", ["a", "b"], ["y"])],
                       {"a": f32(2, 3, 4, 5), "b": f32(5, 6)}, ["y"], {}),
    "gemm": lambda: ([node("Gemm", ["x", "w", "b"], ["y"], alpha=0.5, beta=2.0, transB=1)],
                     {"x": f32(4, 7)}, ["y"], {"w": f32(5, 7), "b": f32(5)}),
    "gemm_trans_a": lambda: ([node("Gemm", ["x", "w"], ["y"], transA=1)],
                             {"x": f32(7, 4)}, ["y"], {"w": f32(7, 3)}),
    **{f"conv1d_{s}_{p}_{d}_{g}": (lambda s=s, p=p, d=d, g=g: (
        [node("Conv", ["x", "w", "b"], ["y"], strides=[s], pads=[p, p], dilations=[d],
              group=g, kernel_shape=[5])],
        {"x": f32(2, 8, 37)}, ["y"], {"w": f32(12, 8 // g, 5) * 0.3, "b": f32(12)}))
       for s, p, d, g in ((1, 0, 1, 1), (2, 3, 1, 1), (1, 2, 2, 1), (1, 1, 1, 4))},
    "conv2d_same_upper": lambda: ([node("Conv", ["x", "w"], ["y"], auto_pad="SAME_UPPER",
                                        strides=[2, 1], kernel_shape=[3, 3])],
                                  {"x": f32(1, 3, 12, 14)}, ["y"], {"w": f32(6, 3, 3, 3) * 0.3}),
    "conv1d_asym_pads": lambda: ([node("Conv", ["x", "w"], ["y"], pads=[2, 0],
                                       kernel_shape=[3])],
                                 {"x": f32(1, 3, 10)}, ["y"], {"w": f32(4, 3, 3)}),
    **{f"conv_transpose1d_{s}_{p}_{op_}_{g}": (lambda s=s, p=p, op_=op_, g=g: (
        [node("ConvTranspose", ["x", "w", "b"], ["y"], strides=[s], pads=[p, p],
              output_padding=[op_], group=g, kernel_shape=[7])],
        {"x": f32(2, 6, 25)}, ["y"],
        {"w": f32(6, (9 if g == 1 else 6) // g, 7) * 0.3, "b": f32(9 if g == 1 else 6)}))
       for s, p, op_, g in ((2, 0, 0, 1), (4, 3, 1, 1), (2, 1, 0, 3))},
    "conv_transpose1d_asym": lambda: ([node("ConvTranspose", ["x", "w"], ["y"], strides=[3],
                                            pads=[1, 4], output_padding=[2],
                                            kernel_shape=[4])],
                                      {"x": f32(1, 2, 6)}, ["y"], {"w": f32(2, 3, 4)}),
    "conv_transpose2d": lambda: ([node("ConvTranspose", ["x", "w", "b"], ["y"],
                                       strides=[2, 3], pads=[1, 2, 1, 2],
                                       output_padding=[1, 0], kernel_shape=[3, 5])],
                                 {"x": f32(1, 4, 9, 11)}, ["y"],
                                 {"w": f32(4, 5, 3, 5) * 0.3, "b": f32(5)}),
    "maxpool": lambda: _unary("MaxPool", f32(2, 3, 17, 19), kernel_shape=[3, 3],
                              strides=[2, 2], pads=[1, 1, 1, 1]),
    "avgpool": lambda: _unary("AveragePool", f32(2, 3, 17, 19), kernel_shape=[2, 2],
                              strides=[2, 2]),
    "avgpool_pads_exclude": lambda: _unary("AveragePool", f32(1, 2, 9), kernel_shape=[3],
                                           strides=[2], pads=[1, 2]),
    "global_avgpool": lambda: _unary("GlobalAveragePool", f32(2, 3, 5, 6)),
    "batchnorm": lambda: ([node("BatchNormalization", ["x", "s", "b", "m", "v"], ["y"],
                                epsilon=1e-5)], {"x": f32(3, 8, 10)}, ["y"],
                          {"s": f32(8), "b": f32(8), "m": f32(8), "v": f32(8, lo=0.5)}),
    "instancenorm": lambda: ([node("InstanceNormalization", ["x", "s", "b"], ["y"])],
                             {"x": f32(3, 8, 10)}, ["y"], {"s": f32(8), "b": f32(8)}),
    "layernorm": lambda: ([node("LayerNormalization", ["x", "s", "b"], ["y"], axis=-1)],
                          {"x": f32(3, 8, 10)}, ["y"], {"s": f32(10), "b": f32(10)}),
    "groupnorm": lambda: ([node("GroupNormalization", ["x", "s", "b"], ["y"], num_groups=4)],
                          {"x": f32(3, 8, 10)}, ["y"], {"s": f32(8), "b": f32(8)}),
    "pad_constant": lambda: ([node("Pad", ["x", "p", "v"], ["y"])], {"x": f32(2, 3, 4)},
                             ["y"], {"p": i64(0, 1, 2, 0, 2, 1),
                                     "v": np.asarray(0.5, np.float32)}),
    "pad_reflect": lambda: ([node("Pad", ["x", "p"], ["y"], mode="reflect")],
                            {"x": f32(4, 10, 6)}, ["y"], {"p": i64(0, 0, 2, 0, 0, 3)}),
    "pad_edge_first_axis": lambda: ([node("Pad", ["x", "p"], ["y"], mode="edge")],
                                    {"x": f32(4, 5)}, ["y"], {"p": i64(2, 0, 1, 1)}),
    "pad_negative": lambda: ([node("Pad", ["x", "p"], ["y"])], {"x": f32(4, 10)}, ["y"],
                             {"p": i64(0, -2, 0, 3)}),
    "resize_nearest": lambda: ([node("Resize", ["x", "", "sc"], ["y"], mode="nearest",
                                     coordinate_transformation_mode="asymmetric",
                                     nearest_mode="floor")],
                               {"x": f32(1, 4, 10)}, ["y"],
                               {"sc": np.asarray([1, 1, 2], np.float32)}),
    "resize_linear": lambda: ([node("Resize", ["x", "", "sc"], ["y"], mode="linear")],
                              {"x": f32(1, 2, 8, 8)}, ["y"],
                              {"sc": np.asarray([1, 1, 2, 2], np.float32)}),
    "loop_scan": _loop_scan,
    "loop_early_stop": _loop_early_stop,
    "loop_shape_trip_count": _loop_shape_trip,
    "if_then": lambda: _if(True),
    "if_else": lambda: _if(False),
}

RANDOM = {"random_normal", "random_normal_seeded", "random_normal_like", "random_uniform",
          "random_uniform_like"}


def test_cases_reach_every_op():
    """The parametrised cases together run every op the JAX executor
    registers, Loop and If; the port registers the same set."""
    seen = set()
    for make in CASES.values():
        nodes = make()[0]
        stack = list(nodes)
        while stack:
            n = stack.pop()
            seen.add(n.op_type)
            for a in n.attribute:
                if a.g is not None:
                    stack.extend(a.g.node)
    assert set(_OPS) == set(JAX_OPS)
    assert set(JAX_OPS) | set(_CONTROL) <= seen, set(JAX_OPS) - seen


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax_executor(case):
    nodes, feeds, outputs, inits = CASES[case]()
    data = model_bytes(nodes, list(feeds), outputs, inits)
    ref = JaxGraph(data).run(dict(feeds))
    got = OnnxGraph(data, device="cpu").run({k: torch.as_tensor(v) for k, v in feeds.items()})
    assert len(got) == len(ref) == len(outputs)
    for g, r in zip(got, ref):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape, case
        if case in RANDOM or g.dtype == bool or r.dtype.kind in "iub":
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=TOL, atol=TOL)


def test_unknown_op_raises_at_load_naming_it():
    with pytest.raises(NotImplementedError, match="TotallyMadeUpOp"):
        OnnxGraph(model_bytes([node("TotallyMadeUpOp", ["x"], ["y"])], ["x"], ["y"]),
                  device="cpu")
    body = subgraph([node("NotARealOp", ["v_in"], ["v_out"]),
                     node("Identity", ["cond_in"], ["cond_out"])],
                    ["iter", "cond_in", "v_in"], ["cond_out", "v_out"])
    with pytest.raises(NotImplementedError, match="NotARealOp"):
        OnnxGraph(model_bytes([node("Loop", ["M", "c", "v0"], ["vf"], body=body)],
                              ["M", "c", "v0"], ["vf"]), device="cpu")


def test_card_requested_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        OnnxGraph(model_bytes([node("Relu", ["x"], ["y"])], ["x"], ["y"]))


def _exported_by_jax() -> bytes:
    import jax.numpy as jnp

    from rvc_maker_tpu.interop.onnx_export import export_onnx as jax_export

    w = np.arange(12, dtype=np.float32).reshape(4, 3) * 0.1
    model = jax_export(lambda p, x: jnp.tanh(x @ p["w"]).sum(-1), (np.zeros((2, 4), np.float32),),
                       params={"w": w}, input_names=["x"], output_names=["y"],
                       dynamic_axes={"x": {0: "n"}},
                       metadata={"model_info": '{"sr": 40000}'})
    return jop.encode(model)


def _exported_by_port() -> bytes:
    from rvc_maker_tpu_torch.interop.onnx_export import export_onnx

    w = torch.arange(12, dtype=torch.float32).reshape(4, 3) * 0.1
    model = export_onnx(lambda p, x: torch.tanh(x @ p["w"]).sum(-1), (torch.zeros(2, 4),),
                        params={"w": w}, input_names=["x"], output_names=["y"],
                        dynamic_axes={"x": {0: "n"}},
                        metadata={"model_info": '{"sr": 40000}'})
    return top.encode(model)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_codec_round_trip_is_byte_equal_both_ways(writer):
    """A file one package writes decodes and re-encodes byte for byte in
    the other package's codec, and in its own."""
    data = _exported_by_jax() if writer == "jax" else _exported_by_port()
    assert top.encode(top.decode(top.ModelProto, data)) == data
    assert jop.encode(jop.decode(jop.ModelProto, data)) == data
    port_model = top.load_model(data)
    assert [n.op_type for n in port_model.graph.node] == [
        n.op_type for n in jop.load_model(data).graph.node]
    x = RS.randn(5, 4).astype(np.float32)
    ref = np.tanh(x @ (np.arange(12, dtype=np.float32).reshape(4, 3) * 0.1)).sum(-1)
    np.testing.assert_allclose(OnnxGraph(data, device="cpu").run({"x": x})[0].numpy(), ref,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(JaxGraph(data).run({"x": x})[0]), ref,
                               rtol=1e-5, atol=1e-5)
