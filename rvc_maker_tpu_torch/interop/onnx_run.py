"""PyTorch executor for ONNX graphs, on the card or the CPU.

The reference runs `.onnx` voice models, F0 predictors, embedders and
the MDX separators through onnxruntime (convert.py:545-552,
mdx_separator.py:251-273, library/utils.py:131-170).  Neither machine of
this package has onnxruntime, so a graph is interpreted node by node
into PyTorch calls on the graph's device.

Counterpart of `rvc_maker_tpu/interop/onnx_run.py`, with the same
semantics:

  * shape-carrying values (Shape results, the arithmetic on them, small
    integer constants) stay host numpy, so Reshape / Slice / Expand /
    Loop trip counts resolve from the actual feed, and a dynamic graph
    serves every length;
  * data lives on the graph's device as torch tensors: the feeds, the
    floating initializers (moved once, at load), every op that meets a
    tensor.  A numpy float64 turns into fp32 on the way, as JAX's
    default (x64 off) turns it;
  * the random ops draw from np.random.RandomState with JAX's seed rule
    (the `seed` attribute, else 0x5EED ^ crc32 of the node's first
    output), so a graph with traced noise gives the same samples in
    both executors;
  * an unknown op raises at load, naming it (subgraphs included).

Usage:
    g = OnnxGraph("model.onnx", device="cuda")
    outs = g.run({"input": x})      # a list of tensors on g.device

Conv, ConvTranspose, pooling, MatMul and Gemm are F.conv* / F.*pool* /
torch.matmul calls (cuDNN and cuBLAS on the card); GRU and LSTM are
tensor ops stepped over the sequence, both directions in one batched
step.  JAX's `jit()` has no counterpart: `run(feeds)` is the entry.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import onnx_proto as op

_NP_TO_TORCH = {
    np.dtype("float32"): torch.float32, np.dtype("float64"): torch.float64,
    np.dtype("float16"): torch.float16, np.dtype("int64"): torch.int64,
    np.dtype("int32"): torch.int32, np.dtype("int16"): torch.int16,
    np.dtype("int8"): torch.int8, np.dtype("uint8"): torch.uint8,
    np.dtype("bool"): torch.bool,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}
_TORCH_TO_NP[torch.bfloat16] = np.dtype("float32")
_ONNX_TO_NP_DT = {k: np.dtype(v) for k, v in op._ONNX_TO_NP.items()}
# integer / bool initializers up to this size stay host numpy (axes,
# shapes, indices of the shape arithmetic); larger ones are data
_HOST_CONST_MAX = 64


# ---------------------------------------------------------------------------
# attribute decoding (as the JAX executor decodes them)
# ---------------------------------------------------------------------------

def _attr_value(a: op.AttributeProto):
    t = a.type
    # proto3 omits default-valued scalars on the wire, so typed attributes
    # may decode with the payload field still None: fall back to the default
    if t == op.ATTR_FLOAT or (t is None and a.f is not None):
        return 0.0 if a.f is None else a.f
    if t == op.ATTR_INT or (t is None and a.i is not None):
        return 0 if a.i is None else a.i
    if t == op.ATTR_STRING or (t is None and a.s is not None):
        return (a.s or b"").decode("utf-8")
    if t == op.ATTR_TENSOR or (t is None and a.t is not None):
        return op.array_from_tensor(a.t)
    if t == op.ATTR_FLOATS or (t is None and a.floats):
        return list(a.floats)
    if t == op.ATTR_INTS or (t is None and a.ints):
        return list(a.ints)
    if t == op.ATTR_STRINGS or (t is None and a.strings):
        return [s.decode("utf-8") for s in a.strings]
    if t == op.ATTR_GRAPH:
        return a.g
    raise ValueError(f"unsupported attribute {a.name} type={t}")


def _node_attrs(node: op.NodeProto) -> dict:
    attrs = {a.name: _attr_value(a) for a in node.attribute}
    attrs["__n_outputs__"] = len(node.output)
    attrs["__node_id__"] = node.output[0] if node.output else node.name or ""
    return attrs


# ---------------------------------------------------------------------------
# host / device values
# ---------------------------------------------------------------------------

def _is_np(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic, int, float, bool))


def _all_np(*vals) -> bool:
    return all(v is None or _is_np(v) for v in vals)


def _host(x) -> np.ndarray:
    """A value as numpy (a tensor is copied to the host)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _np_dtype(x) -> np.dtype:
    return _TORCH_TO_NP[x.dtype] if isinstance(x, torch.Tensor) else np.asarray(x).dtype


class _Ctx:
    """The device a run's tensors live on, and each node's decoded
    attributes (decoded once, on the node's first run)."""

    def __init__(self, device: torch.device):
        self.device = device
        self._attrs: dict = {}

    def attrs(self, node: op.NodeProto) -> dict:
        a = self._attrs.get(id(node))
        if a is None:
            a = self._attrs[id(node)] = _node_attrs(node)
        return a

    def t(self, x) -> torch.Tensor:
        """A value as a tensor on the device; a float64 array as fp32."""
        if isinstance(x, torch.Tensor):
            return x if x.device == self.device else x.to(self.device)
        a = np.asarray(x)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        return torch.as_tensor(a, device=self.device)


# ---------------------------------------------------------------------------
# op registry: fn(vals, attrs, ctx) -> [outputs]
# ---------------------------------------------------------------------------

_OPS: dict = {}


def _op(name):
    def deco(fn):
        _OPS[name] = fn
        return fn
    return deco


def _unary(name, np_fn, torch_fn):
    @_op(name)
    def run(vals, attrs, ctx):
        (x,) = vals
        return [np_fn(x) if _is_np(x) else torch_fn(x)]


_unary("Exp", np.exp, torch.exp)
_unary("Log", np.log, torch.log)
_unary("Sqrt", np.sqrt, torch.sqrt)
_unary("Neg", np.negative, torch.neg)
_unary("Abs", np.abs, torch.abs)
_unary("Sin", np.sin, torch.sin)
_unary("Cos", np.cos, torch.cos)
_unary("Tanh", np.tanh, torch.tanh)
_unary("Floor", np.floor, torch.floor)
_unary("Ceil", np.ceil, torch.ceil)
_unary("Sign", np.sign, torch.sign)
_unary("Reciprocal", np.reciprocal, lambda x: 1.0 / x)
_unary("Not", np.logical_not, torch.logical_not)
_unary("Round", np.round, torch.round)
_OPS["Erf"] = lambda vals, attrs, ctx: [torch.erf(ctx.t(vals[0]))]


def _is_float(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    return np.asarray(x).dtype.kind == "f"


def _div(np_side, a, b):
    if _is_float(a) or _is_float(b):
        return np.divide(a, b) if np_side else torch.div(a, b)
    return np.floor_divide(a, b) if np_side else torch.div(a, b, rounding_mode="floor")


def _pow(np_side, a, b):
    if np_side:
        return np.power(a, np.asarray(b).astype(np.asarray(a).dtype))
    return torch.pow(a, b.to(a.dtype))


_BINARY = {
    "Add": (np.add, torch.add),
    "Sub": (np.subtract, torch.sub),
    "Mul": (np.multiply, torch.mul),
    "Equal": (np.equal, torch.eq),
    "Greater": (np.greater, torch.gt),
    "GreaterOrEqual": (np.greater_equal, torch.ge),
    "Less": (np.less, torch.lt),
    "LessOrEqual": (np.less_equal, torch.le),
    "And": (np.logical_and, torch.logical_and),
    "Or": (np.logical_or, torch.logical_or),
    "PRelu": (lambda a, b: np.where(a >= 0, a, a * b),
              lambda a, b: torch.where(a >= 0, a, a * b)),
    "Div": (lambda a, b: _div(True, a, b), lambda a, b: _div(False, a, b)),
    "Pow": (lambda a, b: _pow(True, a, b), lambda a, b: _pow(False, a, b)),
}


def _binary(name, np_fn, torch_fn):
    @_op(name)
    def run(vals, attrs, ctx):
        a, b = vals
        if _all_np(a, b):
            return [np_fn(a, b)]
        return [torch_fn(ctx.t(a), ctx.t(b))]


for _name, (_np_fn, _torch_fn) in _BINARY.items():
    _binary(_name, _np_fn, _torch_fn)


@_op("Mod")
def _mod(vals, attrs, ctx):
    a, b = vals
    fmod = attrs.get("fmod", 0)
    if _all_np(a, b):
        return [np.fmod(a, b) if fmod else np.mod(a, b)]
    a, b = ctx.t(a), ctx.t(b)
    return [torch.fmod(a, b) if fmod else torch.remainder(a, b)]


def _fold(vals, ctx, np_fn, torch_fn):
    out = vals[0]
    for v in vals[1:]:
        out = np_fn(out, v) if _all_np(out, v) else torch_fn(ctx.t(out), ctx.t(v))
    return [out]


_OPS["Min"] = lambda vals, attrs, ctx: _fold(vals, ctx, np.minimum, torch.minimum)
_OPS["Max"] = lambda vals, attrs, ctx: _fold(vals, ctx, np.maximum, torch.maximum)
_OPS["Sum"] = lambda vals, attrs, ctx: _fold(vals, ctx, np.add, torch.add)


@_op("Relu")
def _relu(vals, attrs, ctx):
    (x,) = vals
    return [np.maximum(x, 0) if _is_np(x) else torch.relu(x)]


@_op("LeakyRelu")
def _leaky(vals, attrs, ctx):
    (x,) = vals
    alpha = attrs.get("alpha", 0.01)
    if _is_np(x):
        return [np.where(x >= 0, x, x * alpha)]
    return [F.leaky_relu(x, alpha)]


@_op("Elu")
def _elu(vals, attrs, ctx):
    (x,) = vals
    alpha = attrs.get("alpha", 1.0)
    if _is_np(x):
        return [np.where(x >= 0, x, alpha * (np.exp(x) - 1.0))]
    return [torch.where(x >= 0, x, alpha * (torch.exp(x) - 1.0))]


@_op("Sigmoid")
def _sigmoid(vals, attrs, ctx):
    (x,) = vals
    if _is_np(x):
        return [1.0 / (1.0 + np.exp(-x))]
    return [torch.sigmoid(x)]


@_op("HardSigmoid")
def _hard_sigmoid(vals, attrs, ctx):
    (x,) = vals
    a, b = attrs.get("alpha", 0.2), attrs.get("beta", 0.5)
    if _is_np(x):
        return [np.clip(a * x + b, 0.0, 1.0)]
    return [torch.clamp(a * x + b, 0.0, 1.0)]


@_op("Gelu")
def _gelu(vals, attrs, ctx):
    approx = attrs.get("approximate", "none")
    return [F.gelu(ctx.t(vals[0]), approximate="tanh" if approx == "tanh" else "none")]


@_op("Softplus")
def _softplus(vals, attrs, ctx):
    x = ctx.t(vals[0])
    return [torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))]


@_op("Softmax")
def _softmax(vals, attrs, ctx):
    return [torch.softmax(ctx.t(vals[0]), dim=attrs.get("axis", -1))]


@_op("LogSoftmax")
def _log_softmax(vals, attrs, ctx):
    return [torch.log_softmax(ctx.t(vals[0]), dim=attrs.get("axis", -1))]


@_op("Clip")
def _clip(vals, attrs, ctx):
    x = vals[0]
    lo = vals[1] if len(vals) > 1 and vals[1] is not None else attrs.get("min")
    hi = vals[2] if len(vals) > 2 and vals[2] is not None else attrs.get("max")
    if _all_np(x, lo, hi):
        out = x
        if lo is not None:
            out = np.maximum(out, lo)
        if hi is not None:
            out = np.minimum(out, hi)
        return [out]
    out = ctx.t(x)
    if lo is not None:
        out = torch.maximum(out, ctx.t(lo).to(out.dtype))
    if hi is not None:
        out = torch.minimum(out, ctx.t(hi).to(out.dtype))
    return [out]


@_op("Cast")
def _cast(vals, attrs, ctx):
    (x,) = vals
    dt = _ONNX_TO_NP_DT[attrs["to"]]
    if _is_np(x):
        return [np.asarray(x).astype(dt)]
    return [x.to(_NP_TO_TORCH[dt])]


@_op("Identity")
def _identity(vals, attrs, ctx):
    return [vals[0]]


@_op("Dropout")
def _dropout(vals, attrs, ctx):
    x = vals[0]
    # inference: identity (+ an all-true mask if the second output is used)
    if _is_np(x):
        return [x, np.ones(np.shape(x), bool)]
    return [x, torch.ones_like(x, dtype=torch.bool)]


@_op("Constant")
def _constant(vals, attrs, ctx):
    if "value" in attrs:
        return [attrs["value"]]
    for k in ("value_float", "value_int", "value_floats", "value_ints"):
        if k in attrs:
            return [np.asarray(attrs[k])]
    raise ValueError("Constant node with no value")


@_op("ConstantOfShape")
def _constant_of_shape(vals, attrs, ctx):
    shape = _host(vals[0]).astype(np.int64)
    value = attrs.get("value", np.zeros(1, np.float32))
    return [np.full(tuple(shape), np.asarray(value).reshape(-1)[0],
                    dtype=np.asarray(value).dtype)]


@_op("Shape")
def _shape(vals, attrs, ctx):
    (x,) = vals
    shp = np.asarray(tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x), np.int64)
    return [shp[attrs.get("start", 0):attrs.get("end")]]


@_op("Size")
def _size(vals, attrs, ctx):
    (x,) = vals
    n = x.numel() if isinstance(x, torch.Tensor) else int(np.prod(np.shape(x)))
    return [np.asarray(n, np.int64)]


def _shape_of(x):
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


@_op("Reshape")
def _reshape(vals, attrs, ctx):
    x, shape = vals
    shape = [int(s) for s in _host(shape)]
    if attrs.get("allowzero", 0) == 0:
        shape = [_shape_of(x)[i] if s == 0 else s for i, s in enumerate(shape)]
    return [np.reshape(x, shape) if _is_np(x) else x.reshape(shape)]


@_op("Transpose")
def _transpose(vals, attrs, ctx):
    (x,) = vals
    perm = attrs.get("perm")
    if perm is None:
        perm = list(range(len(_shape_of(x))))[::-1]
    return [np.transpose(x, perm) if _is_np(x) else x.permute(*perm)]


def _axes_arg(vals, attrs, idx=1):
    """Squeeze/Unsqueeze/Reduce axes moved from attribute to input at
    opset 13/18: accept both."""
    if len(vals) > idx and vals[idx] is not None:
        return [int(a) for a in _host(vals[idx]).reshape(-1)]
    axes = attrs.get("axes")
    return None if axes is None else [int(a) for a in axes]


@_op("Squeeze")
def _squeeze(vals, attrs, ctx):
    x = vals[0]
    axes = _axes_arg(vals, attrs)
    nd = len(_shape_of(x))
    if axes is None:
        axes = [i for i, d in enumerate(_shape_of(x)) if d == 1]
    axes = tuple(a % nd for a in axes)
    if _is_np(x):
        return [np.squeeze(x, axis=axes)]
    return [x.squeeze(axes) if axes else x]


@_op("Unsqueeze")
def _unsqueeze(vals, attrs, ctx):
    x = vals[0]
    axes = _axes_arg(vals, attrs)
    out_ndim = len(_shape_of(x)) + len(axes)
    for a in sorted(a % out_ndim for a in axes):
        x = np.expand_dims(x, a) if _is_np(x) else x.unsqueeze(a)
    return [x]


@_op("Flatten")
def _flatten(vals, attrs, ctx):
    (x,) = vals
    shp = _shape_of(x)
    axis = attrs.get("axis", 1) % (len(shp) + 1)
    lead = int(np.prod(shp[:axis])) if axis else 1
    return [np.reshape(x, (lead, -1)) if _is_np(x) else x.reshape(lead, -1)]


@_op("Concat")
def _concat(vals, attrs, ctx):
    if _all_np(*vals):
        return [np.concatenate(vals, axis=attrs["axis"])]
    ts = [ctx.t(v) for v in vals]
    dt = ts[0].dtype
    for v in ts[1:]:
        dt = torch.promote_types(dt, v.dtype)
    return [torch.cat([v.to(dt) for v in ts], dim=attrs["axis"])]


@_op("Split")
def _split(vals, attrs, ctx):
    x = vals[0]
    axis = attrs.get("axis", 0)
    n_out = attrs["__n_outputs__"]
    sizes = None
    if len(vals) > 1 and vals[1] is not None:
        sizes = [int(s) for s in _host(vals[1])]
    elif "split" in attrs:
        sizes = [int(s) for s in attrs["split"]]
    if _is_np(x):
        if sizes is None:
            return list(np.split(x, n_out, axis=axis))
        return list(np.split(x, np.cumsum(sizes)[:-1].tolist(), axis=axis))
    if sizes is None:
        return list(torch.tensor_split(x, n_out, dim=axis))
    return list(torch.split(x, sizes, dim=axis))


def _open_end(e: int, step: int):
    # ONNX uses INT64_MAX / INT64_MIN as open bounds
    if e >= 2**31:
        return None
    if e <= -(2**31):
        return None if step < 0 else 0
    return e


@_op("Slice")
def _slice(vals, attrs, ctx):
    x = vals[0]
    if len(vals) > 1:  # opset >= 10: starts/ends/axes/steps are inputs
        starts = _host(vals[1]).tolist()
        ends = _host(vals[2]).tolist()
        axes = (_host(vals[3]).tolist() if len(vals) > 3 and vals[3] is not None
                else list(range(len(starts))))
        steps = (_host(vals[4]).tolist() if len(vals) > 4 and vals[4] is not None
                 else [1] * len(starts))
    else:
        starts = list(attrs["starts"])
        ends = list(attrs["ends"])
        axes = list(attrs.get("axes", range(len(starts))))
        steps = [1] * len(starts)
    shp = _shape_of(x)
    nd = len(shp)
    idx = [slice(None)] * nd
    for s, e, a, st in zip(starts, ends, axes, steps):
        st = int(st)
        idx[int(a) % nd] = slice(int(s), _open_end(int(e), st), st)
    if _is_np(x):
        return [x[tuple(idx)]]
    # torch slices take no negative step: index those axes explicitly
    for a, sl in enumerate(idx):
        if sl.step is not None and sl.step < 0:
            rows = torch.arange(*sl.indices(shp[a]), device=x.device)
            x = x.index_select(a, rows)
            idx[a] = slice(None)
    return [x[tuple(idx)]]


def _take(x, ind, axis: int):
    """np.take on a tensor: negative indices count from the end."""
    axis = axis % x.dim()
    n = x.shape[axis]
    ind = torch.where(ind < 0, ind + n, ind).to(torch.int64)
    out = x.index_select(axis, ind.reshape(-1))
    return out.reshape(x.shape[:axis] + ind.shape + x.shape[axis + 1:])


@_op("Gather")
def _gather(vals, attrs, ctx):
    x, ind = vals
    axis = attrs.get("axis", 0)
    if _all_np(x, ind):
        return [np.take(x, np.asarray(ind), axis=axis)]
    return [_take(ctx.t(x), ctx.t(ind), axis)]


@_op("GatherElements")
def _gather_elements(vals, attrs, ctx):
    x, ind = ctx.t(vals[0]), ctx.t(vals[1])
    axis = attrs.get("axis", 0) % x.dim()
    ind = torch.where(ind < 0, ind + x.shape[axis], ind).to(torch.int64)
    return [torch.gather(x, axis, ind)]


@_op("Where")
def _where(vals, attrs, ctx):
    c, a, b = vals
    if _all_np(c, a, b):
        return [np.where(c, a, b)]
    a, b = ctx.t(a), ctx.t(b)
    dt = torch.promote_types(a.dtype, b.dtype)
    return [torch.where(ctx.t(c).to(torch.bool), a.to(dt), b.to(dt))]


@_op("Expand")
def _expand(vals, attrs, ctx):
    x, shape = vals
    shape = [int(s) for s in _host(shape)]
    cur = list(_shape_of(x))
    ndim = max(len(cur), len(shape))
    cur = [1] * (ndim - len(cur)) + cur
    shape = [1] * (ndim - len(shape)) + shape
    tgt = [max(c, s) for c, s in zip(cur, shape)]
    if _is_np(x):
        return [np.broadcast_to(np.reshape(x, cur), tgt)]
    return [x.reshape(cur).expand(tgt)]


@_op("Tile")
def _tile(vals, attrs, ctx):
    x, reps = vals
    reps = tuple(int(r) for r in _host(reps))
    return [np.tile(x, reps) if _is_np(x) else torch.tile(x, reps)]


@_op("Range")
def _range(vals, attrs, ctx):
    start, limit, delta = (_host(v).item() for v in vals)
    return [np.arange(start, limit, delta)]


@_op("CumSum")
def _cumsum(vals, attrs, ctx):
    x, axis = vals
    axis = int(_host(axis).reshape(()))
    if attrs.get("exclusive", 0) or attrs.get("reverse", 0):
        raise NotImplementedError("CumSum exclusive/reverse")
    return [np.cumsum(x, axis=axis) if _is_np(x) else torch.cumsum(x, dim=axis)]


@_op("Einsum")
def _einsum(vals, attrs, ctx):
    return [torch.einsum(attrs["equation"], *[ctx.t(v) for v in vals])]


# -- random ops (torch-traced noise: SineGen dither, z noise) ---------------
#
# torch.onnx traces torch.randn/rand into RandomNormal(Like) /
# RandomUniform(Like).  The samples come from host numpy with the JAX
# executor's seed rule, so both executors draw the same noise.

def _random_state(attrs):
    seed = attrs.get("seed")
    if seed is not None:
        return np.random.RandomState(np.uint32(abs(int(seed))))
    # unseeded nodes mix a stable per-node tag into the default seed, so
    # distinct noise nodes of one graph decorrelate deterministically
    tag = attrs.get("__node_id__", "")
    return np.random.RandomState(np.uint32(0x5EED ^ zlib.crc32(tag.encode())))


def _random_dtype(attrs, like=None):
    if "dtype" in attrs:
        return _ONNX_TO_NP_DT[attrs["dtype"]]
    if like is not None:
        return _np_dtype(like)
    return np.dtype(np.float32)


@_op("RandomNormal")
def _random_normal(vals, attrs, ctx):
    out = _random_state(attrs).normal(attrs.get("mean", 0.0), attrs.get("scale", 1.0),
                                      size=tuple(attrs["shape"]))
    return [out.astype(_random_dtype(attrs))]


@_op("RandomNormalLike")
def _random_normal_like(vals, attrs, ctx):
    out = _random_state(attrs).normal(attrs.get("mean", 0.0), attrs.get("scale", 1.0),
                                      size=tuple(_shape_of(vals[0])))
    return [out.astype(_random_dtype(attrs, vals[0]))]


@_op("RandomUniform")
def _random_uniform(vals, attrs, ctx):
    out = _random_state(attrs).uniform(attrs.get("low", 0.0), attrs.get("high", 1.0),
                                       size=tuple(attrs["shape"]))
    return [out.astype(_random_dtype(attrs))]


@_op("RandomUniformLike")
def _random_uniform_like(vals, attrs, ctx):
    out = _random_state(attrs).uniform(attrs.get("low", 0.0), attrs.get("high", 1.0),
                                       size=tuple(_shape_of(vals[0])))
    return [out.astype(_random_dtype(attrs, vals[0]))]


# -- recurrent ops (torch-exported RMVPE BiGRU / separator LSTMs) -----------

def _rnn_common(vals, attrs, ctx, n_gates):
    """Unpack GRU / LSTM inputs: (X, W, R, B, H0, dirs, hidden).  Layout 0
    only (seq, batch, input), what torch exports; sequence_lens must be
    absent or full length, as in the JAX executor."""
    if attrs.get("layout", 0) != 0:
        raise NotImplementedError("RNN layout=1")
    acts = attrs.get("activations")
    if acts:
        defaults = (["Sigmoid", "Tanh"] if n_gates == 3 else ["Sigmoid", "Tanh", "Tanh"])
        for i, a in enumerate(acts):
            a = a.decode() if isinstance(a, bytes) else a
            if a != defaults[i % len(defaults)]:
                raise NotImplementedError(f"RNN activation {a}")

    def opt(i):
        return vals[i] if len(vals) > i else None

    X, W, R = ctx.t(vals[0]), ctx.t(vals[1]), ctx.t(vals[2])
    dirs, gh, _ = W.shape
    hidden = attrs.get("hidden_size", gh // n_gates)
    B = opt(3)
    B = (torch.zeros((dirs, 2 * n_gates * hidden), dtype=X.dtype, device=X.device)
         if B is None else ctx.t(B))
    seq_lens = opt(4)
    if seq_lens is not None and not (_host(seq_lens) == X.shape[0]).all():
        raise NotImplementedError("RNN sequence_lens < seq length")
    H0 = opt(5)
    H0 = (torch.zeros((dirs, X.shape[1], hidden), dtype=X.dtype, device=X.device)
          if H0 is None else ctx.t(H0))
    return X, W, R, B, H0, dirs, hidden


def _rnn_reverse(attrs, dirs):
    """Per direction, whether it runs the sequence backwards."""
    direction = attrs.get("direction", "forward")
    want = {"forward": 1, "reverse": 1, "bidirectional": 2}[direction]
    if dirs != want:
        raise ValueError(f"W has {dirs} dirs for direction={direction}")
    return [direction == "reverse"] if want == 1 else [False, True]


def _rnn_inputs(X, W, B, reverse, n):
    """Input projections of every step for all directions at once:
    (seq, dirs, batch, n*H), each direction's sequence in its own order."""
    xs = torch.stack([torch.flip(X, [0]) if r else X for r in reverse], dim=1)
    return torch.einsum("sdbi,dgi->sdbg", xs, W) + B[None, :, None, : W.shape[1]]


def _rnn_outputs(ys, reverse):
    """Stacked per-step states (seq, dirs, batch, H) back in time order."""
    return torch.stack([torch.flip(ys[:, d], [0]) if r else ys[:, d]
                        for d, r in enumerate(reverse)], dim=1)


@_op("GRU")
def _gru(vals, attrs, ctx):
    """ONNX GRU, gate order z, r, h.  linear_before_reset=1 is the torch
    nn.GRU form that torch.onnx emits (the reference rmvpe.onnx BiGRU)."""
    X, W, R, B, H0, dirs, H = _rnn_common(vals, attrs, ctx, 3)
    lbr = attrs.get("linear_before_reset", 0)
    reverse = _rnn_reverse(attrs, dirs)
    xp = _rnn_inputs(X, W, B, reverse, 3)
    Rt = R.transpose(1, 2)                       # (dirs, H, 3H)
    Rb = B[:, 3 * H:][:, None, :]                # (dirs, 1, 3H)
    h = H0
    ys = []
    for t in range(X.shape[0]):
        xt = xp[t]
        if lbr:
            hr = torch.baddbmm(Rb, h, Rt)
            z = torch.sigmoid(xt[..., :H] + hr[..., :H])
            r = torch.sigmoid(xt[..., H:2 * H] + hr[..., H:2 * H])
            hh = torch.tanh(xt[..., 2 * H:] + r * hr[..., 2 * H:])
        else:
            rz = xt[..., :2 * H] + torch.baddbmm(Rb[..., :2 * H], h, Rt[..., :2 * H])
            z = torch.sigmoid(rz[..., :H])
            r = torch.sigmoid(rz[..., H:])
            hh = torch.tanh(xt[..., 2 * H:]
                            + torch.baddbmm(Rb[..., 2 * H:], r * h, Rt[..., 2 * H:]))
        h = (1.0 - z) * hh + z * h
        ys.append(h)
    Y = _rnn_outputs(torch.stack(ys), reverse)  # (seq, dirs, batch, H)
    return [Y, h][: attrs.get("__n_outputs__", 2)]


@_op("LSTM")
def _lstm(vals, attrs, ctx):
    """ONNX LSTM, gate order i, o, f, c; no peepholes (input 7 must be
    absent), as torch exports it."""
    if len(vals) > 7 and vals[7] is not None:
        raise NotImplementedError("LSTM peepholes")
    X, W, R, B, H0, dirs, H = _rnn_common(vals, attrs, ctx, 4)
    c = (ctx.t(vals[6]) if len(vals) > 6 and vals[6] is not None
         else torch.zeros_like(H0))
    reverse = _rnn_reverse(attrs, dirs)
    xp = _rnn_inputs(X, W, B, reverse, 4)
    Rt = R.transpose(1, 2)
    Rb = B[:, 4 * H:][:, None, :]
    h = H0
    ys = []
    for t in range(X.shape[0]):
        g = xp[t] + torch.baddbmm(Rb, h, Rt)
        i = torch.sigmoid(g[..., :H])
        o = torch.sigmoid(g[..., H:2 * H])
        f = torch.sigmoid(g[..., 2 * H:3 * H])
        c = f * c + i * torch.tanh(g[..., 3 * H:])
        h = o * torch.tanh(c)
        ys.append(h)
    Y = _rnn_outputs(torch.stack(ys), reverse)
    return [Y, h, c][: attrs.get("__n_outputs__", 3)]


def _reduce(name, np_red, torch_red):
    @_op(name)
    def run(vals, attrs, ctx):
        x = vals[0]
        axes = _axes_arg(vals, attrs)
        keepdims = bool(attrs.get("keepdims", 1))
        if axes is None and attrs.get("noop_with_empty_axes", 0):
            return [x]
        nd = len(_shape_of(x))
        ax = tuple(range(nd)) if axes is None else tuple(a % nd for a in axes)
        if _is_np(x):
            return [np_red(x, axis=ax, keepdims=keepdims)]
        return [torch_red(x, ax, keepdims)]


def _torch_prod(x, axes, keepdims):
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdims)
    return x


_reduce("ReduceMean", np.mean, lambda x, a, k: torch.mean(x, dim=a, keepdim=k))
_reduce("ReduceSum", np.sum, lambda x, a, k: torch.sum(x, dim=a, keepdim=k))
_reduce("ReduceMax", np.max, lambda x, a, k: torch.amax(x, dim=a, keepdim=k))
_reduce("ReduceMin", np.min, lambda x, a, k: torch.amin(x, dim=a, keepdim=k))
_reduce("ReduceProd", np.prod, _torch_prod)
_reduce("ReduceL2",
        lambda x, axis, keepdims: np.sqrt(np.sum(np.square(x), axis=axis, keepdims=keepdims)),
        lambda x, a, k: torch.sqrt(torch.sum(torch.square(x), dim=a, keepdim=k)))


@_op("ArgMax")
def _argmax(vals, attrs, ctx):
    (x,) = vals
    axis = attrs.get("axis", 0)
    keepdims = bool(attrs.get("keepdims", 1))
    if _is_np(x):
        out = np.argmax(x, axis=axis).astype(np.int64)
        return [np.expand_dims(out, axis) if keepdims else out]
    return [torch.argmax(x, dim=axis, keepdim=keepdims)]


@_op("MatMul")
def _matmul(vals, attrs, ctx):
    return [torch.matmul(ctx.t(vals[0]), ctx.t(vals[1]))]


@_op("Gemm")
def _gemm(vals, attrs, ctx):
    a, b = ctx.t(vals[0]), ctx.t(vals[1])
    if attrs.get("transA", 0):
        a = a.T
    if attrs.get("transB", 0):
        b = b.T
    y = attrs.get("alpha", 1.0) * (a @ b)
    if len(vals) > 2 and vals[2] is not None:
        y = y + attrs.get("beta", 1.0) * ctx.t(vals[2])
    return [y]


# ---- conv / pool -----------------------------------------------------------

def _pads_pairs(attrs, nd, x_shape, k_eff, strides):
    auto = attrs.get("auto_pad", "NOTSET")
    if auto in ("NOTSET", ""):
        pads = attrs.get("pads", [0] * (2 * nd))
        return [(int(pads[i]), int(pads[i + nd])) for i in range(nd)]
    if auto == "VALID":
        return [(0, 0)] * nd
    out = []
    for i in range(nd):  # SAME_UPPER / SAME_LOWER
        in_sz = x_shape[2 + i]
        out_sz = -(-in_sz // strides[i])
        total = max(0, (out_sz - 1) * strides[i] + k_eff[i] - in_sz)
        lo = total // 2 if auto == "SAME_UPPER" else (total + 1) // 2
        out.append((lo, total - lo))
    return out


def _torch_pad(pairs):
    """(lo, hi) per spatial axis -> F.pad's last-axis-first list."""
    out = []
    for lo, hi in reversed(pairs):
        out += [lo, hi]
    return out


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONVT = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


@_op("Conv")
def _conv(vals, attrs, ctx):
    x, w = ctx.t(vals[0]), ctx.t(vals[1])
    b = ctx.t(vals[2]) if len(vals) > 2 and vals[2] is not None else None
    nd = x.dim() - 2
    strides = [int(s) for s in attrs.get("strides", [1] * nd)]
    dil = [int(d) for d in attrs.get("dilations", [1] * nd)]
    k_eff = [dil[i] * (w.shape[2 + i] - 1) + 1 for i in range(nd)]
    pairs = _pads_pairs(attrs, nd, x.shape, k_eff, strides)
    if all(lo == hi for lo, hi in pairs):
        padding = [lo for lo, _ in pairs]
    else:
        x = F.pad(x, _torch_pad(pairs))
        padding = 0
    return [_CONV[nd](x, w, b, stride=strides, padding=padding, dilation=dil,
                      groups=int(attrs.get("group", 1)))]


@_op("ConvTranspose")
def _conv_transpose(vals, attrs, ctx):
    x, w = ctx.t(vals[0]), ctx.t(vals[1])  # w: (Cin, Cout/group, *k)
    b = ctx.t(vals[2]) if len(vals) > 2 and vals[2] is not None else None
    nd = x.dim() - 2
    strides = [int(s) for s in attrs.get("strides", [1] * nd)]
    dil = [int(d) for d in attrs.get("dilations", [1] * nd)]
    group = int(attrs.get("group", 1))
    out_pad = [int(p) for p in attrs.get("output_padding", [0] * nd)]
    pads = [int(p) for p in attrs.get("pads", [0] * (2 * nd))]
    if attrs.get("auto_pad", "NOTSET") not in ("NOTSET", ""):
        raise NotImplementedError("ConvTranspose auto_pad")
    lo, hi = pads[:nd], pads[nd:]
    if lo == hi and all(op_ < max(s, d) for op_, s, d in zip(out_pad, strides, dil)):
        return [_CONVT[nd](x, w, b, stride=strides, padding=lo, output_padding=out_pad,
                           groups=group, dilation=dil)]
    # asymmetric pads: the full transposed conv, then crop / zero-extend
    y = _CONVT[nd](x, w, None, stride=strides, groups=group, dilation=dil)
    for i in range(nd):
        full = y.shape[2 + i]
        end = full - hi[i] + out_pad[i]
        if end > full:
            y = F.pad(y, [0, 0] * (nd - 1 - i) + [0, end - full])
        y = y.narrow(2 + i, lo[i], end - lo[i])
    if b is not None:
        y = y + b.reshape((1, -1) + (1,) * nd)
    return [y]


_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVGPOOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool_geometry(x, attrs):
    nd = x.dim() - 2
    ks = [int(s) for s in attrs["kernel_shape"]]
    strides = [int(s) for s in attrs.get("strides", [1] * nd)]
    if attrs.get("ceil_mode", 0):
        raise NotImplementedError("pool ceil_mode")
    return nd, ks, strides, _pads_pairs(attrs, nd, x.shape, ks, strides)


@_op("MaxPool")
def _maxpool(vals, attrs, ctx):
    x = ctx.t(vals[0])
    nd, ks, strides, pairs = _pool_geometry(x, attrs)
    if any(lo or hi for lo, hi in pairs):
        x = F.pad(x, _torch_pad(pairs), value=float("-inf"))
    return [_MAXPOOL[nd](x, ks, strides)]


@_op("AveragePool")
def _avgpool(vals, attrs, ctx):
    x = ctx.t(vals[0])
    nd, ks, strides, pairs = _pool_geometry(x, attrs)
    if not any(lo or hi for lo, hi in pairs):
        return [_AVGPOOL[nd](x, ks, strides)]
    xp = F.pad(x, _torch_pad(pairs))
    y = _AVGPOOL[nd](xp, ks, strides)
    if attrs.get("count_include_pad", 0):
        return [y]
    # divide by the count of real (unpadded) elements of each window
    ones = F.pad(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device),
                 _torch_pad(pairs))
    return [y / _AVGPOOL[nd](ones, ks, strides)]


@_op("GlobalAveragePool")
def _gap(vals, attrs, ctx):
    x = ctx.t(vals[0])
    return [torch.mean(x, dim=tuple(range(2, x.dim())), keepdim=True)]


# ---- normalization ---------------------------------------------------------

def _channel_shape(x):
    return (1, -1) + (1,) * (x.dim() - 2)


def _normalize(x, axes, eps):
    mu = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=axes, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


@_op("BatchNormalization")
def _batchnorm(vals, attrs, ctx):
    x, scale, bias, mean, var = (ctx.t(v) for v in vals[:5])
    shape = _channel_shape(x)
    inv = torch.rsqrt(var + attrs.get("epsilon", 1e-5))
    return [(x - mean.reshape(shape)) * (inv * scale).reshape(shape) + bias.reshape(shape)]


@_op("InstanceNormalization")
def _instancenorm(vals, attrs, ctx):
    x, scale, bias = (ctx.t(v) for v in vals)
    shape = _channel_shape(x)
    y = _normalize(x, tuple(range(2, x.dim())), attrs.get("epsilon", 1e-5))
    return [y * scale.reshape(shape) + bias.reshape(shape)]


@_op("LayerNormalization")
def _layernorm(vals, attrs, ctx):
    x, scale = ctx.t(vals[0]), ctx.t(vals[1])
    axis = attrs.get("axis", -1) % x.dim()
    y = _normalize(x, tuple(range(axis, x.dim())), attrs.get("epsilon", 1e-5)) * scale
    if len(vals) > 2 and vals[2] is not None:
        y = y + ctx.t(vals[2])
    return [y]


@_op("GroupNormalization")
def _groupnorm(vals, attrs, ctx):
    x, scale, bias = (ctx.t(v) for v in vals)
    g = int(attrs["num_groups"])
    n, c = x.shape[:2]
    xg = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    y = _normalize(xg, tuple(range(2, xg.dim())), attrs.get("epsilon", 1e-5)).reshape(x.shape)
    shape = _channel_shape(x)
    return [y * scale.reshape(shape) + bias.reshape(shape)]


# ---- resize / pad ----------------------------------------------------------

@_op("Pad")
def _pad(vals, attrs, ctx):
    x = vals[0]
    if len(vals) > 1 and vals[1] is not None:  # opset >= 11
        pads = [int(p) for p in _host(vals[1])]
        cval = (_host(vals[2]).item() if len(vals) > 2 and vals[2] is not None else 0.0)
    else:
        pads = [int(p) for p in attrs["pads"]]
        cval = attrs.get("value", 0.0)
    mode = attrs.get("mode", "constant")
    if mode not in ("constant", "reflect", "edge"):
        raise NotImplementedError(f"Pad mode {mode}")
    nd = len(_shape_of(x))
    pairs = [(pads[i], pads[i + nd]) for i in range(nd)]
    neg = [(-min(lo, 0), -min(hi, 0)) for lo, hi in pairs]
    pairs = [(max(lo, 0), max(hi, 0)) for lo, hi in pairs]
    if _is_np(x):
        y = (np.pad(x, pairs, constant_values=cval) if mode == "constant"
             else np.pad(x, pairs, mode=mode))
    elif mode == "constant":
        y = F.pad(x, _torch_pad(pairs), value=cval)
    else:
        # reflect / edge on any axis: gather the rows numpy's pad would
        y = x
        for a, (lo, hi) in enumerate(pairs):
            if lo or hi:
                rows = np.pad(np.arange(y.shape[a]), (lo, hi), mode=mode)
                y = y.index_select(a, torch.as_tensor(rows, device=y.device))
    if any(lo or hi for lo, hi in neg):
        y = y[tuple(slice(lo, (-hi or None)) for lo, hi in neg)]
    return [y]


@_op("Resize")
def _resize(vals, attrs, ctx):
    x = ctx.t(vals[0])
    scales = (_host(vals[2]) if len(vals) > 2 and vals[2] is not None
              and _host(vals[2]).size else None)
    sizes = _host(vals[3]) if len(vals) > 3 and vals[3] is not None else None
    if sizes is not None:
        out_shape = [int(s) for s in sizes]
    else:
        out_shape = [int(np.floor(x.shape[i] * float(scales[i]))) for i in range(x.dim())]
    mode = attrs.get("mode", "nearest")
    coord = attrs.get("coordinate_transformation_mode", "half_pixel")
    if mode == "nearest":
        # torch Upsample(nearest) exports asymmetric + floor
        out = x
        for ax in range(x.dim()):
            if out_shape[ax] != x.shape[ax]:
                scale = out_shape[ax] / x.shape[ax]
                ii = np.floor(np.arange(out_shape[ax]) / scale).astype(np.int64)
                ii = np.clip(ii, 0, x.shape[ax] - 1)
                out = out.index_select(ax, torch.as_tensor(ii, device=x.device))
        return [out]
    if mode == "linear":
        if coord == "align_corners":
            raise NotImplementedError("Resize linear align_corners")
        if list(out_shape[:2]) != list(x.shape[:2]):
            raise NotImplementedError("Resize linear over the batch or channel axis")
        nd = x.dim() - 2
        spatial = out_shape[2:]
        # half-pixel linear interpolation (jax.image.resize "bilinear",
        # which antialiases a downscale; torch antialiases only 2-D)
        down = any(o < i for o, i in zip(spatial, x.shape[2:]))
        return [F.interpolate(x, size=spatial, mode={1: "linear", 2: "bilinear",
                                                     3: "trilinear"}[nd],
                              align_corners=False, antialias=down and nd == 2)]
    raise NotImplementedError(f"Resize mode {mode}")


# ---------------------------------------------------------------------------
# control flow (Loop / If) and the node interpreter
# ---------------------------------------------------------------------------
#
# Subgraphs (graph-typed attributes) execute with ONNX outer-scope
# semantics: the body sees every name visible at the Loop/If node plus its
# own formal inputs and local initializers.  Trip counts and conditions
# are read on the host.

def _run_subgraph(g, outer_env: dict, input_vals, ctx):
    env = dict(outer_env)
    for t in g.initializer:
        env[t.name] = op.array_from_tensor(t)
    for vi, v in zip(g.input, input_vals):
        env[vi.name] = v
    _exec_nodes(g.node, env, ctx)
    return [env[vi.name] for vi in g.output]


def _loop_node(node, attrs, env, ctx):
    """ONNX Loop: [M, cond, v...] -> [v_final..., scan_outputs...]."""
    body = attrs["body"]
    vals = [env[i] if i else None for i in node.input]
    M = None if vals[0] is None else int(_host(vals[0]).reshape(()))
    cond = True if vals[1] is None else bool(_host(vals[1]).reshape(()))
    carried = list(vals[2:])
    n_carried = len(carried)
    n_scan = len(body.output) - 1 - n_carried
    scans = [[] for _ in range(n_scan)]
    it = 0
    while cond and (M is None or it < M):
        outs = _run_subgraph(body, env, [np.asarray(it, np.int64), np.asarray(cond)]
                             + carried, ctx)
        cond = bool(_host(outs[0]).reshape(()))
        carried = list(outs[1:1 + n_carried])
        for j, v in enumerate(outs[1 + n_carried:]):
            scans[j].append(v)
        it += 1
    if n_scan and it == 0:
        raise NotImplementedError(
            "Loop with zero iterations and scan outputs (result shape "
            "unknowable without type inference)")
    stacked = [np.stack(s, axis=0) if _all_np(*s) else torch.stack([ctx.t(v) for v in s])
               for s in scans]
    return carried + stacked


def _if_node(node, attrs, env, ctx):
    cond = bool(_host(env[node.input[0]]).reshape(()))
    branch = attrs["then_branch"] if cond else attrs["else_branch"]
    return _run_subgraph(branch, env, [], ctx)


_CONTROL = {"Loop": _loop_node, "If": _if_node}


def _exec_nodes(nodes, env: dict, ctx: _Ctx) -> None:
    for node in nodes:
        attrs = ctx.attrs(node)
        try:
            if node.op_type in _CONTROL:
                outs = _CONTROL[node.op_type](node, attrs, env, ctx)
            else:
                vals = [env[i] if i else None for i in node.input]
                outs = _OPS[node.op_type](vals, attrs, ctx)
        except Exception as e:  # re-raise with the node's name
            raise type(e)(f"{node.op_type} node {node.name or node.output[0]!r}: {e}") from e
        for name, v in zip(node.output, outs):
            if name:
                env[name] = v


def _initializer(arr: np.ndarray, ctx: _Ctx):
    """Small integer / bool initializers stay host numpy (shape arithmetic);
    the rest moves to the device once."""
    if arr.dtype.kind in "iub" and arr.size <= _HOST_CONST_MAX:
        return arr
    return ctx.t(arr)


class OnnxGraph:
    """A parsed ONNX model run by PyTorch on `device` (the card unless the
    caller passes "cpu"; the card raises when it is absent).

    run(feeds) evaluates the graph and returns its outputs, in graph
    order, as tensors on the device."""

    def __init__(self, model_or_path, *, device="cuda"):
        self.device = resolve_device(device)
        self._ctx = _Ctx(self.device)
        if isinstance(model_or_path, op.ModelProto):
            self.model = model_or_path
        else:
            # the reference's released fcpe*.onnx files are AES-encrypted
            # at rest (FCPE.py:28-40, 776); plain files pass through
            from .modelcrypt import maybe_decrypt

            if isinstance(model_or_path, (bytes, bytearray)):
                raw = bytes(model_or_path)
            else:
                with open(model_or_path, "rb") as fh:
                    raw = fh.read()
            self.model = op.load_model(maybe_decrypt(raw))
        g = self.model.graph
        self.graph = g
        self.metadata = {e.key: e.value for e in self.model.metadata_props}
        known = set(_OPS) | set(_CONTROL)

        def collect(graph, acc):
            for n in graph.node:
                if n.op_type not in known:
                    acc.add(n.op_type)
                for a in n.attribute:
                    if a.g is not None:
                        collect(a.g, acc)
                    for sub in a.graphs or []:
                        collect(sub, acc)
            return acc

        unknown = sorted(collect(g, set()))
        if unknown:
            raise NotImplementedError(f"ONNX ops not supported by the PyTorch executor: {unknown}")
        self.initializers = {t.name: _initializer(op.array_from_tensor(t), self._ctx)
                             for t in g.initializer}
        self.input_names = [vi.name for vi in g.input if vi.name not in self.initializers]
        self.output_names = [vi.name for vi in g.output]

    @property
    def node_count(self) -> int:
        return len(self.graph.node)

    def run(self, feeds: dict) -> list:
        env = dict(self.initializers)
        for name, value in feeds.items():
            env[name] = self._ctx.t(value)
        _exec_nodes(self.graph.node, env, self._ctx)
        return [self._ctx.t(env[n]) for n in self.output_names]
