"""Export PyTorch functions to ONNX by translating their torch.export graph.

The reference exports voice models with torch.onnx.export + onnxsim
(main/library/algorithm/onnx_export.py:16-50).  torch.onnx needs the
`onnx` package, which neither machine of this package has, so the port
translates the graph itself, as `rvc_maker_tpu/interop/onnx_export.py`
translates a jaxpr:

  1. trace with `torch.export.export` on the CPU (every op of the port
     takes its plain version there), dynamic axes as `torch.export.Dim`s;
  2. translate each ATen op of the graph to ONNX nodes (opset 17), the
     parameters as initializers, through the copied protobuf codec
     (`onnx_proto`).  The graph is translated as torch.export gives it
     (its training IR: `aten.linear`, `aten.conv1d`, `aten.layer_norm`,
     ...), with no `run_decompositions()` pass, which would retrace the
     whole graph and more than double the export's time.

Symbolic sizes (the sym_size nodes of a dynamic graph and the integer
arithmetic on them) become 0-D int64 ONNX values rooted at Shape() of
the inputs, so one file serves every length, as the JAX exporter's
`_dim_to_var` lowering does.  A torch.nn.GRU in the traced function
becomes one ONNX GRU node (z-r-h gates, linear_before_reset=1): during
the trace it runs as an opaque custom op, so that its sequence length
stays symbolic.  An ATen op with no translation raises, naming the op.

Scope: the ops of the port's synthesizer (NSF-HiFiGAN), HuBERT and RMVPE
inference paths, and the small functions of the tests.
"""

from __future__ import annotations

import operator
import re

import numpy as np
import torch

from . import onnx_proto as op

aten = torch.ops.aten
INT64_MAX = 2**63 - 1

_TORCH_TO_NP = {torch.float32: np.float32, torch.float64: np.float64,
                torch.float16: np.float16, torch.int64: np.int64,
                torch.int32: np.int32, torch.int16: np.int16, torch.int8: np.int8,
                torch.uint8: np.uint8, torch.bool: np.bool_}


def _np_dtype(dt: torch.dtype):
    if dt not in _TORCH_TO_NP:
        raise NotImplementedError(f"ONNX export of dtype {dt}")
    return np.dtype(_TORCH_TO_NP[dt])


# ---------------------------------------------------------------------------
# the GRU custom op (opaque to the trace, one ONNX GRU node in the file)
# ---------------------------------------------------------------------------

_GRU_OP = None


def _gru_op():
    """`rvc_onnx_export::gru`, registered on first use: torch's GRU on a
    flat weight list, with a shape-only fake implementation, so that
    torch.export keeps it as one node with a symbolic sequence length."""
    global _GRU_OP
    if _GRU_OP is None:
        @torch.library.custom_op("rvc_onnx_export::gru", mutates_args=())
        def gru(x: torch.Tensor, h0: torch.Tensor, weights: list[torch.Tensor],
                num_layers: int, bidirectional: bool,
                batch_first: bool) -> tuple[torch.Tensor, torch.Tensor]:
            y, h = torch._VF.gru(x, h0, weights, True, num_layers, 0.0, False,
                                 bidirectional, batch_first)
            return y, h

        @gru.register_fake
        def _(x, h0, weights, num_layers, bidirectional, batch_first):
            hidden = weights[1].shape[1]
            dirs = 2 if bidirectional else 1
            return x.new_empty(x.shape[:2] + (dirs * hidden,)), h0.new_empty(h0.shape)

        _GRU_OP = gru
    return _GRU_OP


class _ExportGRU(torch.nn.Module):
    """Stands in for a torch.nn.GRU (with biases) during the trace."""

    def __init__(self, gru: torch.nn.GRU):
        super().__init__()
        if not gru.bias or gru.proj_size:
            raise NotImplementedError("ONNX export of a GRU without biases or with proj_size")
        self.gru = gru

    def forward(self, x, hx=None):
        g = self.gru
        dirs = 2 if g.bidirectional else 1
        batch = x.shape[0] if g.batch_first else x.shape[1]
        if hx is None:
            hx = torch.zeros(g.num_layers * dirs, batch, g.hidden_size, dtype=x.dtype,
                             device=x.device)
        return _gru_op()(x, hx, list(g._flat_weights), g.num_layers, g.bidirectional,
                         g.batch_first)


def _swap_grus(tree):
    """The params tree with each torch.nn.GRU wrapped in _ExportGRU."""
    if isinstance(tree, dict):
        return {k: _swap_grus(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_swap_grus(v) for v in tree)
    if isinstance(tree, torch.nn.GRU):
        return _ExportGRU(tree)
    return tree


class _Traced(torch.nn.Module):
    def __init__(self, fn, params):
        super().__init__()
        self.fn = fn
        self.params = params

    def forward(self, *args):
        if self.params is None:
            return self.fn(*args)
        return self.fn(self.params, *args)


# ---------------------------------------------------------------------------
# the graph being written
# ---------------------------------------------------------------------------

class OnnxGraphWriter:
    def __init__(self):
        self.nodes: list[op.NodeProto] = []
        self.initializers: dict[str, np.ndarray] = {}
        self._n = 0
        self._shape_of: dict[str, str] = {}

    def fresh(self, hint="v") -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def const(self, arr, hint="c") -> str:
        name = self.fresh(hint)
        self.initializers[name] = np.asarray(arr)
        return name

    def add(self, op_type, inputs, n_out=1, **attrs):
        outs = [self.fresh(op_type.lower()) for _ in range(n_out)]
        node = op.NodeProto(op_type=op_type, input=list(inputs), output=list(outs))
        for k, v in attrs.items():
            if v is None:
                continue
            a = op.AttributeProto(name=k)
            if isinstance(v, float):
                a.type, a.f = op.ATTR_FLOAT, v
            elif isinstance(v, (bool, int, np.integer)):
                a.type, a.i = op.ATTR_INT, int(v)
            elif isinstance(v, str):
                a.type, a.s = op.ATTR_STRING, v.encode()
            elif isinstance(v, np.ndarray):
                a.type, a.t = op.ATTR_TENSOR, op.tensor_from_array(v)
            elif isinstance(v, (list, tuple)) and v and isinstance(v[0], float):
                a.type, a.floats = op.ATTR_FLOATS, [float(x) for x in v]
            elif isinstance(v, (list, tuple)):
                a.type, a.ints = op.ATTR_INTS, [int(x) for x in v]
            else:  # pragma: no cover
                raise TypeError(f"attr {k}: {type(v)}")
            node.attribute.append(a)
        self.nodes.append(node)
        return outs if n_out != 1 else outs[0]

    def shape(self, x: str) -> str:
        if x not in self._shape_of:
            self._shape_of[x] = self.add("Shape", [x])
        return self._shape_of[x]


def _val(node):
    """The FakeTensor / SymInt / value an fx node carries."""
    return node.meta.get("val") if isinstance(node, torch.fx.Node) else node


def _dtype(node) -> torch.dtype:
    v = _val(node)
    if isinstance(v, torch.Tensor):
        return v.dtype
    if isinstance(v, (bool, torch.SymBool)):
        return torch.bool
    if isinstance(v, (int, torch.SymInt)):
        return torch.int64
    return torch.float32


def _rank(node) -> int:
    return _val(node).dim()


class _Translator:
    """Walks a torch.export graph and emits ONNX nodes into an OnnxGraphWriter."""

    def __init__(self, b: OnnxGraphWriter):
        self.b = b
        self.env: dict = {}

    # -- operands -----------------------------------------------------------

    def name(self, arg, dtype: torch.dtype | None = None) -> str:
        """An fx node or a Python scalar as an ONNX value name, cast to
        `dtype` when one is given and differs."""
        if isinstance(arg, torch.fx.Node):
            nm = self.env[arg]
            if isinstance(nm, list):
                raise NotImplementedError(f"multi-output node {arg.name} used as a value")
            if dtype is not None and _dtype(arg) != dtype:
                nm = self.b.add("Cast", [nm], to=op._NP_TO_ONNX[_np_dtype(dtype).name])
            return nm
        if isinstance(arg, (bool, int, float)):
            dt = dtype or (torch.bool if isinstance(arg, bool) else
                           torch.int64 if isinstance(arg, int) else torch.float32)
            return self.b.const(np.asarray(arg, _np_dtype(dt)), "s")
        raise NotImplementedError(f"ONNX export of argument {arg!r}")

    def int_vec(self, items) -> str:
        """A list of ints and symbolic-int nodes as a 1-D int64 value."""
        items = list(items)
        if all(isinstance(i, int) for i in items):
            return self.b.const(np.asarray(items, np.int64), "shp")
        parts, run = [], []
        for i in items:
            if isinstance(i, int):
                run.append(i)
                continue
            if run:
                parts.append(self.b.const(np.asarray(run, np.int64)))
                run = []
            parts.append(self.b.add("Reshape", [self.name(i, torch.int64),
                                                self.b.const(np.asarray([1], np.int64))]))
        if run:
            parts.append(self.b.const(np.asarray(run, np.int64)))
        return parts[0] if len(parts) == 1 else self.b.add("Concat", parts, axis=0)

    # -- the walk ------------------------------------------------------------

    def run(self, graph: torch.fx.Graph, placeholders: dict):
        out_node = next(n for n in graph.nodes if n.op == "output")
        needed = set()
        stack = list(out_node.all_input_nodes)
        while stack:
            n = stack.pop()
            if n in needed:
                continue
            needed.add(n)
            stack.extend(n.all_input_nodes)
        for n in graph.nodes:
            if n.op == "placeholder":
                self.env[n] = placeholders[n.name]
            elif n.op == "call_function" and n in needed:
                fn = _LOWER.get(n.target) or _LOWER.get(str(n.target))
                if fn is None:
                    raise NotImplementedError(f"no ONNX lowering for {n.target}")
                self.env[n] = fn(self, n, *n.args, **n.kwargs)
        return [self.name(a) for a in out_node.args[0]]


_LOWER: dict = {}


def _lower(*targets):
    def deco(fn):
        for t in targets:
            _LOWER[t] = fn
        return fn
    return deco


def _norm_dim(d: int, rank: int) -> int:
    return d % rank if rank else 0


# -- symbolic integers -------------------------------------------------------

@_lower(aten.sym_size.int)
def _sym_size(tr, n, x, dim):
    return tr.b.add("Gather", [tr.b.shape(tr.name(x)),
                               tr.b.const(np.asarray(_norm_dim(dim, _rank(x)), np.int64))],
                    axis=0)


def _binary(onnx_op, dtype=None):
    """Elementwise op on its operands cast to `dtype` (default the node's)."""
    def run(tr, n, *args):
        dt = dtype or _dtype(n)
        return tr.b.add(onnx_op, [tr.name(a, dt) for a in args])
    return run


for _t, _o in ((operator.add, "Add"), (operator.sub, "Sub"), (operator.mul, "Mul"),
               (operator.floordiv, "Div"), (operator.mod, "Mod"), (torch.sym_max, "Max")):
    _LOWER[_t] = _binary(_o, torch.int64)


@_lower(operator.getitem)
def _getitem(tr, n, x, i):
    v = tr.env[x]
    if not isinstance(v, list) or v[i] is None:
        raise NotImplementedError(f"output {i} of {x.target}")
    return v[i]


# -- elementwise -------------------------------------------------------------

for _t, _o in ((aten.relu.default, "Relu"), (aten.tanh.default, "Tanh"),
               (aten.sigmoid.default, "Sigmoid"), (aten.exp.default, "Exp"),
               (aten.sin.default, "Sin"), (aten.mul.Tensor, "Mul"), (aten.sub.Tensor, "Sub"),
               (aten.bitwise_not.default, "Not"), (aten.div.Tensor, "Div")):
    # div.Tensor is true division: the node's float dtype even on integers
    _LOWER[_t] = _binary(_o)


def _compare(onnx_op):
    def run(tr, n, a, b):
        probes = [torch.empty((1,), dtype=_dtype(v)) if isinstance(v, torch.fx.Node) else v
                  for v in (a, b)]
        dt = torch.result_type(*probes)
        return tr.b.add(onnx_op, [tr.name(a, dt), tr.name(b, dt)])
    return run


for _t, _o in ((aten.eq.Scalar, "Equal"), (aten.lt.Tensor, "Less"),
               (aten.gt.Scalar, "Greater")):
    _LOWER[_t] = _compare(_o)


@_lower(aten.add.Tensor)
def _add(tr, n, a, b, alpha=1):
    dt = _dtype(n)
    bn = tr.name(b, dt)
    if alpha != 1:
        bn = tr.b.add("Mul", [bn, tr.name(alpha, dt)])
    return tr.b.add("Add", [tr.name(a, dt), bn])


@_lower(aten.rsub.Scalar)
def _rsub(tr, n, x, other, alpha=1):
    dt = _dtype(n)
    xn = tr.name(x, dt)
    if alpha != 1:
        xn = tr.b.add("Mul", [xn, tr.name(alpha, dt)])
    return tr.b.add("Sub", [tr.name(other, dt), xn])


@_lower(aten.div.Tensor_mode)
def _div_mode(tr, n, a, b, rounding_mode=None):
    dt = _dtype(n)
    q = tr.b.add("Div", [tr.name(a, dt), tr.name(b, dt)])
    if rounding_mode is None:
        return q
    if rounding_mode != "floor":
        raise NotImplementedError(f"division with rounding_mode={rounding_mode!r}")
    # an integer Div floors in both executors
    return tr.b.add("Floor", [q]) if dt.is_floating_point else q


@_lower(aten.rsqrt.default)
def _rsqrt(tr, n, x):
    return tr.b.add("Reciprocal", [tr.b.add("Sqrt", [tr.name(x, _dtype(n))])])


@_lower(aten.square.default)
def _square(tr, n, x):
    xn = tr.name(x, _dtype(n))
    return tr.b.add("Mul", [xn, xn])


@_lower(aten.remainder.Scalar)
def _remainder(tr, n, a, b):
    dt = _dtype(n)
    return tr.b.add("Mod", [tr.name(a, dt), tr.name(b, dt)], fmod=0)


@_lower(aten.masked_fill.Scalar)
def _masked_fill(tr, n, x, mask, value):
    dt = _dtype(n)
    return tr.b.add("Where", [tr.name(mask, torch.bool), tr.name(value, dt), tr.name(x, dt)])


@_lower(aten.where.ScalarOther)
def _where(tr, n, c, x, other):
    dt = _dtype(n)
    return tr.b.add("Where", [tr.name(c, torch.bool), tr.name(x, dt), tr.name(other, dt)])


@_lower(aten.leaky_relu.default)
def _leaky_relu(tr, n, x, slope=0.01):
    return tr.b.add("LeakyRelu", [tr.name(x)], alpha=float(slope))


@_lower(aten.gelu.default)
def _gelu(tr, n, x, approximate="none"):
    """Opset 17 has no Gelu: 0.5 x (1 + erf(x / sqrt 2)), or the tanh form."""
    dt = _dtype(n)
    xn = tr.name(x)
    if approximate == "tanh":
        cube = tr.b.add("Mul", [tr.b.add("Mul", [xn, xn]), xn])
        inner = tr.b.add("Mul", [tr.name(float(np.sqrt(2.0 / np.pi)), dt),
                                 tr.b.add("Add", [xn, tr.b.add("Mul", [tr.name(0.044715, dt),
                                                                      cube])])])
        core = tr.b.add("Tanh", [inner])
    else:
        core = tr.b.add("Erf", [tr.b.add("Div", [xn, tr.name(float(np.sqrt(2.0)), dt)])])
    half_x = tr.b.add("Mul", [xn, tr.name(0.5, dt)])
    return tr.b.add("Mul", [half_x, tr.b.add("Add", [core, tr.name(1.0, dt)])])


@_lower(aten.clamp.default)
def _clamp(tr, n, x, lo=None, hi=None):
    dt = _dtype(n)
    ins = [tr.name(x, dt), "" if lo is None else tr.name(lo, dt),
           "" if hi is None else tr.name(hi, dt)]
    while ins[-1] == "":
        ins.pop()
    return tr.b.add("Clip", ins)


@_lower(aten.detach_.default, aten.to.device, aten.alias.default, aten.clone.default)
def _identity(tr, n, x, *args, **kw):
    return tr.name(x)


@_lower(aten.to.dtype)
def _to_dtype(tr, n, x, *args, **kw):
    return tr.name(x, _dtype(n))


# -- shapes and indexing -----------------------------------------------------

@_lower(aten.reshape.default)
def _reshape(tr, n, x, shape):
    return tr.b.add("Reshape", [tr.name(x), tr.int_vec(shape)])


@_lower(aten.permute.default)
def _permute(tr, n, x, dims):
    r = _rank(x)
    return tr.b.add("Transpose", [tr.name(x)], perm=[_norm_dim(d, r) for d in dims])


@_lower(aten.transpose.int)
def _transpose(tr, n, x, d0, d1):
    r = _rank(x)
    perm = list(range(r))
    d0, d1 = _norm_dim(d0, r), _norm_dim(d1, r)
    perm[d0], perm[d1] = perm[d1], perm[d0]
    return tr.b.add("Transpose", [tr.name(x)], perm=perm)


@_lower(aten.numpy_T.default)
def _numpy_t(tr, n, x):
    return tr.b.add("Transpose", [tr.name(x)], perm=list(range(_rank(x)))[::-1])


@_lower(aten.expand.default)
def _expand(tr, n, x, sizes, implicit=False):
    # -1 keeps a dim: Expand's broadcast against 1 does the same
    return tr.b.add("Expand", [tr.name(x), tr.int_vec([1 if s == -1 else s for s in sizes])])


@_lower(aten.unsqueeze.default)
def _unsqueeze(tr, n, x, dim):
    d = _norm_dim(dim, _rank(x) + 1)
    return tr.b.add("Unsqueeze", [tr.name(x), tr.b.const(np.asarray([d], np.int64))])


@_lower(aten.select.int)
def _select(tr, n, x, dim, index):
    d = _norm_dim(dim, _rank(x))
    size = _val(x).shape[d]
    if isinstance(index, int) and index < 0 and isinstance(size, int):
        index += size
    return tr.b.add("Gather", [tr.name(x), tr.name(index, torch.int64)], axis=d)


def _bound(v):
    if isinstance(v, int):
        return max(min(v, INT64_MAX), -INT64_MAX)
    return v


@_lower(aten.slice.Tensor)
def _slice(tr, n, x, dim=0, start=None, end=None, step=1):
    start = 0 if start is None else _bound(start)
    end = INT64_MAX if end is None else _bound(end)
    if start == 0 and end == INT64_MAX and step == 1:
        return tr.name(x)
    d = _norm_dim(dim, _rank(x))
    return tr.b.add("Slice", [tr.name(x), tr.int_vec([start]), tr.int_vec([end]),
                              tr.b.const(np.asarray([d], np.int64)),
                              tr.b.const(np.asarray([step], np.int64))])


@_lower(aten.cat.default)
def _cat(tr, n, tensors, dim=0):
    dt = _dtype(n)
    return tr.b.add("Concat", [tr.name(t, dt) for t in tensors], axis=_norm_dim(dim, _rank(n)))


@_lower(aten.chunk.default)
def _chunk(tr, n, x, chunks, dim=0):
    d = _norm_dim(dim, _rank(x))
    sizes = [v.shape[d] for v in _val(n)]
    if not all(isinstance(v, int) for v in sizes):
        raise NotImplementedError("chunk along a symbolic axis")
    outs = tr.b.add("Split", [tr.name(x), tr.int_vec(sizes)], n_out=len(sizes), axis=d)
    return outs if isinstance(outs, list) else [outs]


@_lower(aten.stack.default)
def _stack(tr, n, tensors, dim=0):
    d = _norm_dim(dim, _rank(n))
    axes = tr.b.const(np.asarray([d], np.int64))
    dt = _dtype(n)
    return tr.b.add("Concat", [tr.b.add("Unsqueeze", [tr.name(t, dt), axes]) for t in tensors],
                    axis=d)


@_lower(aten.repeat_interleave.self_int)
def _repeat_interleave(tr, n, x, repeats, dim=None, output_size=None):
    """Each element `repeats` times along dim: unsqueeze after it, expand,
    merge the two axes (a symbolic size merges through Shape)."""
    if dim is None:
        raise NotImplementedError("repeat_interleave without dim")
    r = _rank(x)
    d = _norm_dim(dim, r)
    xn = tr.name(x)
    u = tr.b.add("Unsqueeze", [xn, tr.b.const(np.asarray([d + 1], np.int64))])
    reps = [1] * (r + 1)
    reps[d + 1] = repeats
    e = tr.b.add("Expand", [u, tr.b.const(np.asarray(reps, np.int64))])
    shp = tr.b.shape(xn)
    parts = [tr.b.add("Slice", [shp, tr.b.const(np.asarray([0], np.int64)),
                                tr.b.const(np.asarray([d], np.int64))]),
             tr.b.const(np.asarray([-1], np.int64)),
             tr.b.add("Slice", [shp, tr.b.const(np.asarray([d + 1], np.int64)),
                                tr.b.const(np.asarray([INT64_MAX], np.int64))])]
    return tr.b.add("Reshape", [e, tr.b.add("Concat", parts, axis=0)])


@_lower(aten.flip.default)
def _flip(tr, n, x, dims):
    r = _rank(x)
    dims = [_norm_dim(d, r) for d in dims]
    k = len(dims)
    return tr.b.add("Slice", [tr.name(x), tr.b.const(np.full(k, -1, np.int64)),
                              tr.b.const(np.full(k, -INT64_MAX - 1, np.int64)),
                              tr.b.const(np.asarray(dims, np.int64)),
                              tr.b.const(np.full(k, -1, np.int64))])


_PAD_MODES = {"constant": "constant", "reflect": "reflect", "replicate": "edge"}


@_lower(aten.pad.default)
def _pad(tr, n, x, pad, mode="constant", value=None):
    """F.pad's (last axis first) pairs as ONNX Pad's begins + ends."""
    if mode not in _PAD_MODES:
        raise NotImplementedError(f"pad mode {mode!r}")
    r = _rank(x)
    begins, ends = [0] * r, [0] * r
    for i in range(len(pad) // 2):
        d = r - 1 - i
        begins[d], ends[d] = pad[2 * i], pad[2 * i + 1]
    ins = [tr.name(x), tr.int_vec(begins + ends)]
    if mode == "constant":
        ins.append(tr.name(0 if value is None else value, _dtype(n)))
    return tr.b.add("Pad", ins, mode=_PAD_MODES[mode])


@_lower(aten.embedding.default)
def _embedding(tr, n, weight, indices, *rest):
    return tr.b.add("Gather", [tr.name(weight), tr.name(indices, torch.int64)], axis=0)


@_lower(aten.cumsum.default)
def _cumsum(tr, n, x, dim, dtype=None):
    return tr.b.add("CumSum", [tr.name(x, _dtype(n)),
                               tr.b.const(np.asarray(_norm_dim(dim, _rank(x)), np.int64))])


# -- creation ----------------------------------------------------------------

def _fill(tr, shape_name, value, dt):
    return tr.b.add("ConstantOfShape", [shape_name],
                    value=np.asarray([value], _np_dtype(dt)))


@_lower(aten.full.default)
def _full(tr, n, size, value, **kw):
    return _fill(tr, tr.int_vec(size), value, _dtype(n))


@_lower(aten.zeros.default)
def _zeros(tr, n, size, **kw):
    return _fill(tr, tr.int_vec(size), 0, _dtype(n))


@_lower(aten.zeros_like.default)
def _zeros_like(tr, n, x, **kw):
    return _fill(tr, tr.b.shape(tr.name(x)), 0, _dtype(n))


@_lower(aten.scalar_tensor.default)
def _scalar_tensor(tr, n, v, **kw):
    return tr.name(v, _dtype(n))


@_lower(aten.arange.start, aten.arange.default)
def _arange(tr, n, *args, **kw):
    if n.target == aten.arange.default:
        args = (0, args[0], 1)
    else:
        args = (args[0], args[1], args[2] if len(args) > 2 else kw.get("step", 1))
    dt = _dtype(n)
    # Range reads its three scalars on the host; integer ranges stay int64
    rdt = dt if dt.is_floating_point else torch.int64
    r = tr.b.add("Range", [tr.name(a, rdt) for a in args])
    return r if rdt == dt else tr.b.add("Cast", [r], to=op._NP_TO_ONNX[_np_dtype(dt).name])


# -- reductions --------------------------------------------------------------

def _axes(x, dims):
    r = _rank(x)
    return list(range(r)) if not dims else [_norm_dim(d, r) for d in dims]


@_lower(aten.sum.dim_IntList, aten.sum.default)
def _sum(tr, n, x, dims=None, keepdim=False, dtype=None):
    return tr.b.add("ReduceSum", [tr.name(x, _dtype(n)),
                                  tr.b.const(np.asarray(_axes(x, dims), np.int64))],
                    keepdims=int(keepdim))


@_lower(aten.mean.dim, aten.mean.default)
def _mean(tr, n, x, dims=None, keepdim=False, dtype=None):
    # opset 17's ReduceMean takes its axes as an attribute
    return tr.b.add("ReduceMean", [tr.name(x, _dtype(n))], axes=_axes(x, dims),
                    keepdims=int(keepdim))


@_lower(aten.softmax.int)
def _softmax(tr, n, x, dim, dtype=None):
    return tr.b.add("Softmax", [tr.name(x, _dtype(n))], axis=_norm_dim(dim, _rank(x)))


# -- products, convolutions, pooling, norms ----------------------------------

@_lower(aten.matmul.default)
def _matmul(tr, n, a, b):
    return tr.b.add("MatMul", [tr.name(a), tr.name(b)])


@_lower(aten.linear.default)
def _linear(tr, n, x, w, b=None):
    """x @ w.T (+ b); a constant weight is stored transposed."""
    wn = tr.name(w)
    if wn in tr.b.initializers:
        wt = tr.b.const(np.ascontiguousarray(tr.b.initializers[wn].T), "p")
    else:
        wt = tr.b.add("Transpose", [wn], perm=[1, 0])
    y = tr.b.add("MatMul", [tr.name(x), wt])
    return y if b is None else tr.b.add("Add", [y, tr.name(b)])


@_lower(aten.einsum.default)
def _einsum(tr, n, equation, tensors, path=None):
    return tr.b.add("Einsum", [tr.name(t) for t in tensors], equation=equation)


def _per_axis(v, nd):
    v = [v] if isinstance(v, int) else list(v)
    return v * nd if len(v) == 1 else v


def _conv_nd(tr, x, w, bias, stride, padding, dilation, groups, output_padding=None):
    """Conv, or ConvTranspose when output_padding is given (torch's
    weight layouts are ONNX's)."""
    nd = _rank(x) - 2
    if isinstance(padding, str):
        raise NotImplementedError(f"convolution padding={padding!r}")
    ins = [tr.name(x), tr.name(w)] + ([tr.name(bias)] if bias is not None else [])
    attrs = dict(strides=_per_axis(stride, nd), pads=_per_axis(padding, nd) * 2,
                 dilations=_per_axis(dilation, nd), group=groups,
                 kernel_shape=list(_val(w).shape[2:]))
    if output_padding is None:
        return tr.b.add("Conv", ins, **attrs)
    return tr.b.add("ConvTranspose", ins, output_padding=_per_axis(output_padding, nd), **attrs)


@_lower(aten.conv1d.default, aten.conv2d.default)
def _conv(tr, n, x, w, bias=None, stride=1, padding=0, dilation=1, groups=1):
    return _conv_nd(tr, x, w, bias, stride, padding, dilation, groups)


@_lower(aten.conv_transpose1d.default, aten.conv_transpose2d.input)
def _conv_transpose(tr, n, x, w, bias=None, stride=1, padding=0, output_padding=0, groups=1,
                    dilation=1):
    return _conv_nd(tr, x, w, bias, stride, padding, dilation, groups, output_padding)


@_lower(aten.avg_pool2d.default)
def _avg_pool(tr, n, x, kernel, stride=(), padding=0, ceil_mode=False,
              count_include_pad=True, divisor_override=None):
    if ceil_mode or divisor_override:
        raise NotImplementedError("avg_pool with ceil_mode or divisor_override")
    kernel = _per_axis(kernel, 2)
    return tr.b.add("AveragePool", [tr.name(x)], kernel_shape=kernel,
                    strides=_per_axis(stride or kernel, 2), pads=_per_axis(padding, 2) * 2,
                    count_include_pad=int(count_include_pad))


@_lower(aten.layer_norm.default)
def _layer_norm(tr, n, x, shape, w=None, b=None, eps=1e-5, cudnn_enable=True):
    scale = (tr.name(w) if w is not None
             else tr.b.const(np.ones(list(shape), _np_dtype(_dtype(n)))))
    ins = [tr.name(x), scale] + ([tr.name(b)] if b is not None else [])
    return tr.b.add("LayerNormalization", ins, axis=-len(shape), epsilon=float(eps))


@_lower(aten.group_norm.default)
def _group_norm(tr, n, x, groups, w=None, b=None, eps=1e-5, cudnn_enable=True):
    channels, dt = _val(x).shape[1], _np_dtype(_dtype(x))
    scale = tr.name(w) if w is not None else tr.b.const(np.ones(channels, dt))
    bias = tr.name(b) if b is not None else tr.b.const(np.zeros(channels, dt))
    return tr.b.add("GroupNormalization", [tr.name(x), scale, bias], num_groups=int(groups),
                    epsilon=float(eps))


@_lower("rvc_onnx_export.gru.default")
def _gru(tr, n, x, h0, weights, num_layers, bidirectional, batch_first):
    """torch GRU -> one ONNX GRU per layer: gates (r, z, n) reordered to
    (z, r, h), linear_before_reset=1 (torch's form), seq-major layout."""
    b = tr.b
    dirs = 2 if bidirectional else 1
    xs = tr.name(x)
    if batch_first:
        xs = b.add("Transpose", [xs], perm=[1, 0, 2])
    h0n = tr.name(h0)
    hidden = _val(weights[1]).shape[1]

    def reorder(w):
        return np.concatenate([w[hidden:2 * hidden], w[:hidden], w[2 * hidden:]], 0)

    finals = []
    for layer in range(num_layers):
        per = [weights[(layer * dirs + d) * 4:(layer * dirs + d) * 4 + 4] for d in range(dirs)]
        vals = [[reorder(b.initializers[tr.name(w)]) for w in p] for p in per]
        W = b.const(np.stack([v[0] for v in vals]).astype(np.float32), "gru_w")
        R = b.const(np.stack([v[1] for v in vals]).astype(np.float32), "gru_r")
        B = b.const(np.stack([np.concatenate([v[2], v[3]]) for v in vals])
                    .astype(np.float32), "gru_b")
        h_init = b.add("Slice", [h0n, b.const(np.asarray([layer * dirs], np.int64)),
                                 b.const(np.asarray([(layer + 1) * dirs], np.int64)),
                                 b.const(np.asarray([0], np.int64))])
        Y, Yh = b.add("GRU", [xs, W, R, B, "", h_init], n_out=2, hidden_size=hidden,
                      linear_before_reset=1,
                      direction="bidirectional" if bidirectional else "forward")
        # (seq, dirs, batch, H) -> (seq, batch, dirs * H)
        xs = b.add("Reshape", [b.add("Transpose", [Y], perm=[0, 2, 1, 3]),
                               b.const(np.asarray([0, 0, -1], np.int64))])
        finals.append(Yh)
    out = b.add("Transpose", [xs], perm=[1, 0, 2]) if batch_first else xs
    hn = finals[0] if len(finals) == 1 else b.add("Concat", finals, axis=0)
    return [out, hn]


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

_DIM_SPEC = re.compile(r"^\s*(?:(\d+)\s*\*\s*)?([A-Za-z_]\w*)\s*$")
_CONSTRAINT = re.compile(r"^\s*([A-Za-z_]\w*)\s*>=\s*(\d+)\s*$")


def _dims(dynamic_axes, dim_constraints, input_names, args):
    """torch.export dynamic_shapes from JAX-style dynamic_axes
    ({input: {axis: "t" | "k*t"}}) and constraints ("t >= 21")."""
    from torch.export import Dim

    mins = {}
    for c in dim_constraints:
        m = _CONSTRAINT.match(c)
        if not m:
            raise ValueError(f"dim constraint {c!r}: only 'name >= int' is supported")
        mins[m.group(1)] = int(m.group(2))
    dims: dict = {}
    specs = []
    for nm, a in zip(input_names, args):
        axes = dynamic_axes.get(nm)
        if not axes:
            specs.append(None)
            continue
        spec = {}
        for ax, s in axes.items():
            m = _DIM_SPEC.match(s)
            if not m:
                raise ValueError(f"dynamic axis spec {s!r}: use 'name' or 'int*name'")
            k, var = int(m.group(1) or 1), m.group(2)
            if var not in dims:
                dims[var] = Dim(var, min=mins.get(var, 1))
            spec[ax] = dims[var] if k == 1 else k * dims[var]
        specs.append(spec)
    return (tuple(specs),)


def _value_info(name, val, dim_names=None):
    vi = op.ValueInfoProto(name=name)
    dims = []
    for i, d in enumerate(val.shape):
        if dim_names and i in dim_names:
            dims.append(op.TensorShapeDim(dim_param=dim_names[i]))
        elif isinstance(d, int):
            dims.append(op.TensorShapeDim(dim_value=int(d)))
        else:
            dims.append(op.TensorShapeDim(dim_param=str(d)))
    tt = op.TypeProtoTensor(elem_type=op._NP_TO_ONNX[_np_dtype(val.dtype).name],
                            shape=op.TensorShapeProto(dim=dims))
    vi.type = op.TypeProto(tensor_type=tt)
    return vi


def export_onnx(fn_or_module, example_args, *, params=None, input_names, output_names,
                dynamic_axes=None, dim_constraints=(), metadata=None,
                producer="rvc_maker_tpu_torch", opset=17) -> op.ModelProto:
    """Trace fn(params, *example_args) (or fn(*example_args), or an
    nn.Module, when params is None) with torch.export and translate it to
    an ONNX ModelProto.

    Tensors of `params` (a nested dict / list tree, torch.nn.GRU modules
    included) become initializers; example_args (CPU tensors) become the
    graph inputs `input_names`.  dynamic_axes marks input axes symbolic,
    as the JAX exporter's argument of the same name: {input: {axis:
    "t" | "k*t"}}; dim_constraints such as "t >= 21" become the Dims'
    minima.  A symbolic axis is recorded under its spec as the input's
    dim_param."""
    args = tuple(torch.as_tensor(a) for a in example_args)
    if len(input_names) != len(args):
        raise ValueError(f"{len(args)} traced inputs but {len(input_names)} input_names")
    module = _Traced(fn_or_module, None if params is None else _swap_grus(params))
    dynamic_shapes = (_dims(dynamic_axes, dim_constraints, input_names, args)
                      if dynamic_axes else None)
    with torch.no_grad():
        ep = torch.export.export(module, args, dynamic_shapes=dynamic_shapes,
                                 prefer_deferred_runtime_asserts_over_guards=True)

    b = OnnxGraphWriter()
    consts = {**ep.state_dict, **ep.constants}
    placeholders = {}
    user = iter(input_names)
    user_nodes = []
    from torch.export.graph_signature import InputKind

    ph = {n.name: n for n in ep.graph.nodes if n.op == "placeholder"}
    for spec in ep.graph_signature.input_specs:
        nm = spec.arg.name
        if spec.kind == InputKind.USER_INPUT:
            placeholders[nm] = next(user)
            user_nodes.append(ph[nm])
        else:
            v = consts[spec.target].detach()
            placeholders[nm] = b.const(v.to(torch.float32).numpy() if v.dtype == torch.bfloat16
                                       else v.numpy(), "p")
    outs = _Translator(b).run(ep.graph, placeholders)

    out_node = next(n for n in ep.graph.nodes if n.op == "output")
    out_vals = [_val(a) for a in out_node.args[0]]
    if len(outs) != len(output_names):
        raise ValueError(f"{len(outs)} traced outputs but {len(output_names)} output_names")
    for o, want in zip(outs, output_names):
        if o in b.initializers or o in input_names:
            o = b.add("Identity", [o])  # outputs must be node-produced
        # rename the producing node's output to the requested name
        for nd in b.nodes:
            nd.output = [want if x == o else x for x in nd.output]
            nd.input = [want if x == o else x for x in nd.input]

    dyn = dynamic_axes or {}
    # parameters that no node reads (a linear's weight stored transposed,
    # an unused buffer) stay out of the file
    used = {i for nd in b.nodes for i in nd.input}
    g = op.GraphProto(
        name="main", node=b.nodes,
        initializer=[op.tensor_from_array(v, k) for k, v in b.initializers.items()
                     if k in used],
        input=[_value_info(nm, _val(n), dyn.get(nm)) for nm, n in zip(input_names, user_nodes)],
        output=[_value_info(nm, v) for nm, v in zip(output_names, out_vals)])
    return op.ModelProto(
        ir_version=8, producer_name=producer, producer_version="0.1", graph=g,
        opset_import=[op.OperatorSetIdProto(version=opset)],
        metadata_props=[op.StringStringEntryProto(key=k, value=v)
                        for k, v in (metadata or {}).items()])
