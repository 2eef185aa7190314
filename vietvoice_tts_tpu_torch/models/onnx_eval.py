"""Minimal numpy evaluator for ONNX graphs (ORT-free reference side).

The golden-numerics harness (``golden.py``) normally needs ``onnxruntime``
to execute the reference's graphs (``vietvoicetts/core/
model.py:98-106``). This image has no ORT, so the conversion rehearsal would
be untestable; this module interprets a *supported subset* of ONNX ops with
plain numpy so the reference side can run anywhere. Dynamic shapes are free:
the interpreter works on concrete arrays, so graphs with symbolic dims
(``max_duration``-dependent frame counts) run without shape inference.

Coverage targets the op set of F5-TTS-style exports: Gemm/MatMul/Conv,
LayerNormalization, Softmax, Gather, Reshape/Transpose/Concat/Split/Slice,
Pad (reflect/constant), Range/Shape/ConstantOfShape/Expand, elementwise
math, and RandomNormalLike. Unsupported ops raise ``UnsupportedOp`` with the
op name so ``golden.py`` can report exactly what is missing instead of
guessing.

This is *not* a performance path — it exists to (a) rehearse conversion
end-to-end against a fixture tarball (``models/f5_fixture.py``) and (b) run
the real reference side if the real graphs stay within the subset.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .onnx_pb import OnnxModel, OnnxNode, parse_model

__all__ = ["EvalSession", "UnsupportedOp", "evaluate_graph"]


class UnsupportedOp(NotImplementedError):
    """Graph uses an op outside the supported subset."""


_ONNX_TO_NP = {
    1: np.float32, 2: np.uint8, 3: np.int8, 5: np.int16, 6: np.int32,
    7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64, 12: np.uint32,
    13: np.uint64,
}


def _attr_str(v, default: str = "") -> str:
    if v is None:
        return default
    return v.decode() if isinstance(v, bytes) else str(v)


# Each op: fn(node, inputs) -> list of output arrays. ``inputs`` are numpy
# arrays in node-input order (None for omitted optional inputs).
_OPS: Dict[str, Callable[[OnnxNode, List[Optional[np.ndarray]]], list]] = {}


def _op(name: str):
    def deco(fn):
        _OPS[name] = fn
        return fn

    return deco


def _ew(fn):
    return lambda node, x: [fn(*x)]


for _name, _fn in {
    "Add": lambda a, b: a + b,
    "Sub": lambda a, b: a - b,
    "Mul": lambda a, b: a * b,
    # ONNX Div on integer tensors is C-style truncating division.
    "Div": lambda a, b: (
        (np.sign(a) * np.sign(b) * (np.abs(a) // np.abs(b))).astype(a.dtype)
        if np.issubdtype(np.asarray(a).dtype, np.integer)
        else a / b
    ),
    "Pow": lambda a, b: np.power(a, b),
    "Neg": lambda a: -a,
    "Sqrt": np.sqrt,
    "Exp": np.exp,
    "Log": np.log,
    "Cos": np.cos,
    "Sin": np.sin,
    "Tanh": np.tanh,
    "Abs": np.abs,
    "Reciprocal": lambda a: 1.0 / a,
    "Sigmoid": lambda a: 1.0 / (1.0 + np.exp(-a)),
    "Relu": lambda a: np.maximum(a, 0),
    # functools.reduce, not ufunc.reduce: the operands may broadcast.
    "Max": lambda *xs: __import__("functools").reduce(np.maximum, xs),
    "Min": lambda *xs: __import__("functools").reduce(np.minimum, xs),
    "Less": lambda a, b: a < b,
    "Greater": lambda a, b: a > b,
    "LessOrEqual": lambda a, b: a <= b,
    "GreaterOrEqual": lambda a, b: a >= b,
    "Equal": lambda a, b: a == b,
    "Not": lambda a: ~a,
    "And": lambda a, b: a & b,
    "Or": lambda a, b: a | b,
    "Floor": np.floor,
    "Ceil": np.ceil,
    "Round": lambda a: np.round(a),
    "Sign": np.sign,
    "Mod": lambda a, b: np.fmod(a, b),
    "Erf": None,  # filled below (vectorized via math.erf)
}.items():
    if _fn is not None:
        _OPS[_name] = _ew(_fn)


@_op("Erf")
def _erf(node, x):
    import math

    return [np.vectorize(math.erf, otypes=[x[0].dtype])(x[0])]


@_op("Softplus")
def _softplus(node, x):
    a = x[0]
    # Overflow-safe: log1p(exp(-|a|)) + max(a, 0).
    return [np.log1p(np.exp(-np.abs(a))) + np.maximum(a, 0.0)]


@_op("Mish")
def _mish(node, x):
    (sp,) = _softplus(node, x)
    return [x[0] * np.tanh(sp)]


@_op("Gelu")
def _gelu(node, x):
    a = x[0]
    if _attr_str(node.attrs.get("approximate"), "none") == "tanh":
        c = np.sqrt(2.0 / np.pi).astype(a.dtype) if hasattr(a, "dtype") else np.sqrt(2 / np.pi)
        return [0.5 * a * (1.0 + np.tanh(c * (a + 0.044715 * a**3)))]
    import math

    erf = np.vectorize(math.erf, otypes=[a.dtype])(a / np.sqrt(2.0))
    return [0.5 * a * (1.0 + erf)]


@_op("Clip")
def _clip(node, x):
    lo = x[1] if len(x) > 1 and x[1] is not None else node.attrs.get("min")
    hi = x[2] if len(x) > 2 and x[2] is not None else node.attrs.get("max")
    return [np.clip(x[0], lo, hi)]


@_op("Where")
def _where(node, x):
    return [np.where(x[0], x[1], x[2])]


@_op("Cast")
def _cast(node, x):
    return [x[0].astype(_ONNX_TO_NP[int(node.attrs["to"])])]


@_op("MatMul")
def _matmul(node, x):
    return [np.matmul(x[0], x[1])]


@_op("Gemm")
def _gemm(node, x):
    a, b = x[0], x[1]
    if node.attrs.get("transA"):
        a = a.T
    if node.attrs.get("transB"):
        b = b.T
    y = float(node.attrs.get("alpha", 1.0)) * (a @ b)
    if len(x) > 2 and x[2] is not None:
        y = y + float(node.attrs.get("beta", 1.0)) * x[2]
    return [y]


@_op("Softmax")
def _softmax(node, x):
    axis = int(node.attrs.get("axis", -1))
    a = x[0].astype(np.float32)
    a = a - a.max(axis=axis, keepdims=True)
    e = np.exp(a)
    return [(e / e.sum(axis=axis, keepdims=True)).astype(x[0].dtype)]


@_op("LayerNormalization")
def _layernorm(node, x):
    eps = float(node.attrs.get("epsilon", 1e-5))
    a = x[0].astype(np.float32)
    mu = a.mean(axis=-1, keepdims=True)
    var = np.square(a - mu).mean(axis=-1, keepdims=True)
    y = (a - mu) / np.sqrt(var + eps)
    if len(x) > 1 and x[1] is not None:
        y = y * x[1]
    if len(x) > 2 and x[2] is not None:
        y = y + x[2]
    return [y.astype(x[0].dtype)]


def _reduce(fn):
    def op(node, x):
        axes = node.attrs.get("axes")
        if axes is None and len(x) > 1 and x[1] is not None:
            axes = [int(v) for v in x[1]]
        keep = bool(node.attrs.get("keepdims", 1))
        axes_t = tuple(axes) if axes else None
        return [fn(x[0], axes_t, keep)]

    return op


_OPS["ReduceMean"] = _reduce(lambda a, ax, k: a.mean(axis=ax, keepdims=k))
_OPS["ReduceSum"] = _reduce(lambda a, ax, k: a.sum(axis=ax, keepdims=k))
_OPS["ReduceMax"] = _reduce(lambda a, ax, k: a.max(axis=ax, keepdims=k))
_OPS["ReduceMin"] = _reduce(lambda a, ax, k: a.min(axis=ax, keepdims=k))


@_op("Einsum")
def _einsum(node, x):
    eq = node.attrs.get("equation")
    eq = eq.decode() if isinstance(eq, bytes) else eq
    return [np.einsum(eq, *[a for a in x if a is not None], optimize=True)]


@_op("Trilu")
def _trilu(node, x):
    k = int(x[1]) if len(x) > 1 and x[1] is not None else 0
    upper = bool(node.attrs.get("upper", 1))
    return [np.triu(x[0], k) if upper else np.tril(x[0], k)]


@_op("CumSum")
def _cumsum(node, x):
    axis = int(x[1]) if len(x) > 1 and x[1] is not None else 0
    if node.attrs.get("exclusive") or node.attrs.get("reverse"):
        raise UnsupportedOp("CumSum: exclusive/reverse")
    return [np.cumsum(x[0], axis=axis)]


@_op("Transpose")
def _transpose(node, x):
    perm = node.attrs.get("perm")
    return [np.transpose(x[0], perm)]


@_op("Reshape")
def _reshape(node, x):
    shape = [int(v) for v in x[1]]
    # allowzero=0 (default): 0 copies the input dim.
    shape = [x[0].shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return [x[0].reshape(shape)]


@_op("Concat")
def _concat(node, x):
    return [np.concatenate([a for a in x if a is not None], axis=int(node.attrs["axis"]))]


@_op("Split")
def _split(node, x):
    axis = int(node.attrs.get("axis", 0))
    sizes = node.attrs.get("split")
    if sizes is None and len(x) > 1 and x[1] is not None:
        sizes = [int(v) for v in x[1]]
    if sizes is None:
        n = int(node.attrs.get("num_outputs", len(node.outputs)))
        return list(np.split(x[0], n, axis=axis))
    idx = np.cumsum(sizes)[:-1]
    return list(np.split(x[0], idx, axis=axis))


@_op("Slice")
def _slice(node, x):
    if len(x) >= 3 and x[1] is not None:  # opset 10+: inputs
        starts = [int(v) for v in x[1]]
        ends = [int(v) for v in x[2]]
        axes = [int(v) for v in x[3]] if len(x) > 3 and x[3] is not None else list(
            range(len(starts))
        )
        steps = [int(v) for v in x[4]] if len(x) > 4 and x[4] is not None else [1] * len(
            starts
        )
    else:  # opset 1: attrs
        starts = node.attrs["starts"]
        ends = node.attrs["ends"]
        axes = node.attrs.get("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    sl = [slice(None)] * x[0].ndim
    for s, e, ax, st in zip(starts, ends, axes, steps):
        sl[ax] = slice(s, None if e >= np.iinfo(np.int32).max else e, st)
    return [x[0][tuple(sl)]]


@_op("Gather")
def _gather(node, x):
    axis = int(node.attrs.get("axis", 0))
    return [np.take(x[0], x[1].astype(np.int64), axis=axis)]


@_op("Unsqueeze")
def _unsqueeze(node, x):
    axes = node.attrs.get("axes")
    if axes is None:
        axes = [int(v) for v in x[1]]
    y = x[0]
    for ax in sorted(int(a) if int(a) >= 0 else int(a) + y.ndim + 1 for a in axes):
        y = np.expand_dims(y, ax)
    return [y]


@_op("Squeeze")
def _squeeze(node, x):
    axes = node.attrs.get("axes")
    if axes is None and len(x) > 1 and x[1] is not None:
        axes = [int(v) for v in x[1]]
    return [np.squeeze(x[0], axis=tuple(axes) if axes else None)]


@_op("Shape")
def _shape(node, x):
    return [np.asarray(x[0].shape, np.int64)]


@_op("Range")
def _range(node, x):
    return [np.arange(x[0].item(), x[1].item(), x[2].item(), dtype=x[0].dtype)]


@_op("ConstantOfShape")
def _constant_of_shape(node, x):
    t = node.attrs.get("value")
    if t is not None and getattr(t, "array", None) is not None:
        fill = t.array.reshape(-1)[0]
        dtype = t.array.dtype
    else:
        fill, dtype = 0.0, np.float32
    return [np.full([int(v) for v in x[0]], fill, dtype)]


@_op("Expand")
def _expand(node, x):
    return [np.broadcast_to(x[0], np.broadcast_shapes(x[0].shape, tuple(int(v) for v in x[1]))).copy()]


@_op("Tile")
def _tile(node, x):
    return [np.tile(x[0], [int(v) for v in x[1]])]


@_op("Constant")
def _constant(node, x):
    t = node.attrs.get("value")
    if t is not None and getattr(t, "array", None) is not None:
        return [t.array]
    if "value_float" in node.attrs:
        return [np.float32(node.attrs["value_float"])]
    if "value_int" in node.attrs:
        return [np.int64(node.attrs["value_int"])]
    raise UnsupportedOp("Constant without tensor value")


@_op("Identity")
def _identity(node, x):
    return [x[0]]


@_op("Pad")
def _pad(node, x):
    mode = _attr_str(node.attrs.get("mode"), "constant")
    if len(x) > 1 and x[1] is not None:
        pads = [int(v) for v in x[1]]
    else:
        pads = node.attrs["pads"]
    n = x[0].ndim
    width = [(pads[i], pads[i + n]) for i in range(n)]
    if mode == "constant":
        cval = 0.0
        if len(x) > 2 and x[2] is not None:
            cval = x[2].item()
        return [np.pad(x[0], width, mode="constant", constant_values=cval)]
    if mode == "reflect":
        return [np.pad(x[0], width, mode="reflect")]
    if mode == "edge":
        return [np.pad(x[0], width, mode="edge")]
    raise UnsupportedOp(f"Pad mode {mode}")


@_op("Conv")
def _conv(node, x):
    a, w = x[0], x[1]
    if a.ndim != 3:
        raise UnsupportedOp("Conv: only 1-D (N, C, W) supported")
    group = int(node.attrs.get("group", 1))
    strides = node.attrs.get("strides", [1])
    dil = node.attrs.get("dilations", [1])
    if int(dil[0]) != 1:
        raise UnsupportedOp("Conv: dilation > 1")
    pads = node.attrs.get("pads", [0, 0])
    stride = int(strides[0])
    n, c_in, width = a.shape
    m, cg, k = w.shape
    ap = np.pad(a, ((0, 0), (0, 0), (int(pads[0]), int(pads[1]))))
    out_w = (ap.shape[2] - k) // stride + 1
    # im2col per group: windows [N, C/g, out_w, k] → einsum with [M/g, C/g, k].
    win = np.lib.stride_tricks.sliding_window_view(ap, k, axis=2)[:, :, ::stride]
    outs = []
    mg = m // group
    for g in range(group):
        wg = w[g * mg : (g + 1) * mg]  # [M/g, C/g, k]
        xg = win[:, g * cg : (g + 1) * cg]  # [N, C/g, out_w, k]
        outs.append(np.einsum("ncwk,mck->nmw", xg, wg, optimize=True))
    y = np.concatenate(outs, axis=1)[:, :, :out_w]
    if len(x) > 2 and x[2] is not None:
        y = y + x[2][None, :, None]
    return [y.astype(np.result_type(a.dtype, w.dtype))]


@_op("ConvTranspose")
def _conv_transpose(node, x):
    a, w = x[0], x[1]
    if a.ndim != 3:
        raise UnsupportedOp("ConvTranspose: only 1-D (N, C, W) supported")
    if int(node.attrs.get("group", 1)) != 1:
        raise UnsupportedOp("ConvTranspose: group > 1")
    stride = int(node.attrs.get("strides", [1])[0])
    pads = node.attrs.get("pads", [0, 0])
    n, c_in, width = a.shape
    cin_w, m, k = w.shape  # ONNX ConvTranspose weight: [C_in, C_out/g, k]
    out_w = (width - 1) * stride + k
    y = np.zeros((n, m, out_w), np.result_type(a.dtype, w.dtype))
    # Scatter-add: out[:, :, i*stride : i*stride+k] += in[:, :, i] @ w.
    contrib = np.einsum("ncw,cmk->nwmk", a, w, optimize=True)
    for i in range(width):
        y[:, :, i * stride : i * stride + k] += contrib[:, i]
    if int(pads[0]) or int(pads[1]):
        y = y[:, :, int(pads[0]) : out_w - int(pads[1])]
    if len(x) > 2 and x[2] is not None:
        y = y + x[2][None, :, None]
    return [y]


@_op("RandomNormalLike")
def _random_normal_like(node, x):
    seed = node.attrs.get("seed", 0)
    dtype = _ONNX_TO_NP.get(int(node.attrs.get("dtype", 1)), np.float32)
    rng = np.random.default_rng(int(float(seed)))
    mean = float(node.attrs.get("mean", 0.0))
    scale = float(node.attrs.get("scale", 1.0))
    return [rng.normal(mean, scale, x[0].shape).astype(dtype)]


def evaluate_graph(
    model: OnnxModel,
    feeds: Dict[str, np.ndarray],
    output_names: Optional[Sequence[str]] = None,
) -> List[np.ndarray]:
    """Execute a graph on concrete inputs → outputs in graph (or given) order."""
    g = model.graph
    env: Dict[str, np.ndarray] = {}
    for name, t in g.initializers.items():
        if t.array is not None:
            env[name] = t.array
    for name, a in feeds.items():
        env[name] = np.asarray(a)
    for node in g.nodes:
        fn = _OPS.get(node.op_type)
        if fn is None:
            raise UnsupportedOp(node.op_type)
        ins = [env[i] if i else None for i in node.inputs]
        outs = fn(node, ins)
        for oname, val in zip(node.outputs, outs):
            if oname:
                env[oname] = np.asarray(val)
    wanted = list(output_names) if output_names else [v.name for v in g.outputs]
    missing = [n for n in wanted if n not in env]
    if missing:
        raise KeyError(f"graph did not produce outputs: {missing}")
    return [env[n] for n in wanted]


class _NamedIO:
    def __init__(self, name: str):
        self.name = name


class EvalSession:
    """Drop-in for the ``onnxruntime.InferenceSession`` subset golden.py uses:
    ``get_inputs()``, ``get_outputs()``, ``run(output_names, feeds)``."""

    def __init__(self, model_bytes: bytes):
        self.model = parse_model(model_bytes)

    def get_inputs(self):
        return [_NamedIO(v.name) for v in self.model.graph.inputs]

    def get_outputs(self):
        return [_NamedIO(v.name) for v in self.model.graph.outputs]

    def run(self, output_names, feeds: Dict[str, np.ndarray]):
        return evaluate_graph(self.model, feeds, output_names)
