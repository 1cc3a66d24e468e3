"""FLOP and byte counts of a traced step (port of ``repro.perf.jaxpr_cost``).

The reference derives a step's roofline inputs from its jaxpr.  The port has
no jaxpr: :func:`trace_cost` runs the step eagerly under a
``TorchDispatchMode`` and charges every aten op it dispatches by the
reference's rules (``src/repro/perf/jaxpr_cost.py``):

  flops  — 2·M·N·K per matrix product (``mm``, ``bmm``, ``addmm``,
           ``baddbmm``; the added term of ``addmm`` / ``baddbmm`` as an
           elementwise op), 2·|out|·(kernel size) per convolution, |out| per
           elementwise op (10·|out| per transcendental), |in| per reduction,
           10·|in| per sort / top-k
  bytes  — operand + result sizes of a matrix product, sort, top-k and of
           the remaining data movement (concatenation, padding); the result
           of a reduction; 2·update (+ indices) of an in-place update or
           scatter (``copy_`` into a tensor included, the twin of
           ``dynamic_update_slice``); 2·result + indices of a gather.
           Elementwise ops, views, copies without a cast, fills and factories
           charge no bytes (the reference's fusion-oblivious byte model,
           where elementwise producers fuse into their consumers).

Composite ops are counted by the aten ops they decompose into, with or
without ``torch.inference_mode``.  Eager torch runs every loop iteration,
so trip counts come out exact: the layers, the microbatches, the query
chunks and the recompute of a remat backward are each counted as often as
they run (the jaxpr module reads a ``scan``'s ``length`` for that).
Operands on the meta device compute nothing and allocate nothing, so a step
at production shapes traces on a host.  Collectives (``c10d`` ops) are left
to :mod:`repro_torch.perf.comm_stats`; they cost nothing here.

The count is what one process runs: on a mesh each process traces its own
program (its shard of the weights and the batch), where the reference's
jaxpr has the global shapes.
"""

from __future__ import annotations

from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpCounter", "trace_cost", "op_histogram"]

_FLOP1 = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "neg", "abs",
    "floor", "ceil", "trunc", "frac", "remainder", "fmod", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "logical_and", "logical_or", "logical_xor", "logical_not",
    "where", "sign", "sgn", "round", "clamp", "clamp_min", "clamp_max", "eq", "ne", "lt", "le",
    "gt", "ge", "bitwise_left_shift", "bitwise_right_shift", "__lshift__", "__rshift__",
    "reciprocal", "square", "masked_fill", "lerp", "addcmul", "addcdiv", "isnan", "isinf",
    "isfinite", "relu", "threshold_backward", "hardtanh", "nan_to_num", "copysign", "heaviside",
}
_FLOP10 = {
    "exp", "exp2", "log", "log2", "log10", "tanh", "sigmoid", "rsqrt", "sqrt", "pow", "erf",
    "erfc", "erfinv", "sin", "cos", "tan", "log1p", "expm1", "silu", "gelu", "softplus",
    "atan", "atan2", "sigmoid_backward", "tanh_backward", "silu_backward", "gelu_backward",
    "softplus_backward", "xlogy", "logit",
}
_FREE = {
    "view", "_unsafe_view", "reshape", "expand", "expand_as", "permute", "transpose", "t",
    "squeeze", "unsqueeze", "slice", "select", "as_strided", "alias", "detach", "split",
    "split_with_sizes", "chunk", "unbind", "narrow", "view_as_real", "view_as_complex",
    "lift_fresh", "lift_fresh_copy", "clone", "contiguous", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "zeros", "zeros_like", "new_zeros",
    "ones", "ones_like", "new_ones", "full", "full_like", "new_full", "arange", "scalar_tensor",
    "fill", "zero", "_local_scalar_dense", "unfold", "diagonal", "movedim", "flip", "roll",
    "_reshape_alias", "set", "resize", "lift", "rand", "randn", "normal", "uniform",
    "bernoulli", "unsqueeze_copy", "view_copy", "t_copy", "requires_grad",
    "_has_compatible_shallow_copy_type", "is_same_size",
}
_REDUCE = {
    "sum", "mean", "amax", "amin", "aminmax", "prod", "argmax", "argmin", "any", "all", "var",
    "std", "var_mean", "std_mean", "cumsum", "cumprod", "cummax", "cummin", "logsumexp",
    "_softmax", "_log_softmax", "softmax", "log_softmax", "norm", "linalg_vector_norm",
    "_softmax_backward_data", "_log_softmax_backward_data", "max", "min", "count_nonzero",
}
_SORT = {"sort", "topk", "argsort", "kthvalue", "median", "msort"}
_UPDATE = {
    "index_put", "_index_put_impl_", "scatter", "scatter_add", "scatter_reduce", "index_copy",
    "index_add", "slice_scatter", "select_scatter", "masked_scatter", "copy", "index_fill",
    "diagonal_scatter", "as_strided_scatter",
}
_GATHER = {"index", "gather", "index_select", "embedding", "take", "take_along_dim",
           "_unsafe_index", "masked_select"}
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "_scaled_mm"}


def _tensors(x) -> list:
    """Every tensor in a (nested) argument or result."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in _tensors(y)]
    return []


def _nbytes(ts) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


def _numel(ts) -> float:
    return float(sum(t.numel() for t in ts))


def _base(func) -> str:
    """An aten op's name without its overload and in-place suffix."""
    name = func._schema.name.split("::")[-1]
    return name[:-1] if name.endswith("_") and not name.startswith("_") else name


def _matmul_flops(name: str, args, out) -> float:
    a, b = (args[1], args[2]) if name in ("addmm", "baddbmm", "addbmm") else (args[0], args[1])
    k = a.shape[-1]
    if name == "addbmm":                       # sums over the batch of products
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[-1] * k
    return 2.0 * out.numel() * k


class OpCounter(TorchDispatchMode):
    """Counts the flops and bytes of every aten op dispatched inside it
    (``with OpCounter() as c: ...``): ``c.flops``, ``c.bytes``,
    ``c.matmul_flops`` (the matrix products' share) and ``c.ops`` (a
    ``Counter`` of op names, the twin of an HLO instruction histogram)."""

    def __init__(self):
        super().__init__()
        self.flops = self.bytes = self.matmul_flops = 0.0
        self.ops: Counter = Counter()

    def _charge(self, func, args, kwargs, out) -> tuple[float, float]:
        name = _base(func)
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        io = _nbytes(ins) + _nbytes(outs)
        if name in _MATMUL:
            f = _matmul_flops(name, args, outs[0])
            self.matmul_flops += f
            extra = float(outs[0].numel()) if name in ("addmm", "baddbmm", "addbmm") else 0.0
            return f + extra, io
        if name in ("convolution", "_convolution", "conv2d", "conv1d"):
            w = args[1]
            return 2.0 * outs[0].numel() * w.numel() / max(w.shape[0], 1), io
        if name in ("max", "min") and func._overloadname == "other":
            return _numel(outs), 0.0            # the binary maximum / minimum
        if name == "_to_copy":
            same = all(o.dtype == i.dtype for o, i in zip(outs, ins[:1]))
            return (0.0 if same else _numel(outs)), 0.0
        if name in _FLOP10:
            return 10.0 * _numel(outs), 0.0
        if name in _FLOP1:
            return _numel(outs), 0.0
        if name in _FREE:
            return 0.0, 0.0
        if name in _REDUCE:
            return _numel(ins[:1]), _nbytes(outs)
        if name in _SORT:
            return 10.0 * _numel(ins[:1]), io
        if name in _UPDATE:
            schema = [a.name for a in func._schema.arguments]
            vals = dict(zip(schema, args), **kwargs)
            upd = vals.get("values", vals.get("src", vals.get("source")))
            upd_b = _nbytes(_tensors(upd)) if upd is not None else _nbytes(outs)
            idx = vals.get("indices", vals.get("index"))
            return 0.0, 2.0 * upd_b + (_nbytes(_tensors(idx)) if idx is not None else 0.0)
        if name in _GATHER:
            schema = [a.name for a in func._schema.arguments]
            vals = dict(zip(schema, args), **kwargs)
            idx = vals.get("indices", vals.get("index"))
            return 0.0, 2.0 * _nbytes(outs) + (_nbytes(_tensors(idx)) if idx is not None else 0.0)
        return 0.0, io                          # data movement: concatenation, padding, ...

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # a composite op (``matmul``, ``to``, ...: under inference mode they
        # reach the mode undecomposed) is counted by the ops it runs
        with self:
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns in ("c10d", "_c10d_functional", "c10d_functional", "_dtensor"):
            return out
        name = _base(func)
        self.ops[name] += 1
        f, b = self._charge(func, args, kwargs, out)
        self.flops += f
        self.bytes += b
        return out


def trace_cost(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` and count it: ``{"flops", "bytes"}``
    (meta operands allocate nothing)."""
    with OpCounter() as c:
        fn(*args, **kwargs)
    return {"flops": c.flops, "bytes": c.bytes}


def op_histogram(ops: Counter, top: int = 15) -> list[tuple[str, int]]:
    """The ``top`` aten ops of an :class:`OpCounter`'s ``ops`` by count (the
    twin of the reference's HLO instruction histogram)."""
    return sorted(ops.items(), key=lambda kv: (-kv[1], kv[0]))[:top]
