"""FLOPs and HBM bytes of the ops one eager step executes (the port's
counterpart of ``repro.launch.hlo_cost``, which walks compiled HLO; an
eager PyTorch step has none, so this counts the aten ops as they run).

    with op_cost.Counter() as c:
        step()
    c.cost.flops, c.cost.bytes

`Counter` is a ``TorchDispatchMode``: it sees every aten op below
autograd, backward passes and remat recomputes included, each time it
runs. A Python loop is counted as executed, so there is no trip count to
recover. The conventions are ``hlo_cost``'s:

  * flops: matrix products only (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
    ``_int_mm``, convolutions): 2 * prod(result dims) * contracted size.
    Elementwise flops are not counted.
  * bytes, TPU-fusion-optimistic: the traffic of ops a fusing compiler
    cannot fuse away. Products read their operands and write their
    result; sort / topk / kthvalue read their input and write their
    outputs; gathers (index, index_select, gather, embedding) read the
    rows they take (the result's size) and the indices and write the
    result; scatters (index_put, index_copy, index_add, scatter) read the
    values and indices and write the values' size in place (an
    out-of-place one also copies its destination); copies (``copy_``,
    ``clone``) read and write their size; RNG writes its output.
    Elementwise ops, reductions and dtype casts are assumed fused into
    their neighbours. A view moves nothing.
  * collective bytes: none on one card.

The hand-written kernels are ctypes calls the dispatcher never sees.
Each ``kernels/ops.py`` entry reports its kernel's work through
``kernels.cost.kernel`` and that module's formulas, from shapes and
lengths, and while it runs the counter ignores the aten ops inside it:
the kernel's plain version on the CPU, the wrapper's copies on the card.
So one step counts the same flops and bytes on the CPU and on the card.

On the meta device (the dry run's production-mesh count: every tensor
without storage) an op's outputs are only shapes, but PyTorch computes
many of them through Python reference implementations (~0.3-1 ms an
elementwise op). A step repeats the same ops on the same shapes (layers,
query blocks, microbatches), so `Counter` keeps a memo on meta: the first
call of an op on given argument metadata (shapes, strides, dtypes and the
other arguments) runs it, and later calls build outputs with the same
shapes, strides and dtypes directly; an in-place op whose first call left
its destination's metadata unchanged returns the destination. Ops that
return views run every time. The count is unchanged: it reads only shapes
and dtypes (``tests/test_torch_dryrun_mesh.py`` holds meta against CPU
counts).

Not ported: ``f32_param_copy_bytes`` corrects an artifact of XLA's CPU
backend (hoisted float32 copies of bf16 weights), which eager PyTorch does
not make; the HLO parsing (``parse_computations``, ``module_cost``) has
no HLO to read.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import cost as _kcost

aten = torch.ops.aten


@dataclasses.dataclass
class Cost:
    """``hlo_cost.Cost``'s fields: flops, bytes and collective bytes."""

    flops: float = 0.0
    bytes: float = 0.0
    collective: dict = dataclasses.field(default_factory=dict)

    @property
    def collective_bytes(self) -> float:
        return sum(self.collective.values())


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


def _mm_flops(a: torch.Tensor, out: torch.Tensor) -> float:
    return 2.0 * out.numel() * a.shape[-1]


def _conv_flops(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
                transposed: bool) -> float:
    """2 * output elements * (input channels / groups) * kernel size; a
    transposed convolution does the forward's work of its input."""
    per = w.shape[1] * math.prod(w.shape[2:])
    return 2.0 * (x if transposed else out).numel() * per


# op packets (every overload of each), by how they count
_DOTS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten._int_mm}
_SORTS = {aten.sort, aten.topk, aten.kthvalue}
_GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding}
_PUTS = {aten.index_put_, aten._index_put_impl_, aten.index_put}
_SCATTERS_INPLACE = {aten.index_put_, aten._index_put_impl_,
                     aten.index_copy_, aten.index_add_, aten.scatter_,
                     aten.scatter_add_, aten.scatter_reduce_}
_SCATTERS = {aten.index_put, aten.index_copy, aten.index_add, aten.scatter,
             aten.scatter_add, aten.scatter_reduce}
_COPIES = {aten.copy_, aten.clone}
_RNG = {aten.normal_, aten.uniform_, aten.bernoulli_, aten.bernoulli,
        aten.exponential_, aten.random_, aten.randn, aten.rand,
        aten.randint, aten.randperm, aten.multinomial}


def op_cost(func, args, kwargs, out) -> tuple[float, float]:
    """(flops, bytes) of one aten op under the module's conventions."""
    op = func.overloadpacket
    if op in _DOTS:
        a = args[-2] if op in (aten.addmm, aten.baddbmm) else args[0]
        tensors = [x for x in args if isinstance(x, torch.Tensor)]
        return _mm_flops(a, out), float(_nbytes(tensors) + _nbytes(out))
    if op is aten.convolution:
        x, w = args[0], args[1]
        return (_conv_flops(x, w, out, bool(args[6])),
                float(_nbytes([x, w]) + _nbytes(out)))
    if op is aten.convolution_backward:
        grad, x, w = args[0], args[1], args[2]
        mask = args[-1]
        fwd = _conv_flops(x, w, grad, bool(args[7]))
        return (fwd * (int(mask[0]) + int(mask[1])),
                float(_nbytes([grad, x, w]) + _nbytes(out)))
    if op in _SORTS:
        return 0.0, float(_nbytes(args[0]) + _nbytes(out))
    if op in _GATHERS:
        idx = [x for x in args[1:] if isinstance(x, (torch.Tensor, list,
                                                     tuple))]
        return 0.0, float(2 * _nbytes(out) + _nbytes(idx))
    if op in _SCATTERS_INPLACE or op in _SCATTERS:
        vals = args[2] if op in _PUTS else args[-1]
        idx = [x for x in args[1:] if isinstance(x, (torch.Tensor, list,
                                                     tuple))
               and x is not vals]
        moved = 2 * _nbytes(vals) + _nbytes(idx)
        if op in _SCATTERS:
            moved += _nbytes(args[0]) + _nbytes(out)
        return 0.0, float(moved)
    if op in _COPIES:
        return 0.0, float(2 * _nbytes(args[0]))
    if op in _RNG:
        return 0.0, float(_nbytes(out))
    return 0.0, 0.0


_META = torch.device("meta")
_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.layout, torch.memory_format)


class _NoMemo(Exception):
    pass


def _meta_key(x):
    """Hashable metadata of an argument: a meta tensor's shape, strides,
    offset and dtype; plain values as they are. Raises _NoMemo for
    anything else (a tensor with storage, an unknown object)."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise _NoMemo
        return ("T", tuple(x.shape), x.stride(), x.storage_offset(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_meta_key(y) for y in x)
    if isinstance(x, _PLAIN):
        return x
    raise _NoMemo


def _meta_outputs(out):
    """The metadata of an op's outputs (tensors, or a tuple / list of
    them), or None when there is something else in them."""
    if isinstance(out, torch.Tensor):
        return ("T", tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)) and out and all(
            isinstance(o, torch.Tensor) for o in out):
        return (type(out), tuple((tuple(o.shape), o.stride(), o.dtype)
                                 for o in out))
    return None


def _rebuild(meta):
    if meta[0] == "T":
        return torch.empty_strided(meta[1], meta[2], dtype=meta[3],
                                   device=_META)
    kind, outs = meta
    return kind(torch.empty_strided(s, st, dtype=dt, device=_META)
                for s, st, dt in outs)


@functools.lru_cache(maxsize=None)
def _memo_kind(func) -> str | None:
    """"fresh" for an op whose outputs alias nothing, "inplace" for one
    that writes its first argument and returns it, None otherwise."""
    schema = func._schema
    rets = schema.returns
    if any(r.alias_info is not None for r in rets):
        a = schema.arguments
        if (len(rets) == 1 and a and a[0].alias_info is not None
                and a[0].alias_info.is_write
                and rets[0].alias_info is not None
                and rets[0].alias_info.is_write
                and not any(x.alias_info is not None and x.alias_info.is_write
                            for x in a[1:])):
            return "inplace"
        return None
    if any(x.alias_info is not None and x.alias_info.is_write
           for x in schema.arguments):
        return None
    return "fresh"


class Counter(TorchDispatchMode):
    """Counts flops and bytes of the aten ops run under it (`cost`),
    plus the work the kernels report through ``kernels.cost.kernel``.
    On meta tensors, repeated ops come from a memo (module docstring)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.kernel_calls: dict[str, int] = {}
        self._quiet = 0
        self._memo: dict = {}

    def _run(self, func, args, kwargs):
        kind = _memo_kind(func)
        if kind is None:
            return func(*args, **kwargs)
        try:
            key = (func, _meta_key(args), _meta_key(tuple(sorted(
                kwargs.items()))))
        except (_NoMemo, TypeError):
            return func(*args, **kwargs)
        if kind == "fresh" and not any(
                isinstance(x, torch.Tensor) for x in args) and (
                    kwargs.get("device") not in ("meta", _META)):
            return func(*args, **kwargs)       # a factory off the meta device
        hit = self._memo.get(key)
        if hit is not None:
            return args[0] if hit == "same" else _rebuild(hit)
        out = func(*args, **kwargs)
        if kind == "inplace":
            if out is args[0]:
                self._memo[key] = "same"
        else:
            meta = _meta_outputs(out)
            if meta is not None:
                self._memo[key] = meta
        return out

    def __enter__(self):
        _kcost.counters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _kcost.counters.remove(self)
        return super().__exit__(*exc)

    def mute(self) -> None:
        self._quiet += 1

    def unmute(self) -> None:
        self._quiet -= 1

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        self.cost.flops += flops
        self.cost.bytes += nbytes
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        if not self._quiet:
            f, b = op_cost(func, args, kwargs, out)
            self.cost.flops += f
            self.cost.bytes += b
        return out
