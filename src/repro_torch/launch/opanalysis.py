"""Op-level cost analysis of an eager step: the port's counterpart of
``repro/launch/hloanalysis.py``.

The reference parses the partitioned HLO text because XLA's
``cost_analysis`` counts a while-loop body once (its module docstring).
Torch has no HLO and an eager step has no loop to resolve: every op of
every loop iteration, of the backward pass and of each checkpointed
recompute is dispatched, and a ``TorchDispatchMode`` sees each once.
``analyze(fn, *args)`` runs ``fn`` under such a mode, on ``meta``
tensors (shapes only: nothing is allocated or computed), and returns the
reference's ``Analysis`` fields:

  * ``flops``: matmul-class FLOPs (``torch.utils.flop_counter``'s
    formulas: mm, bmm, addmm, baddbmm, convolutions, attention; and
    2 x the matrix's elements for mv, addmv and dot, which it leaves
    out), the counterpart of the reference's dot-only count;
  * ``bytes``: operand plus result bytes of every dispatched op but
    views (an eager step runs unfused, so each op reads its operands
    from memory and writes its results);
  * ``copy_bytes``: result bytes of dtype and device copies
    (``_to_copy``, and ``copy_`` between dtypes or devices);
  * ``collectives``: per-device result bytes by kind of the mesh
    collectives called (``launch/mesh.py``), and their counts;
  * ``unknown_trips``: always 0 (no trip count to recover);
  * ``peak_live_bytes``: the most bytes held at once by the storages
    created during ``fn`` (each counted once, however many views share
    it; tracked by weakref until autograd and Python both let it go).
    Storages that exist before the call (parameters, inputs) are not
    counted: the number is comparable with
    ``torch.cuda.max_memory_allocated`` above what was allocated before
    the same step on the card.

The kernel dispatch (``kernels/ops.py``) hands ``meta`` tensors the
card's route: each kernel's outputs and workspace, nothing launched.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .mesh import record_collectives

_aten = torch.ops.aten
_META = torch.device("meta")


def _vector_flops(a, b, *rest, out_val=None, **kw) -> int:
    """matrix x vector (and vector . vector): 2 x the elements of the
    matrix (vector) operand, as a dot counts 2 x out x K."""
    return 2 * max(a.numel(), b.numel())


#: ``flop_counter``'s formulas, with the matrix-vector products (which
#: it leaves out and XLA counts as dots) added
_FLOPS = dict(flop_registry)
_FLOPS.update({_aten.mv: _vector_flops, _aten.dot: _vector_flops,
               _aten.vdot: _vector_flops,
               _aten.addmv: lambda c, a, b, *r, **kw: _vector_flops(a, b)})


@dataclasses.dataclass
class Analysis:
    flops: float
    bytes: float
    unknown_trips: int
    copy_bytes: float = 0.0
    collectives: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    peak_live_bytes: int = 0
    n_ops: int = 0

    @property
    def collective_bytes(self) -> float:
        return sum(self.collectives.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(args, out: list) -> list:
    """The tensors of an op's arguments or results (tensors, and lists
    or tuples of them), in order."""
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            _tensors(a, out)
    return out


def _key(x):
    """A hashable stand-in for an op argument: a tensor by its metadata,
    a list as a tuple; raises TypeError for what cannot be hashed."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device)
    if isinstance(x, (list, tuple)):
        return tuple(_key(a) for a in x)
    hash(x)
    return x


def _fresh(func) -> bool:
    """Whether ``func``'s results are new storage (no result aliases an
    input: not a view, not in place, no out=)."""
    return all(r.alias_info is None for r in func._schema.returns)


class _OpCounter(TorchDispatchMode):
    """Matmul FLOPs (``flop_counter``'s formulas), bytes, copy bytes and
    live storage of every dispatched op: one mode, so each op pays for
    one Python dispatch."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.copy_bytes = 0
        self.n_ops = 0
        self.live = 0
        self.peak = 0
        self._sizes: dict = {}           # storage id -> bytes, while live
        self._kind: dict = {}            # op -> (view, fresh, FLOP formula)
        self._meta: dict = {}            # a meta op's call -> its results

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        self._sizes[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _run(self, func, args, kwargs):
        """``func`` on fresh results.  On ``meta`` the results of a call
        depend only on its arguments' metadata, so a repeated call (the
        same layer, micro-batch or chunk again) takes its results'
        shapes, strides and dtypes from the first and skips the meta
        kernel, much of which is Python."""
        try:
            key = (func, _key(args), _key(tuple(kwargs.items())))
        except TypeError:
            return func(*args, **kwargs)
        spec = self._meta.get(key)
        if spec is not None:
            outs = [torch.empty_strided(sh, st, dtype=dt, device=_META)
                    for sh, st, dt in spec[1]]
            return outs[0] if spec[0] else tuple(outs)
        out = func(*args, **kwargs)
        single = isinstance(out, torch.Tensor)
        outs = (out,) if single else out
        if (isinstance(outs, tuple)
                and all(isinstance(t, torch.Tensor)
                        and t.device.type == "meta" for t in outs)):
            self._meta[key] = (single, [(t.shape, t.stride(), t.dtype)
                                        for t in outs])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.n_ops += 1
        kind = self._kind.get(func)
        if kind is None:
            kind = self._kind[func] = (func.is_view, _fresh(func),
                                       _FLOPS.get(func.overloadpacket))
        view, fresh, count = kind
        out = self._run(func, args, kwargs) if fresh else func(*args,
                                                                **kwargs)
        if view:
            return out
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,),
                        [])
        ins = _tensors(args, _tensors(kwargs.values(), []))
        self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if func is _aten._to_copy.default or (
                func is _aten.copy_.default
                and (args[0].dtype != args[1].dtype
                     or args[0].device != args[1].device)):
            self.copy_bytes += sum(map(_nbytes, outs))
        if fresh:
            for t in outs:
                self._track(t)
        return out


def analyze(fn, *args, **kwargs) -> Analysis:
    """Run ``fn(*args, **kwargs)`` once under the op counter (on
    ``meta`` tensors for a dry run) -> ``Analysis``."""
    return analyze_with_output(fn, *args, **kwargs)[0]


def analyze_with_output(fn, *args, **kwargs) -> tuple:
    """``analyze`` that also returns what ``fn`` returned."""
    with record_collectives() as log, _OpCounter() as ops:
        out = fn(*args, **kwargs)
    ana = Analysis(
        flops=float(ops.flops), bytes=float(ops.bytes),
        unknown_trips=0, copy_bytes=float(ops.copy_bytes),
        collectives={k: float(v) for k, v in log.bytes.items() if v},
        collective_counts={k: v for k, v in log.counts.items() if v},
        peak_live_bytes=ops.peak, n_ops=ops.n_ops)
    return ana, out
