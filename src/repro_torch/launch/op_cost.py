"""Op-level cost counter: flops, bytes and collective wire bytes of a step.

Counterpart of ``repro.launch.hlo_cost`` (which parses optimized XLA HLO
text).  The port has no HLO: :class:`OpCost` is a ``TorchDispatchMode``
that sees every aten op a step runs on this rank, DTensor's local ops on
the shards included (DTensor itself is left to dispatch; a mode below it
sees the per-rank program, as the reference's per-device module is).  It
counts:

  * **flops** from ``torch.utils.flop_counter``'s formulas (matmuls,
    attention, convolutions; 2 per multiply-add), plus one per output
    element of an elementwise or reduction op (``hlo_cost``'s convention);
  * **bytes**: operand plus result bytes of each op that moves data; views
    are free (``hlo_cost._FREE``), as are the collectives' waits;
  * **bytes_min**: only the traffic a perfectly fusing compiler still pays,
    the operands and results of matmuls, attention and the port's kernels
    (elementwise passes taken as fused), to which the dry run adds the
    step's arguments and outputs;
  * **collectives** from the ``_c10d_functional`` ops (DTensor's, and the
    expert-parallel path's through it), under the reference's wire
    conventions (``hlo_cost.py:262–281``): all-gather counts the result,
    reduce-scatter the operand, all-reduce twice the operand, all-to-all
    the larger of the two; each also by the mesh dimension whose group it
    runs on (``coll_by_axis``), which the roofline charges at that group's
    link rate;
  * the port's kernels on fake tensors, through ``kernels._build``'s
    fake-launch hook (K6: 8 B an id and the starts).

Ops that DTensor's sharding propagation runs on fake tensors to learn an
output's shape are not the step's and are not counted.

:class:`StepCost` carries ``HloCost``'s fields (``flops``, ``bytes``,
``bytes_min``, ``coll``, ``n_while``, ``trips``, ``bytes_by_op``); there
is no loop to multiply, so the dry run traces one microbatch and one or
two layers and extrapolates (``StepCost.combine``).
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["OpCost", "StepCost", "tensor_bytes"]

_C10D = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast", "broadcast_": "collective-broadcast",
}
# ops the kernels of a fused program keep on chip: their bytes count only
# toward ``bytes`` (``hlo_cost``'s fusion-optimistic model)
_HARD = {"mm", "bmm", "addmm", "baddbmm", "matmul", "convolution", "embedding",
         "_scaled_dot_product_flash_attention", "_scaled_dot_product_efficient_attention",
         "_scaled_dot_product_cudnn_attention", "_flash_attention_forward",
         "_efficient_attention_forward", "convolution_backward", "embedding_dense_backward",
         "_scaled_dot_product_flash_attention_backward",
         "_scaled_dot_product_efficient_attention_backward"}
_FREE = {"detach", "alias", "lift_fresh", "empty", "empty_strided", "empty_like",
         "wait_tensor", "_local_scalar_dense", "device", "new_empty", "new_empty_strided",
         "set_", "resize_", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
         "is_same_size", "_has_compatible_shallow_copy_type", "record_stream",
         "_wrap_tensor_autograd"}


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class StepCost:
    """A step's cost on one rank (``hlo_cost.HloCost``'s fields)."""
    flops: float = 0.0
    bytes: float = 0.0       # operand + result bytes of every data-moving op
    bytes_min: float = 0.0   # matmuls, attention and kernels only
    coll: Dict[str, float] = field(default_factory=dict)
    n_while: int = 0
    trips: Dict[str, int] = field(default_factory=dict)
    bytes_by_op: Dict[str, float] = field(default_factory=dict)
    coll_by_axis: Dict[str, float] = field(default_factory=dict)
    ops: Dict[str, int] = field(default_factory=dict)
    flops_by_op: Dict[str, float] = field(default_factory=dict)

    @property
    def coll_bytes(self) -> float:
        return float(sum(self.coll.values()))

    @staticmethod
    def combine(terms) -> "StepCost":
        """sum of coefficient * cost over ``terms`` ((float, StepCost)
        pairs): the dry run's extrapolation over loop trips."""
        out = StepCost()
        for a, c in terms:
            out.flops += a * c.flops
            out.bytes += a * c.bytes
            out.bytes_min += a * c.bytes_min
            for name in _DICTS:
                dst = getattr(out, name)
                for k, v in getattr(c, name).items():
                    dst[k] = dst.get(k, 0) + a * v
            out.trips.update(c.trips)
            out.n_while = max(out.n_while, c.n_while)
        for name in _DICTS:
            setattr(out, name, {k: v for k, v in getattr(out, name).items() if v})
        return out


_DICTS = ("coll", "bytes_by_op", "coll_by_axis", "ops", "flops_by_op")


def _wrap_propagation(counter: "OpCost"):
    """Silence ``counter`` while DTensor's sharding propagation runs an op on
    fake tensors to learn its output's shape (done once per op and shapes,
    then cached: counted, it would make a first trace cost more than a
    later one).  Returns the undo."""
    try:
        from torch.distributed.tensor import DTensor

        prop = DTensor._op_dispatcher.sharding_propagator
        name = "_propagate_tensor_meta_non_cached"
        inner = getattr(prop, name)
    except AttributeError:  # another torch: nothing to silence
        return lambda: None

    def quiet(*args, **kwargs):
        counter._quiet += 1
        try:
            return inner(*args, **kwargs)
        finally:
            counter._quiet -= 1

    setattr(prop, name, quiet)
    return lambda: setattr(prop, name, inner)


def _flop_registry():
    from torch.utils.flop_counter import flop_registry

    return flop_registry


class OpCost(TorchDispatchMode):
    """Counts the ops run while it is active into :attr:`cost`.

    ``mesh``: the ``DeviceMesh`` whose groups name the collectives' axes.
    :attr:`peak` is the most bytes of op outputs alive at once on this rank
    (an output counts from the op that makes it until its last reference,
    a view's included, is dropped): the step's temporaries, beside the
    arguments it was given."""

    def __init__(self, mesh=None):
        super().__init__()
        self.cost = StepCost()
        self.live = 0.0   # bytes of the op outputs still referenced
        self.peak = 0.0   # the most of them at once
        self._axis: Dict[str, str] = {}
        if mesh is not None:
            for name in mesh.mesh_dim_names:
                self._axis[mesh.get_group(name).group_name] = name
        self._registry = _flop_registry()

    # the kernels' fake launches (``kernels._build.note_fake``)
    def _kernel(self, name: str, flops: float, nbytes: float) -> None:
        c = self.cost
        c.flops += flops
        c.bytes += nbytes
        c.bytes_min += nbytes
        c.bytes_by_op[name] = c.bytes_by_op.get(name, 0.0) + nbytes
        c.ops[name] = c.ops.get(name, 0) + 1

    def __enter__(self):
        from repro_torch.kernels import _build

        _build.FAKE_HOOKS.append(self._kernel)
        self._quiet = 0
        self._unwrap = _wrap_propagation(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import _build

        _build.FAKE_HOOKS.remove(self._kernel)
        self._unwrap()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor dispatches; its local ops come back here
        out = func(*args, **kwargs)
        if not self._quiet:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        c = self.cost
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        if name in _FREE or func.is_view or ns == "prim":
            return
        c.ops[name] = c.ops.get(name, 0) + 1
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        ib = float(sum(tensor_bytes(t) for t in ins))
        ob = float(sum(tensor_bytes(t) for t in outs))
        if ns in ("_c10d_functional", "_c10d_functional_autograd"):
            kind = _C10D.get(name, name)
            if kind == "all-reduce":
                wire = 2.0 * ib
            elif kind == "reduce-scatter":
                wire = ib
            elif kind == "all-gather":
                wire = ob
            elif kind == "all-to-all":
                wire = max(ib, ob)
            else:
                wire = ob
            c.coll[kind] = c.coll.get(kind, 0.0) + wire
            # the group's name is the op's last string argument
            group = ([a for a in tree_leaves((args, kwargs)) if isinstance(a, str)] or [""])[-1]
            axis = self._axis.get(group, group or "?")
            c.coll_by_axis[axis] = c.coll_by_axis.get(axis, 0.0) + wire
            c.bytes += ib + ob
            c.bytes_by_op[kind] = c.bytes_by_op.get(kind, 0.0) + ib + ob
            self._hold(outs)
            return
        packet = func.overloadpacket
        fl = 0.0
        if packet in self._registry:
            fl = float(self._registry[packet](*args, **kwargs, out_val=out))
        elif outs and outs[0].is_floating_point():
            # elementwise: one per output element; reductions: one per input
            fl = float(outs[0].numel())
            if name.startswith(("sum", "mean", "amax", "amin", "max", "min", "norm",
                                "logsumexp", "prod", "var", "std")):
                fl = float(max([outs[0].numel()] + [t.numel() for t in ins]))
        if fl:
            c.flops += fl
            c.flops_by_op[name] = c.flops_by_op.get(name, 0.0) + fl
        c.bytes += ib + ob
        c.bytes_by_op[name] = c.bytes_by_op.get(name, 0.0) + ib + ob
        if name in _HARD:
            c.bytes_min += ib + ob
        if not name.endswith("_"):  # an in-place op returns its input
            self._hold(outs)

    def _hold(self, outs) -> None:
        for t in outs:
            n = float(tensor_bytes(t))
            if not n:
                continue
            self.live += n
            weakref.finalize(t, self._drop, n)
        self.peak = max(self.peak, self.live)

    def _drop(self, n: float) -> None:
        self.live -= n
