"""What a traced step does on one device: the port's twin of
``repro/launch/hlo.py``.

The reference parses the compiled per-device HLO. The port has no HLO: it
traces the eager program, and ``TraceRecorder``, a ``TorchDispatchMode``,
sees every aten op one device runs. Given a DTensor op it steps aside
(returns ``NotImplemented``), so DTensor's sharding propagation runs and
the recorder sees what that dispatches: the local ops on each shard and
the ``_c10d_functional`` collectives it inserts to redistribute. Those are
DTensor's collectives, not GSPMD's, and their counts are not expected to
equal the reference's.

For each collective it records the kind (all-gather, all-reduce,
reduce-scatter, all-to-all, permute), the result bytes and the group size;
wire bytes use the reference's ring factors (``hlo.py:62-73``, copied):

  all-reduce        wire/dev = 2 * R * (s-1)/s        (R = result bytes)
  all-gather        wire/dev =     R * (s-1)/s        (R = gathered result)
  reduce-scatter    wire/dev =     R * (s-1)           (R = scattered shard)
  all-to-all        wire/dev =     R * (s-1)/s
  collective-permute wire/dev =    R

It also counts, per device: each op's FLOPs (``torch.utils.flop_counter``'s
formulas on the local shapes), the bytes each op reads and writes (its
tensor inputs and outputs; views, metadata queries and allocations move
none, an indexed write or read its indices and the rows it moves; the
eager program's traffic, which is what the port runs: no fusion, and no
reuse through the L2 cache), the per-op output-bytes histogram
(``op_histogram_torch``, the twin of ``hlo.py:99-112``), the peak bytes
of live tensors the traced ops made (``temp_peak``) and the ``local_map``
regions the step entered (``regions``). A kernel call on CPU tensors is one operator
(``repro_torch.flash_attention_plain``, ``decode_attention_plain``,
``ssd_scan_plain``), so it counts as the kernel: its inputs read once,
its outputs written once, the FLOPs of its formula; the plain version's
intermediates make no traffic and no temp.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..models.common import REGION_PREFIX

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: ``_c10d_functional`` op -> the reference's collective kind
_KIND = {"all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all",
         "broadcast": "collective-permute"}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")
#: in-place indexed writes (``t[rows, idx] = v``, the decode step's cache
#: rows) move their indices and values, not the whole of ``t``; indexed
#: reads (an embedding lookup, a gather) their indices and the rows they
#: gather
_ROW_WRITES = ("index_put_", "_index_put_impl_")
_ROW_READS = ("index", "index_select", "gather", "embedding")
#: ops that only reinterpret their input, as views do (a matmul's
#: reshape), and ops that allocate without writing
_NO_TRAFFIC = ("_unsafe_view",)
_ALLOCATIONS = ("empty", "empty_strided", "empty_like", "new_empty",
                "new_empty_strided")


def wire_bytes_np(op: str, result_bytes: int, s: int) -> float:
    """Bytes one device sends for a collective of kind ``op`` with
    ``result_bytes`` of result over a group of ``s`` (ring algorithms)."""
    if s <= 1 and op != "collective-permute":
        return 0.0
    if op == "all-reduce":
        return 2.0 * result_bytes * (s - 1) / s
    if op == "all-gather":
        return float(result_bytes) * (s - 1) / s
    if op == "reduce-scatter":
        return float(result_bytes) * (s - 1)
    if op == "all-to-all":
        return float(result_bytes) * (s - 1) / s
    return float(result_bytes)            # collective-permute


def _tensors_torch(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors_torch(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors_torch(x)


def _nbytes_torch(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: GPUs a node holds: a group whose ranks lie in one node talks over NVLink,
#: else over the network (ranks fill nodes in order, as a launcher places
#: them)
GPUS_PER_NODE = 8


def _group_of_torch(args):
    """(size, spans nodes) of the group a functional collective names (its
    last string argument)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    group = _resolve_process_group([a for a in args
                                    if isinstance(a, str)][-1])
    ranks = dist.get_process_group_ranks(group)
    return len(ranks), len({r // GPUS_PER_NODE for r in ranks}) > 1


@contextlib.contextmanager
def quiet_dtensor_bookkeeping_torch():
    """Run DTensor's own bookkeeping, its sharding propagation and its
    strided-shard offsets, unrecorded and with any fake mode unset: the
    propagation infers an op's output by running it at its global shape,
    which no device runs, and both build small index tensors and read
    them back, which a ``FakeTensorMode`` forbids. The two methods are
    patched while the context is open and restored after."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    import torch.distributed.tensor._sharding_prop as sp
    import torch.distributed.tensor.placement_types as pt
    # the methods this torch has (a release may lack one)
    patched = [(cls, name) for cls, name in (
        (sp.ShardingPropagator, "propagate_op_sharding_non_cached"),
        (getattr(pt, "_StridedShard", None), "local_shard_size_and_offset"))
        if cls is not None and name in cls.__dict__]
    saved = [cls.__dict__[name] for cls, name in patched]

    def quiet(fn):
        def run(*args, **kwargs):
            TraceRecorder.paused += 1
            try:
                with unset_fake_temporarily():
                    return fn(*args, **kwargs)
            finally:
                TraceRecorder.paused -= 1
        return run
    for (cls, name), fn in zip(patched, saved):
        setattr(cls, name, quiet(fn))
    try:
        yield
    finally:
        for (cls, name), fn in zip(patched, saved):
            setattr(cls, name, fn)


class TraceRecorder(TorchDispatchMode):
    """Records the ops one device dispatches while it is entered (see the
    module docstring). ``collectives`` is {kind: {"bytes", "wire_bytes",
    "wire_bytes_internode" (the part over groups that span nodes),
    "count", "by_group_size": {size: count}}}; ``regions`` counts the
    ``local_map`` regions (``models.common.local_region_torch``) entered;
    ``flops``, ``bytes_accessed``, ``temp_peak`` (bytes) and ``ops``
    ({aten op: [output bytes, count, FLOPs]}) accumulate. While entered,
    DTensor's own bookkeeping runs unrecorded
    (``quiet_dtensor_bookkeeping_torch``)."""

    #: > 0 while DTensor's own bookkeeping runs: those ops are not the
    #: device's and are not recorded
    paused = 0

    def __init__(self):
        super().__init__()
        self.collectives = {k: {"bytes": 0, "wire_bytes": 0.0,
                                "wire_bytes_internode": 0.0, "count": 0,
                                "by_group_size": {}} for k in COLLECTIVES}
        self.flops = 0
        self.bytes_accessed = 0
        self.ops = defaultdict(lambda: [0, 0, 0])
        self.live = 0
        self.temp_peak = 0
        self._storages = {}
        self._arguments = set()
        self.regions = defaultdict(int)

    def __enter__(self):
        self._quiet = quiet_dtensor_bookkeeping_torch()
        self._quiet.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._quiet.__exit__(None, None, None)

    def hold_arguments_torch(self, tree):
        """Mark the storages of ``tree``'s tensors (and DTensors' local
        shards) as arguments: ops that write into them make no temp."""
        from torch.distributed.tensor import DTensor
        for t in _tensors_torch(tree):
            if isinstance(t, DTensor):
                t = t.to_local()
            self._arguments.add(t.untyped_storage()._cdata)

    def _track_torch(self, out):
        """Count each new storage among the op's outputs as live until its
        last tensor is freed."""
        for t in _tensors_torch(out):
            try:
                key = t.untyped_storage()._cdata
            except (RuntimeError, NotImplementedError):
                continue
            if key in self._arguments:
                continue
            entry = self._storages.get(key)
            if entry is None:
                entry = self._storages[key] = [t.untyped_storage().nbytes(),
                                               0]
                self.live += entry[0]
                self.temp_peak = max(self.temp_peak, self.live)
            entry[1] += 1
            weakref.finalize(t, self._release_np, key)

    def _release_np(self, key):
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if TraceRecorder.paused:
            return out
        packet = func.overloadpacket
        ns = func.namespace
        name = packet.__name__
        if ns in _NAMESPACES and name in _KIND:
            kind = _KIND[name]
            rb = sum(_nbytes_torch(t) for t in _tensors_torch(out))
            s, internode = _group_of_torch(args)
            rec = self.collectives[kind]
            rec["bytes"] += rb
            rec["wire_bytes"] += wire_bytes_np(kind, rb, s)
            if internode:
                rec["wire_bytes_internode"] += wire_bytes_np(kind, rb, s)
            rec["count"] += 1
            rec["by_group_size"][s] = rec["by_group_size"].get(s, 0) + 1
        if ns in _NAMESPACES and name == "wait_tensor":
            return out
        if ns == "profiler":
            if name == "_record_function_enter_new" and \
                    args[0].startswith(REGION_PREFIX):
                self.regions[args[0][len(REGION_PREFIX):]] += 1
            return out
        from torch.utils.flop_counter import flop_registry
        flops = (flop_registry[packet](*args, **kwargs, out_val=out)
                 if packet in flop_registry else 0)
        self.flops += flops
        self.ops[f"{ns}.{name}"][2] += flops
        if ns == "prim" or func.is_view or name in _NO_TRAFFIC:
            return out                          # metadata and views
        out_b = sum(_nbytes_torch(t) for t in _tensors_torch(out))
        if name in _ROW_WRITES:
            # self is written in its indexed rows only: the indices and
            # values read, the values written
            out_b = _nbytes_torch(args[2])
            in_b = out_b + sum(_nbytes_torch(t)
                               for t in _tensors_torch(args[1]))
        elif name in _ROW_READS:
            # the source is read in the rows gathered only: the indices
            # and as many bytes as the output read
            in_b = out_b + sum(_nbytes_torch(t)
                               for t in _tensors_torch(args[1:]))
        elif name in _ALLOCATIONS:      # live bytes, but nothing written
            in_b = out_b = 0
        else:
            in_b = sum(_nbytes_torch(t) for t in _tensors_torch(args))
            in_b += sum(_nbytes_torch(t) for t in _tensors_torch(kwargs))
        self.bytes_accessed += in_b + out_b
        rec = self.ops[f"{ns}.{name}"]
        rec[0] += out_b
        rec[1] += 1
        if name not in _ROW_WRITES:
            self._track_torch(out)
        return out

    def collective_summary(self) -> dict:
        """``collectives`` with JSON keys."""
        return {k: dict(v, by_group_size={str(s): n for s, n in
                                          sorted(v["by_group_size"].items())})
                for k, v in self.collectives.items()}


def op_histogram_torch(recorder: TraceRecorder, top: int = 20) -> list:
    """Per-op output bytes and counts, the largest first."""
    ranked = sorted(recorder.ops.items(), key=lambda kv: -kv[1][0])[:top]
    return [{"op": k, "out_bytes": v[0], "count": v[1], "flops": v[2]}
            for k, v in ranked]
