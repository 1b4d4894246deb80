"""Shared layers: dtypes, initializers, RMSNorm, activations, RoPE and
M-RoPE — the port of ``repro/models/common.py``.

The same mixed-precision policy as the reference: params are stored in
``cfg.param_dtype``, the embedding's output is cast to ``cfg.dtype``, every
product of an activation and a weight runs in the dtype jnp promotes the
two to (``mm_promoted_torch``: torch's products refuse mixed dtypes), and
reductions (norms, softmax) and the RoPE rotation run in float32.
``constrain_torch`` is the reference's ``constrain``: on a DTensor, with
the launcher's ``cfg.dp_axes``/``cfg.tp_axis`` set (``launch/dryrun.py``
and a sharded run set them), it redistributes the activation to the
placements its logical dims name; on one card it returns its input.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16,
           "float8_e4m3fn": torch.float8_e4m3fn,
           "float8_e5m2": torch.float8_e5m2}


def shard_axes_torch(cfg, mesh, logical, size: int, granule: int = 1):
    """The mesh axes a dim of ``size`` with logical name ``logical``
    (``"dp"``, ``"tp"`` or None) shards over under ``cfg``'s launcher
    axes: the longest prefix of them whose product, times ``granule``,
    divides ``size`` (``launch/sharding.py``'s rule for specs)."""
    names = mesh.mesh_dim_names
    axes = (tuple(cfg.dp_axes) if logical == "dp"
            else (cfg.tp_axis,) if logical == "tp" and cfg.tp_axis else ())
    axes = tuple(a for a in axes if a in names)
    while axes and size % (granule * math.prod(
            mesh.size(names.index(a)) for a in axes)):
        axes = axes[:-1]
    return axes


def placements_of_torch(mesh, layout):
    """DTensor placements for ``layout``, a tuple with the mesh axes of
    each tensor dim: a mesh dim shards the tensor dim that names it, else
    replicates (a mesh dim of size 1 always replicates: DTensor will not
    view a dim sharded one way)."""
    placements = [Replicate()] * mesh.ndim
    for d, axes in enumerate(layout):
        for a in axes:
            i = mesh.mesh_dim_names.index(a)
            if mesh.size(i) > 1:
                placements[i] = Shard(d)
    return tuple(placements)


def unshard_dp_torch(w, cfg):
    """A weight as a layer uses it: on a DTensor with ``cfg.dp_axes`` set,
    gathered over the data-parallel axes (ZeRO-3 / FSDP: the backward
    reduce-scatters its gradient), its tensor-parallel shards kept; else
    ``w`` itself. GSPMD picks this plan for the reference; DTensor's cost
    model, left alone, may shard the contraction instead and replicate a
    matrix product's tokens."""
    if not cfg.dp_axes:
        return w
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    placements = tuple(Replicate() if isinstance(pl, Shard)
                       and names[i] in cfg.dp_axes else pl
                       for i, pl in enumerate(w.placements))
    if placements == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, placements)


def constrain_torch(x, cfg, *dims, granule=None):
    """The reference's ``constrain`` (``with_sharding_constraint`` by
    logical dims: ``"dp"``, ``"tp"`` or None, one a tensor dim). A no-op
    unless ``cfg.dp_axes`` or ``cfg.tp_axis`` is set, and unless ``x`` is a
    DTensor; else ``x`` redistributed so that each mesh axis the dims name
    shards its dim and every other mesh axis replicates. Where the axes a
    dim names do not divide it, the longest divisible prefix of them is
    kept (``shard_axes_torch``): GSPMD pads an uneven dim, DTensor cannot
    view one. ``granule`` (one int a dim) asks each shard to hold whole
    granules: a flat (heads x head_dim) dim that is viewed as heads next
    gives ``head_dim``, so heads that do not divide the axes replicate."""
    if not cfg.dp_axes and not cfg.tp_axis:
        return x
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    layout = tuple(shard_axes_torch(cfg, mesh, logical, x.shape[d],
                                    granule[d] if granule else 1)
                   for d, logical in enumerate(dims))
    placements = placements_of_torch(mesh, layout)
    if placements == tuple(x.placements):
        return x
    return x.redistribute(mesh, placements)


def layout_of_torch(x):
    """A DTensor's layout: a tuple with the mesh axes of each dim."""
    layout = [()] * x.dim()
    for name, pl in zip(x.device_mesh.mesh_dim_names, x.placements):
        if isinstance(pl, Shard):
            layout[pl.dim] += (name,)
    return tuple(layout)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a
    region's input gradients leave it so (DTensor's matmul backward views
    its local gradient, which a transposed one refuses)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


#: the profiler range a region opens is named this prefix and its name:
#: ``launch/collectives.py`` counts the regions a traced step entered
REGION_PREFIX = "local_map: "


def local_region_torch(name: str, fn, layouts_in, layouts_out, *args):
    """``fn(*args)``; when an argument is a DTensor, ``fn`` runs under
    ``local_map`` on each device's shards instead: argument ``i`` is
    redistributed to ``layouts_in[i]`` (a tuple with the mesh axes of each
    dim, or None for an argument passed as it is), a plain tensor argument
    counting as replicated, and output ``j`` is wrapped as a DTensor laid
    out by ``layouts_out[j]``. An argument replicated along a mesh dim that
    splits the work (another argument is sharded along it) gets its
    gradient as a partial sum there: each device's part of it comes from
    its own shard of the work. The call runs in a profiler range named
    ``REGION_PREFIX + name``. On one card (no DTensor) it is
    ``fn(*args)``, bit for bit."""
    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    args = [DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
            if isinstance(a, torch.Tensor) and not isinstance(a, DTensor)
            and lay is not None else a
            for a, lay in zip(args, layouts_in)]
    in_pl = tuple(None if lay is None else placements_of_torch(mesh, lay)
                  for lay in layouts_in)
    split = {i for pl in in_pl if pl is not None for i, p in enumerate(pl)
             if not isinstance(p, Replicate)}
    grad_pl = tuple(None if pl is None else tuple(
        Partial() if i in split and isinstance(p, Replicate) else p
        for i, p in enumerate(pl)) for pl in in_pl)
    out_pl = tuple(placements_of_torch(mesh, lay) for lay in layouts_out)
    if len(out_pl) == 1:
        out_pl = list(out_pl[0])

    def local(*xs):
        return fn(*(_ContiguousGrad.apply(x) if isinstance(x, torch.Tensor)
                    and x.requires_grad else x for x in xs))
    with torch.profiler.record_function(REGION_PREFIX + name):
        return local_map(local, out_pl, in_pl, grad_pl, device_mesh=mesh,
                         redistribute_inputs=True)(*args)


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def promoted_torch(*xs):
    """``xs`` cast to the one dtype jnp promotes them to, for a product.
    ``jnp.einsum`` of a bfloat16 and a float32 array widens the bfloat16
    one (exactly) and multiplies in float32; ``torch.matmul``, ``bmm`` and
    ``einsum`` refuse mixed dtypes, so every product of the model casts
    its operands here first. Between dimensioned tensors of floating
    dtypes jnp and torch promote alike (bfloat16 with float32 gives
    float32); a 0-d tensor does not: a float32 0-d array promotes a
    bfloat16 one in jnp and not in torch (a Python scalar is weak in
    both), so an elementwise site that mixes one casts by hand. A
    weight is cast per product, as the reference's promotion casts it,
    never once up front. On one dtype this returns ``xs`` as they are."""
    dtype = xs[0].dtype
    for x in xs[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    return tuple(x if x.dtype == dtype else x.to(dtype) for x in xs)


def mm_promoted_torch(x, w):
    """``x @ w`` (an activation (..., K) by a weight (K, N), or any
    matmul) in the dtype jnp promotes the two to (``promoted_torch``)."""
    x, w = promoted_torch(x, w)
    return x @ w


#: float8_e4m3fn's overflow edge: the reference's cast (XLA's) rounds
#: |x| <= 464 to at most 448 and makes every larger |x|, inf included, NaN
_E4M3_NAN_ABOVE = 464.0


def to_cache_dtype_torch(x: torch.Tensor, dtype: torch.dtype):
    """``x`` cast into a KV cache's storage dtype bit for bit as the
    reference's ``x.astype(dtype)`` casts it (``repro/serve/engine.py:99``,
    ``repro/models/attention.py:299-315``). torch's float8 casts differ from
    XLA's in two places (ROADMAP P18): into ``float8_e4m3fn`` torch
    saturates an overflowing value to +-448 (0x7e with the sign bit) where
    XLA gives NaN (0x7f with the sign bit), and into ``float8_e5m2`` a NaN
    keeps its low payload bit in torch (0x7f with the sign) where XLA
    writes 0x7e with the sign from float32 and 0x7f without it from
    bfloat16. Both are patched on torch's float8 bytes; any other dtype is
    a plain ``.to()``. Float8 casts read float32 or bfloat16 (another
    floating dtype is widened to float32 first, exactly)."""
    if x.dtype == dtype or dtype not in (torch.float8_e4m3fn,
                                         torch.float8_e5m2):
        return x.to(dtype)
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    out = x.to(dtype).view(torch.uint8)
    if dtype == torch.float8_e4m3fn:
        # saturated 0x7e | sign -> NaN 0x7f | sign; a NaN input fails the
        # test and is already NaN
        out = out | (x.abs() > _E4M3_NAN_ABOVE).to(torch.uint8)
    else:
        keep = 0xfe if x.dtype == torch.float32 else 0x7f
        out = torch.where(torch.isnan(x), out & keep, out)
    return out.view(dtype)


# -- initializers -------------------------------------------------------------

def _truncated_normal(shape, std, dtype, generator, device):
    """N(0, 1) truncated to [-2, 2], times ``std``, drawn in float32 from
    ``generator`` and cast to ``dtype``; left uninitialized when
    ``generator`` is None (the caller loads weights into it)."""
    if generator is None:
        return torch.empty(shape, dtype=dtype, device=device)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (out.mul_(std)).to(dtype)


def dense_init(generator, shape, dtype, in_axis: int = 0, device=None):
    return _truncated_normal(shape, 1.0 / math.sqrt(shape[in_axis]), dtype,
                             generator, device)


def embed_init(generator, shape, dtype, std: float | None = None,
               device=None):
    if std is None:
        std = 1.0 / math.sqrt(shape[-1])     # keeps tied/untied logits O(1)
    return _truncated_normal(shape, std, dtype, generator, device)


# -- norms --------------------------------------------------------------------

class RMSNorm(torch.nn.Module):
    """``scale`` is stored as zeros and applied as ``1 + scale`` in
    float32, as the reference stores it (``common.py:60-68``)."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.scale = torch.nn.Parameter(
            torch.zeros((dim,), dtype=dtype, device=device),
            requires_grad=False)

    def forward(self, x):
        return rmsnorm(self.scale, x, self.eps)


def rmsnorm(scale, x, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


# -- activations --------------------------------------------------------------

def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "swiglu": F.silu,
            "geglu": _gelu_tanh}[name]


# -- RoPE ---------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, D); positions: (B, S) int. Rotates the two *halves* of
    the head dim (not interleaved pairs), in float32."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)      # (D/2,)
    angles = positions[..., None].float() * freqs                # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections):
    """Multimodal RoPE (Qwen2-VL, arXiv:2409.12191), as the reference's
    ``apply_mrope``: x (B, S, H, D); positions (3, B, S) int, the
    temporal, height and width ids. ``sections`` (summing to D/2) split the
    half dim's frequency slots, and each slot rotates by its section's
    component. The reference picks the component with a one-hot sum (the
    other terms are x 0); a gather picks the same product, so the angles
    are bit for bit the reference's, and with t == h == w ``apply_rope``'s.
    """
    d_half = x.shape[-1] // 2
    if sum(sections) != d_half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {d_half}")
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)      # (D/2,)
    # (B, S, D/2): each frequency slot's component, section by section
    pos = torch.cat([positions[c, :, :, None].expand(-1, -1, n)
                     for c, n in enumerate(sections)], dim=-1).float()
    angles = pos * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
