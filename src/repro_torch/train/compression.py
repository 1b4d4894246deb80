"""int8 error-feedback gradient compression: the port of
``repro/train/compression.py`` on tensors.

Before a cross-pod gradient reduction each pod quantizes (grad + residual)
to int8 with one float32 scale a block of ``BLOCK`` values (symmetric,
max|x| / 127, rounded half to even as ``jnp.round``), sends the int8
payload, and keeps the quantization error as the residual for the next
step. On float32 inputs ``q`` and ``scale`` equal the reference's bit for
bit. The functions run on the device of the tensors they are given.

``compressed_cross_pod_mean_torch`` is the reference's
``compressed_cross_pod_mean`` (a ``shard_map`` body over the "pod" axis)
over a ``torch.distributed`` process group, one rank a pod: each rank runs
the error-feedback round on each tensor, the group sums the dequantized
estimates (``all_reduce``) and each rank divides by the group's size. As
in the reference, the sum models the arithmetic; the wire format, int8
payloads with float32 block scales summed after dequantizing on receive,
stays a comment.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 1024


def _blocked_torch(x: torch.Tensor):
    """``x`` flattened, zero-padded to whole blocks, as (blocks, BLOCK);
    and its element count."""
    n = x.numel()
    flat = F.pad(x.reshape(-1), (0, (-n) % BLOCK))
    return flat.reshape(-1, BLOCK), n


def quantize_int8_torch(x: torch.Tensor):
    """x (any shape) -> (q int8 (blocks, BLOCK), scale float32 (blocks, 1),
    meta (shape, n)): symmetric per-block scaling."""
    blocks, n = _blocked_torch(x.float())
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, (tuple(x.shape), n)


def dequantize_int8_torch(q: torch.Tensor, scale: torch.Tensor, meta):
    """The float32 tensor of shape ``meta[0]`` that (q, scale) encode."""
    shape, n = meta
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


def ef_compress_decompress_torch(grad: torch.Tensor, residual: torch.Tensor):
    """One error-feedback round on a single tensor: (the payload's estimate,
    the dequantized int8 the wire carries; the new residual, the error it
    leaves), both float32."""
    target = grad.float() + residual
    q, scale, meta = quantize_int8_torch(target)
    est = dequantize_int8_torch(q, scale, meta)
    return est, target - est


def compressed_cross_pod_mean_torch(grads: dict, residuals: dict,
                                    group=None):
    """(mean, new residuals), name -> float32 tensor dicts: each rank's
    ``grads[name] + residuals[name]`` through one error-feedback round, the
    estimates summed over ``group`` (the default group when None) and
    divided by its size. Raises ``RuntimeError`` when no process group is
    initialised; a group of one rank still runs the collective."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("compressed_cross_pod_mean_torch reduces over a "
                           "process group and none is initialised")
    size = dist.get_world_size(group)
    mean, new_res = {}, {}
    for name, g in grads.items():
        est, new_res[name] = ef_compress_decompress_torch(g, residuals[name])
        # the wire carries int8 q and the block scales; the sum of the
        # dequantized estimates is what the receiving side computes
        dist.all_reduce(est, op=dist.ReduceOp.SUM, group=group)
        mean[name] = est / size
    return mean, new_res


def init_residuals_torch(params):
    """Zero float32 residuals, one beside each tensor of ``params`` (a
    module's named parameters or a name -> tensor dict), on its device."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for name, p in params.items()}


def wire_bytes_ratio_np() -> float:
    """int8 payload + f32/BLOCK scales vs f32 baseline."""
    return (1.0 + 4.0 / BLOCK) / 4.0
