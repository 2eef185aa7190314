"""The collectives of the mesh, and their one transport rule.

Every collective of the port goes through this module. A group of ``None``
is an axis of size 1: each function returns its input. Under NCCL the
tensors go to the collective as they are (a group of ``cpu:gloo,cuda:nccl``
sends CUDA tensors over NCCL and CPU tensors over gloo). Under gloo alone,
which cannot take CUDA tensors for most collectives (``all_to_all``,
``send``/``recv``, ``all_gather``), a CUDA tensor is copied to pinned host
memory, the collective runs there, and the result is copied back to the
tensor's device. That is a transport, not a fallback: the compute stays on the card,
and an error of the collective is raised, never caught. It is how ranks
that share one card (NCCL refuses two ranks on one device) and ranks on the
CPU talk.

The collectives that only move data (gather, all-to-all, the ring shift,
broadcast) send the tensor's bytes (gloo has no int16); the all-reduce adds
in float32 and rounds once to the input's dtype, as one matmul's
accumulator would.

``copy_to_group`` and ``reduce_from_group`` are Megatron's f and g
operators: identity forward / all-reduce backward, and all-reduce forward /
identity backward. A column-parallel layer takes its input through f and a
row-parallel layer gives its partial sums to g, so tensor-parallel training
gets the replicated activations' gradients right on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of ``t`` (waits for the device to produce it)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the group, in float32, returned in ``x``'s dtype."""
    if size(group) == 1:
        return x
    acc = x.float().contiguous()
    if _staged(acc, group):
        host = _host(acc)
        dist.all_reduce(host, group=group)
        acc = host.to(x.device, non_blocking=True)
    else:
        acc = acc.clone() if acc is x else acc
        dist.all_reduce(acc, group=group)
    return acc.to(x.dtype)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim``, in group-rank order."""
    n = size(group)
    if n == 1:
        return x
    wire = _as_bytes(x)
    if _staged(x, group):
        wire = _host(wire)
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat([p.view(x.dtype) for p in parts], dim=dim)
    return out.to(x.device, non_blocking=True)


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: split ``x`` into equal parts
    along ``split_dim``, send part i to group rank i, and concatenate what
    arrives along ``concat_dim`` in group-rank order."""
    n = size(group)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not split into {n}")
    wire = _as_bytes(torch.stack(x.chunk(n, dim=split_dim)))
    if _staged(x, group):
        wire = _host(wire)
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=group)
    parts = out.view(x.dtype).to(x.device, non_blocking=True).unbind(0)
    return torch.cat(parts, dim=concat_dim)


def ring_shift(tensors: list, group) -> list:
    """Send each tensor to the next rank of the group and return what the
    previous rank sent (``jax.lax.ppermute`` with ``i → i+1``)."""
    n = size(group)
    if n == 1:
        return list(tensors)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    staged = _staged(tensors[0], group)
    sends = [_as_bytes(t) for t in tensors]
    if staged:
        sends = [_host(s) for s in sends]
    recvs = [torch.empty_like(s) for s in sends]
    ops = [dist.P2POp(dist.isend, s, nxt, group) for s in sends]
    ops += [dist.P2POp(dist.irecv, r, prv, group) for r in recvs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [
        r.view(t.dtype).to(t.device, non_blocking=True) for r, t in zip(recvs, tensors)
    ]


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank (a new tensor of ``x``'s
    shape, dtype and device). ``group=None`` is the default group here."""
    wire = _as_bytes(x)
    if _staged(x, group):
        wire = _host(wire)
    else:
        wire = wire.clone()
    dist.broadcast(wire, dist.get_global_rank(group, src) if group is not None else src,
                   group=group)
    return wire.view(x.dtype).to(x.device, non_blocking=True)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: the input of a column-parallel layer."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the partial sums of a row-parallel layer, summed."""
    return x if group is None else _ReduceFromGroup.apply(x, group)
