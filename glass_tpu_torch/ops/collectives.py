"""The collectives of the sharded paths, over ``torch.distributed`` process
groups, and their autograd rules.

Counterpart of the ``jax.lax`` collectives that ``glass_tpu`` calls inside
``shard_map`` (``all_gather``, ``psum``, ``pmax``, ``ppermute``). A group
is a ``torch.distributed`` process group with one rank per device; ``None``
stands for a one-rank axis with no process group, where every collective is
the identity.

Transport: NCCL takes CUDA tensors and gloo CPU tensors. A gloo group with
CUDA tensors (several ranks sharing one card, where NCCL refuses two ranks
of one communicator on one device) moves each operand to the host and the
result back around the call: the group's backend chooses this
(:func:`transport`), never a caught failure. The computation and every
kernel stay on the tensors' device.

Autograd, as JAX transposes its collectives: the tiled all-gather's
backward is a reduce-scatter (sum), the all-reduce sum's backward an
all-reduce sum of the cotangents, and the ring shift's backward the shift
in the other direction.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
import torch.distributed as dist


def group_size(group) -> int:
    """Ranks in ``group`` (1 for ``None``)."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's rank in ``group`` (0 for ``None``)."""
    return 0 if group is None else dist.get_rank(group)


def transport(group, device: torch.device) -> str:
    """"host" where the group's backend is gloo and the tensors lie on a
    card (each operand is copied to the host and back), else "device"."""
    if group is not None and device.type == "cuda" \
            and dist.get_backend(group) == "gloo":
        return "host"
    return "device"


def _out(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the collective takes it: contiguous, on the host under the
    host transport."""
    if transport(group, t.device) == "host":
        return t.detach().to("cpu").contiguous()
    return t.detach().contiguous()


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' (n, ...) blocks stacked in rank order: (K*n, ...)."""
    if group is None:
        return x
    xs = _out(x, group)
    out = xs.new_empty((group_size(group) * xs.shape[0],)
                       + tuple(xs.shape[1:]))
    with warnings.catch_warnings():  # renamed all_gather_single in 2.13
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, xs, group=group)
    return out.to(x.device)


def reduce_scatter_rows(g: torch.Tensor, group) -> torch.Tensor:
    """The sum over ranks of the (K*n, ...) tensors, this rank's (n, ...)
    block of it."""
    if group is None:
        return g
    gs = _out(g, group)
    out = gs.new_empty((gs.shape[0] // group_size(group),)
                       + tuple(gs.shape[1:]))
    with warnings.catch_warnings():  # renamed reduce_scatter_single in 2.13
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, gs, op=dist.ReduceOp.SUM,
                                   group=group)
    return out.to(g.device)


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The elementwise sum ("sum") or maximum ("max") over ranks, a new
    tensor on ``t``'s device."""
    if group is None:
        return t.clone()
    host = transport(group, t.device) == "host"
    ts = t.detach().to("cpu" if host else t.device, copy=True).contiguous()
    dist.all_reduce(ts, op={"sum": dist.ReduceOp.SUM,
                            "max": dist.ReduceOp.MAX}[op], group=group)
    return ts.to(t.device)


def shift(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """Rank r sends x to rank r - step and receives rank (r + step)'s x
    (mod K), through one ``dist.batch_isend_irecv``: JAX's ``ppermute`` with
    the permutation [(j, j - step)]."""
    k = group_size(group)
    if group is None or k == 1:
        return x
    r = group_rank(group)
    to = dist.get_global_rank(group, (r - step) % k)
    frm = dist.get_global_rank(group, (r + step) % k)
    xs = _out(x, group)
    buf = torch.empty_like(xs)
    ops = [dist.P2POp(dist.isend, xs, to, group),
           dist.P2POp(dist.irecv, buf, frm, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return buf.to(x.device)


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Overwrites ``t`` in place with global rank ``src``'s values over
    ``group`` (the default group for None; nothing without a process
    group)."""
    if not dist.is_initialized():
        return t
    host = transport(group or dist.group.WORLD, t.device) == "host"
    ts = t.detach().to("cpu" if host else t.device, copy=True).contiguous()
    dist.broadcast(ts, src=src, group=group)
    with torch.no_grad():
        t.copy_(ts)
    return t


class GatherRows(torch.autograd.Function):
    """Tiled all-gather; backward: reduce-scatter (sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_rows(g.contiguous(), ctx.group), None


class AllReduceSum(torch.autograd.Function):
    """All-reduce (sum); backward: all-reduce (sum) of the cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group, "sum")

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group, "sum"), None


class Shift(torch.autograd.Function):
    """:func:`shift` by one; backward: the shift the other way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return shift(g.contiguous(), ctx.group, -1), None


def gather_rows(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """Differentiable tiled all-gather over ``group`` (identity for None)."""
    return x if group is None else GatherRows.apply(x, group)


def sum_over(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """Differentiable all-reduce (sum) over ``group`` (identity for None)."""
    return x if group is None else AllReduceSum.apply(x, group)


def ring_shift(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """Differentiable one-step ring shift over ``group`` (identity for
    None)."""
    return x if group is None else Shift.apply(x, group)
