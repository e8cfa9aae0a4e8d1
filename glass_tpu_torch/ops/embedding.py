"""The embedding lookup with a gradient summed in a fixed order.

``nn.Embedding``'s CUDA backward sums the cotangent rows of each id in an
order that changes from run to run, so a step over repeated ids (GLASS's
degree ids) is not bit-reproducible. JAX's gradient of the lookup is XLA's
scatter-add, which does not vary. :class:`FixedOrderEmbedding` is the
port's counterpart: its forward is ``table.index_select(0, ids)``; its
backward sums in an order that depends on the ids alone, in two levels
with no atomics:

1. the rows, sorted stably by id (``perm``), are cut into chunks of
   ``CHUNK`` rows; each chunk sums each run of one id inside it, row after
   row in sorted order, into one partial per (chunk, run);
2. each id sums its partials in chunk order, from 0.

:func:`embedding_order` builds that order once per id vector, on its
device (one host sync: it sizes the partials), and :func:`embedding`
keeps it per id tensor (:func:`cached_order`), so a training step builds
it on its first, eager call and a captured step finds it. The partials'
workspace is allocated with the order, per width, on the forward that
first needs it, so the backward allocates nothing but its result and
syncs nothing inside a capture.

A CUDA cotangent goes to the hand-written kernel of
``csrc/embedding_bwd.cu`` (two launches, built at first use) or raises; a
CPU one to the plain version :func:`embedding_backward_reference`, the
same two levels in plain PyTorch (the same additions in the same order).
``embedding_backward.launches`` counts the kernel's calls (two launches
each). The sums are f32 for f32 and bf16 cotangents.
"""

from __future__ import annotations

import ctypes
import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

CHUNK = 256  # sorted rows a chunk: the split depends on the ids alone
MAX_ROWS = (1 << 31) - 1  # int32 row indices
G_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/embedding_bwd.cu


@dataclass(eq=False)
class EmbeddingOrder:
    """The fixed summation order of one id vector over an ``n_ids`` table.

    Attributes:
      n_ids, n_rows: the table's rows and the ids'.
      perm:       (n_rows,) int32, a stable argsort of the ids.
      sorted_ids: (n_rows,) int32, ids[perm].
      offsets:    (n_ids + 1,) int64, each id's first row in sorted order.
      part_start: (n_chunks + 1,) int32, each chunk's first partial.
      id_part:    (n_ids + 1,) int32, each id's first partial.
      n_partials: the (chunk, id run) pairs.
      workspace:  width -> the (n_partials, width) f32 partials.
    """

    n_ids: int
    n_rows: int
    perm: torch.Tensor
    sorted_ids: torch.Tensor
    offsets: torch.Tensor
    part_start: torch.Tensor
    id_part: torch.Tensor
    n_partials: int
    workspace: Dict[int, torch.Tensor] = field(default_factory=dict)

    @property
    def n_chunks(self) -> int:
        return -(-self.n_rows // CHUNK)

    @property
    def device(self) -> torch.device:
        return self.perm.device

    def partials(self, width: int) -> torch.Tensor:
        """The partials' workspace of ``width`` columns, allocated on first
        use, never inside a capture."""
        ws = self.workspace.get(width)
        if ws is None:
            _refuse_under_capture(self.device, "allocate the embedding "
                                  "backward's workspace")
            ws = torch.empty((self.n_partials, width), dtype=torch.float32,
                             device=self.device)
            self.workspace[width] = ws
        return ws


def _refuse_under_capture(device: torch.device, what: str) -> None:
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"cannot {what} while a CUDA graph captures: run "
                           f"the step once eagerly first")


def run_starts(sorted_ids: torch.Tensor) -> torch.Tensor:
    """(n_rows,) bool: where a partial starts among the sorted rows, at
    every chunk's first row and at every change of id."""
    starts = torch.ones(sorted_ids.shape[0], dtype=torch.bool,
                        device=sorted_ids.device)
    if sorted_ids.shape[0] > 1:
        starts[1:] = sorted_ids[1:] != sorted_ids[:-1]
    starts[::CHUNK] = True
    return starts


def embedding_order(ids: torch.Tensor, n_ids: int) -> EmbeddingOrder:
    """The order of :func:`embedding`'s backward over ``ids`` (any shape,
    integer, each in [0, n_ids)), on ids' device. Raises ``ValueError`` on
    an id out of range."""
    if ids.dtype.is_floating_point or ids.dtype == torch.bool:
        raise ValueError(f"ids must be integers, got {ids.dtype}")
    if n_ids < 1:
        raise ValueError(f"n_ids {n_ids} must be positive")
    flat = ids.reshape(-1)
    n_rows = flat.shape[0]
    if n_rows > MAX_ROWS:
        raise ValueError(f"{n_rows} ids: the order indexes rows in int32")
    dev = flat.device
    if n_rows and (int(flat.min()) < 0 or int(flat.max()) >= n_ids):
        raise ValueError(f"ids must lie in [0, {n_ids})")
    sorted_ids, perm = torch.sort(flat.long(), stable=True)
    counts = torch.bincount(sorted_ids, minlength=n_ids)
    offsets = torch.zeros(n_ids + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=offsets[1:])
    starts = run_starts(sorted_ids)
    slot = torch.cumsum(starts, 0) - 1  # each sorted row's partial
    n_partials = int(slot[-1]) + 1 if n_rows else 0
    # a partial starts at every id's first row, so id k's first partial
    # is the one of row offsets[k] (n_partials past the last row)
    slots = torch.cat([slot, slot.new_tensor([n_partials])])
    part_start = torch.cat([slot[::CHUNK], slots[-1:]])
    id_part = slots[offsets]
    return EmbeddingOrder(
        n_ids=int(n_ids), n_rows=int(n_rows), perm=perm.int(),
        sorted_ids=sorted_ids.int(), offsets=offsets,
        part_start=part_start.int(), id_part=id_part.int(),
        n_partials=n_partials)


# id tensor -> its order: (id of the base tensor, the view's place, n_ids)
# -> (weak reference to the base, its version, the order)
_ORDERS: dict = {}


def cached_order(ids: torch.Tensor, n_ids: int) -> EmbeddingOrder:
    """The order of ``ids`` (a tensor or a view of one), built once per
    tensor and kept while it lives; rebuilt if the tensor was written in
    place. A miss under a CUDA graph's capture raises."""
    base = ids if ids._base is None else ids._base
    key = (id(base), ids.data_ptr(), tuple(ids.shape), tuple(ids.stride()),
           int(n_ids))
    hit = _ORDERS.get(key)
    if hit is not None:
        ref, version, order = hit
        if ref() is base and version == ids._version:
            return order
    _refuse_under_capture(ids.device, "build an embedding order")
    order = embedding_order(ids, n_ids)
    _ORDERS[key] = (weakref.ref(base), ids._version, order)
    weakref.finalize(base, _ORDERS.pop, key, None)
    return order


# ------------------------------------------------------------ plain version


def _sums_in_order(rows: torch.Tensor, first: torch.Tensor,
                   count: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """acc[s] + rows[first[s]] + ... + rows[first[s] + count[s] - 1], the
    adds one at a time, left to right, for every segment s."""
    last = max(rows.shape[0] - 1, 0)
    for k in range(int(count.max()) if count.numel() else 0):
        live = (count > k)[:, None]
        acc = torch.where(live, acc + rows[(first + k).clamp(max=last)], acc)
    return acc


def chunk_partials_reference(order: EmbeddingOrder,
                             g: torch.Tensor) -> torch.Tensor:
    """Level 1 in plain PyTorch: the (n_partials, H) f32 partials of the
    (n_rows, H) cotangent ``g``, each run of one id inside a chunk summed
    row after row in sorted order, from its first row."""
    gs = g.index_select(0, order.perm.long()).float()
    first = torch.nonzero(run_starts(order.sorted_ids))[:, 0]
    count = torch.diff(first, append=first.new_tensor([order.n_rows]))
    return _sums_in_order(gs, first + 1, count - 1, gs[first])


def id_sums_reference(order: EmbeddingOrder,
                      partials: torch.Tensor) -> torch.Tensor:
    """Level 2 in plain PyTorch: the (n_ids, H) f32 table gradient, each
    id's partials added in chunk order, from 0."""
    first = order.id_part[:-1].long()
    zero = torch.zeros((order.n_ids, partials.shape[1]), dtype=torch.float32,
                       device=partials.device)
    return _sums_in_order(partials, first, order.id_part[1:].long() - first,
                          zero)


def embedding_backward_reference(order: EmbeddingOrder,
                                 g: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`embedding_backward`: (n_ids, H) f32."""
    g = _check_cotangent(order, g)
    if order.n_rows == 0:
        return torch.zeros((order.n_ids, g.shape[1]), dtype=torch.float32,
                           device=g.device)
    return id_sums_reference(order, chunk_partials_reference(order, g))


# ------------------------------------------------------------------ kernel


def _check_cotangent(order: EmbeddingOrder, g: torch.Tensor) -> torch.Tensor:
    if g.dtype not in G_DTYPES:
        raise ValueError(f"the cotangent must be float32 or bfloat16, got "
                         f"{g.dtype}")
    if g.device != order.device:
        raise ValueError(f"the cotangent lies on {g.device}, the order on "
                         f"{order.device}")
    g = g.reshape(order.n_rows, -1)
    return g if g.is_contiguous() else g.contiguous()


_LIB: Optional[ctypes.CDLL] = None


def _kernel() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from glass_tpu_torch.ops import _build

        lib = _build.load("embedding_bwd")
        fn = lib.glass_embedding_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        _LIB = lib
    return _LIB


def embedding_backward(order: EmbeddingOrder,
                       g: torch.Tensor) -> torch.Tensor:
    """The (n_ids, H) f32 gradient of the table for the (n_rows, H)
    cotangent ``g`` of :func:`embedding`'s output, in the fixed order: the
    kernel on a CUDA tensor, the plain version on a CPU one."""
    g = _check_cotangent(order, g)
    if g.device.type == "cpu":
        return embedding_backward_reference(order, g)
    h = g.shape[1]
    out = torch.empty((order.n_ids, h), dtype=torch.float32, device=g.device)
    if order.n_rows == 0:
        return out.zero_()
    partials = order.partials(h)
    with torch.cuda.device(g.device):
        rc = _kernel().glass_embedding_bwd(
            g.data_ptr(), G_DTYPES[g.dtype], order.perm.data_ptr(),
            order.sorted_ids.data_ptr(), order.part_start.data_ptr(),
            order.id_part.data_ptr(), partials.data_ptr(), out.data_ptr(),
            order.n_rows, CHUNK, order.n_chunks, order.n_ids, h,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"embedding backward kernel launch failed: CUDA "
                           f"error {rc}")
    embedding_backward.launches += 1
    return out


embedding_backward.launches = 0


class FixedOrderEmbedding(torch.autograd.Function):
    """``table.index_select(0, ids)`` for 1-D ``ids``; the table's gradient
    is :func:`embedding_backward` over ``order`` (ids' order), cast to the
    table's dtype. The ids get no gradient."""

    @staticmethod
    def forward(ctx, table, ids, order):
        ctx.order, ctx.dtype = order, table.dtype
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        return embedding_backward(ctx.order, g).to(ctx.dtype), None, None


def embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, table)`` whose table gradient is summed in the
    fixed order (module docstring); ids of any shape. Without a gradient
    to take, the plain gather."""
    flat = ids.reshape(-1)
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table.index_select(0, flat).view(*ids.shape, table.shape[1])
    order = cached_order(ids, table.shape[0])
    if table.device.type == "cuda":
        order.partials(table.shape[1])
    out = FixedOrderEmbedding.apply(table, flat, order)
    return out.view(*ids.shape, table.shape[1])
