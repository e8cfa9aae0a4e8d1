"""The embedding lookup with a gradient summed in a fixed order.

``nn.Embedding``'s CUDA backward sums the cotangent rows of each id in an
order that changes from run to run, so a step over repeated ids (GLASS's
degree ids) is not bit-reproducible. JAX's gradient of the lookup is XLA's
scatter-add, which does not vary. :class:`FixedOrderEmbedding` is the
port's counterpart: its forward is ``table.index_select(0, ids)``; its
backward sums in an order that depends on the ids alone, in three levels
with no atomics on the data. The rows, sorted stably by id (``perm``), are
cut into slices of :func:`slice_rows_for` rows (a function of the row
count alone) and the slices into chunks of ``SLICES``; then

1. each slice sums each run of one id inside it, row after row in sorted
   order, from its first row, into a piece;
2. each chunk sums each id's pieces in slice order, from the first piece,
   into one partial per (chunk, run of one id), numbered in sorted order;
3. each id cuts its partials, in chunk order, into ``SEGMENTS`` segments
   of ceil(count / SEGMENTS) (the last ones shorter or empty), sums each
   from 0 and adds the segment sums in order, from 0.

:func:`embedding_order` builds that order once per id vector, on its
device (one host sync: it sizes the partials), and :func:`embedding`
keeps it per id tensor (:func:`cached_order`), so a training step builds
it on its first, eager call and a captured step finds it. The workspace
(the partials and a ticket counter per id, all 0 at rest) is allocated
with the order, per width, on the forward that first needs it, so the
backward allocates nothing but its result and syncs nothing inside a
capture.

A CUDA cotangent goes to the hand-written kernel of
``csrc/embedding_bwd.cu`` (one launch: the id level folded in by a ticket
per id, built at first use) or raises; a CPU one to the plain version
:func:`embedding_backward_reference`, the same three levels in plain
PyTorch (the same additions in the same order).
``embedding_backward.launches`` counts the kernel's calls. The sums are
f32 for f32 and bf16 cotangents.
"""

from __future__ import annotations

import struct
import weakref
from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch

from glass_tpu_torch.ops import _build
from glass_tpu_torch.ops._common import on_card

SLICES = 16  # slices a chunk (csrc/embedding_bwd.cu SLICES)
SEGMENTS = 16  # segments of an id's partials (csrc/embedding_bwd.cu)
MIN_SLICE_ROWS, MAX_SLICE_ROWS = 8, 64  # MAX: the kernel's MAX_SLICE
TARGET_CHUNKS = 256  # chunks slice_rows_for aims at: hundreds of CTAs
MAX_ROWS = (1 << 31) - 1  # int32 row indices
G_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/embedding_bwd.cu
VEC = {torch.float32: 4, torch.bfloat16: 8}  # columns in 16 bytes
MAX_LANES = 32  # vector columns a CTA (csrc/embedding_bwd.cu MAX_LANES)


def slice_rows_for(n_rows: int) -> int:
    """The rows of a slice for ``n_rows`` ids: the least power of two from
    MIN_SLICE_ROWS to MAX_SLICE_ROWS that cuts the rows into at most
    TARGET_CHUNKS chunks. It depends on the row count alone."""
    s = MIN_SLICE_ROWS
    while s < MAX_SLICE_ROWS and -(-n_rows // (SLICES * s)) > TARGET_CHUNKS:
        s *= 2
    return s


@dataclass(eq=False)
class EmbeddingOrder:
    """The fixed summation order of one id vector over an ``n_ids`` table.

    Attributes:
      n_ids, n_rows: the table's rows and the ids'.
      slice_rows: slice_rows_for(n_rows), the rows of a slice (a chunk is
                  SLICES slices).
      perm:       (n_rows,) int32, a stable argsort of the ids.
      sorted_ids: (n_rows,) int32, ids[perm].
      offsets:    (n_ids + 1,) int64, each id's first row in sorted order.
      slice_part: (n_slices + 1,) int32, the partial that each slice's first
                  row lies in; n_partials last.
      part_info:  (n_partials, 4) int32, each partial's id, that id's first
                  partial and partial count, and the first of the ids
                  without rows just before it (the kernel's ticket and
                  finish facts).
      id_part:    (n_ids + 1,) int32, each id's first partial.
      last_id:    the largest id with rows (-1 without rows).
      n_partials: the (chunk, id run) pairs.
      workspace:  width -> the (n_partials, width) f32 partials and the
                  (n_ids * ceil(width / MAX_LANES),) int32 tickets, 0.
    """

    n_ids: int
    n_rows: int
    slice_rows: int
    perm: torch.Tensor
    sorted_ids: torch.Tensor
    offsets: torch.Tensor
    slice_part: torch.Tensor
    part_info: torch.Tensor
    id_part: torch.Tensor
    last_id: int
    n_partials: int
    workspace: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = field(
        default_factory=dict)

    @property
    def chunk_rows(self) -> int:
        return SLICES * self.slice_rows

    @property
    def n_chunks(self) -> int:
        return -(-self.n_rows // self.chunk_rows)

    @property
    def device(self) -> torch.device:
        return self.perm.device

    def buffers(self, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (partials, tickets) workspace of ``width`` columns, allocated
        on first use, never inside a capture. The kernel leaves every
        ticket at 0."""
        ws = self.workspace.get(width)
        if ws is None:
            _refuse_under_capture(self.device, "allocate the embedding "
                                  "backward's workspace")
            ws = (torch.empty((self.n_partials, width), dtype=torch.float32,
                              device=self.device),
                  torch.zeros(self.n_ids * -(-width // MAX_LANES),
                              dtype=torch.int32, device=self.device))
            self.workspace[width] = ws
        return ws


def _refuse_under_capture(device: torch.device, what: str) -> None:
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"cannot {what} while a CUDA graph captures: run "
                           f"the step once eagerly first")


def run_starts(sorted_ids: torch.Tensor, every: int) -> torch.Tensor:
    """(n_rows,) bool: where a sum starts among the sorted rows, at every
    ``every``-th row and at every change of id."""
    starts = torch.ones(sorted_ids.shape[0], dtype=torch.bool,
                        device=sorted_ids.device)
    if sorted_ids.shape[0] > 1:
        starts[1:] = sorted_ids[1:] != sorted_ids[:-1]
    starts[::every] = True
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
    s = slice_rows_for(n_rows)
    dev = flat.device
    if n_rows and (int(flat.min()) < 0 or int(flat.max()) >= n_ids):
        raise ValueError(f"ids must lie in [0, {n_ids})")
    sorted_ids, perm = torch.sort(flat.long(), stable=True)
    counts = torch.bincount(sorted_ids, minlength=n_ids)
    offsets = torch.zeros(n_ids + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=offsets[1:])
    starts = run_starts(sorted_ids, SLICES * s)
    slot = torch.cumsum(starts, 0) - 1  # each sorted row's partial
    n_partials = int(slot[-1]) + 1 if n_rows else 0
    # a partial starts at every id's first row, so id k's first partial
    # is the one of row offsets[k] (n_partials past the last row)
    slots = torch.cat([slot, slot.new_tensor([n_partials])])
    slice_part = torch.cat([slot[::s], slots[-1:]])
    id_part = slots[offsets]
    part_id = sorted_ids[starts]
    # each partial's id among the ids with rows, and the id before it
    new_id = torch.ones_like(part_id, dtype=torch.bool)
    new_id[1:] = part_id[1:] != part_id[:-1]
    rank = torch.cumsum(new_id, 0) - 1
    with_rows = part_id[new_id]
    zero_lo = torch.cat([with_rows.new_zeros(1), with_rows[:-1] + 1])
    part_info = torch.stack([part_id, id_part[part_id],
                             id_part[part_id + 1] - id_part[part_id],
                             zero_lo[rank]], 1)
    return EmbeddingOrder(
        n_ids=int(n_ids), n_rows=int(n_rows), slice_rows=s, perm=perm.int(),
        sorted_ids=sorted_ids.int(), offsets=offsets,
        slice_part=slice_part.int(), part_info=part_info.int().contiguous(),
        id_part=id_part.int(),
        last_id=int(sorted_ids[-1]) if n_rows else -1,
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


def _runs_from_first(rows: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Each run of ``rows`` that ``starts`` (bool, one a row) opens, summed
    from its first row, left to right."""
    first = torch.nonzero(starts)[:, 0]
    count = torch.diff(first, append=first.new_tensor([rows.shape[0]]))
    return _sums_in_order(rows, first + 1, count - 1, rows[first])


def slice_pieces_reference(order: EmbeddingOrder,
                           g: torch.Tensor) -> torch.Tensor:
    """Level 1 in plain PyTorch: the f32 pieces of the (n_rows, H)
    cotangent ``g``, each run of one id inside a slice summed row after row
    in sorted order, from its first row; in sorted order."""
    gs = g.index_select(0, order.perm.long()).float()
    return _runs_from_first(gs, run_starts(order.sorted_ids,
                                           order.slice_rows))


def chunk_partials_reference(order: EmbeddingOrder,
                             g: torch.Tensor) -> torch.Tensor:
    """Levels 1 and 2 in plain PyTorch: the (n_partials, H) f32 partials,
    each id's pieces inside a chunk summed in slice order, from the first
    piece. A piece opens a partial where its first row opens a chunk or an
    id."""
    pieces = slice_pieces_reference(order, g)
    first_row = torch.nonzero(run_starts(order.sorted_ids,
                                         order.slice_rows))[:, 0]
    opens = run_starts(order.sorted_ids, order.chunk_rows)[first_row]
    return _runs_from_first(pieces, opens)


def id_sums_reference(order: EmbeddingOrder,
                      partials: torch.Tensor) -> torch.Tensor:
    """Level 3 in plain PyTorch: the (n_ids, H) f32 table gradient, each
    id's partials cut in chunk order into SEGMENTS segments of
    ceil(count / SEGMENTS), each summed from 0, the segment sums added in
    order from 0."""
    first = order.id_part[:-1].long()
    count = order.id_part[1:].long() - first
    seg = -(-count // SEGMENTS)
    zero = torch.zeros((order.n_ids, partials.shape[1]), dtype=torch.float32,
                       device=partials.device)
    acc = zero
    for s in range(SEGMENTS):
        lo = torch.minimum(s * seg, count)
        hi = torch.minimum(lo + seg, count)
        acc = acc + _sums_in_order(partials, first + lo, hi - lo, zero)
    return acc


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
    if g.dim() != 2 or g.shape[0] != order.n_rows:
        g = g.reshape(order.n_rows, -1)
    return g if g.is_contiguous() else g.contiguous()


# glass_embedding_bwd's one argument, csrc/embedding_bwd.cu Launch: g,
# perm, sorted_ids, slice_part, part_info, partials, tickets, out, stream,
# n_rows; g_bf16, vec, slice_rows, n_ids, last_id, h
_LAUNCH = struct.Struct("<10q6i")


def _vector_columns(g: torch.Tensor) -> int:
    """The columns a lane of the kernel loads at once: 16 bytes (4 f32 or
    8 bf16) where g's rows allow it, else 1."""
    vec = VEC[g.dtype]
    return vec if g.shape[1] % vec == 0 and g.data_ptr() % 16 == 0 else 1


def embedding_backward(order: EmbeddingOrder, g: torch.Tensor) -> torch.Tensor:
    """The (n_ids, H) f32 gradient of the table for the (n_rows, H)
    cotangent ``g`` of :func:`embedding`'s output, in the fixed order: the
    kernel on a CUDA tensor, the plain version on a CPU one."""
    g = _check_cotangent(order, g)
    if not on_card("embedding_backward", g):
        return embedding_backward_reference(order, g)
    h = g.shape[1]
    out = torch.empty((order.n_ids, h), dtype=torch.float32, device=g.device)
    if order.n_rows == 0:
        return out.zero_()
    partials, tickets = order.buffers(h)
    index = g.get_device()
    args = _LAUNCH.pack(
        g.data_ptr(), order.perm.data_ptr(), order.sorted_ids.data_ptr(),
        order.slice_part.data_ptr(), order.part_info.data_ptr(),
        partials.data_ptr(), tickets.data_ptr(), out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(index),
        order.n_rows, G_DTYPES[g.dtype], _vector_columns(g), order.slice_rows,
        order.n_ids, order.last_id, h)
    _build.launch("embedding_backward",
                  _build.load("embedding_bwd").glass_embedding_bwd, index,
                  args)
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
        order.buffers(table.shape[1])
    out = FixedOrderEmbedding.apply(table, flat, order)
    return out.view(*ids.shape, table.shape[1])
