"""Fixed-order slot sums: each output row adds the rows its slots name, one
after another in ascending slot order.

Counterpart of the JAX package's gather-sum edge conv composition
(``ops/edge_conv.py:557`` ``_conv_gather`` / ``:579`` ``_slot_sum_tiered``)
and of its kernel gradient's in-order tile sum (``:662`` in
``_chunk_bwd_step``): every edge's product is computed first, in tile
order, and each output row then sums its own slots. Row r owns
``slots[ptr[r]:ptr[r + 1]]`` (int32, ascending global slot positions); a
call adds those in the chunk's range [s0, s1):

    acc = out[r];  for s in order: acc += P[s - s0];  out[r] = acc

(``slot_sum``), or ``acc += x[rows[s]]`` (``slot_sum_rows``: sum pooling,
which has no products), or, where every row's slots are a run of
consecutive positions, the run ``[ptr[r], ptr[r + 1])`` itself with no slot
list (``slot_sum_runs``: the kernel gradient, a row an offset over its
tiles). Every sum is in f32 (f64 on the CPU's parity path) and follows
exactly that sequence, so a row's bits depend only on the map and the
values: not on how the slots are chunked, on the stream or on the thread
schedule.

The kernels are ``csrc/slot_sum.cu``: a by-row kernel (``slot_sum``,
``slot_sum_rows``) and a runs kernel (``slot_sum_runs``). The wrappers
launch them on CUDA tensors (f32 only; anything else raises) and take the
plain versions only for CPU tensors. The plain versions add in the same
sequence (``slot_sum_runs_plain`` is ``slot_sum_plain`` over the slots
``arange(ptr[-1])``). On the card (where ``chip_smoke.py`` holds the
kernels to them bit for bit) round j adds each row's j-th slot in the
chunk, one ``index_add_`` a round, whose targets are unique, so the card's
atomic adds give one result too; for a conv map a row holds at most one
slot an offset and its slots ascend with the offset, so this is the
per-offset loop ``for k: out[dst_k] += P_k``. On the CPU, whose
``index_add_`` adds in index order, one call over the chunk's slots in slot
order gives that sequence at the cost of one pass.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build

_INT32_MAX = 2 ** 31 - 1


def _by_rounds(out, src, rows, s0, s1, ptr, slots):
    """Round j adds each row's j-th slot in the chunk: one index_add_ a
    round, whose targets are unique, so the card's atomic adds give one
    result too."""
    ptr, slots = ptr.long(), slots.long()

    def first_at_least(v: int) -> torch.Tensor:
        """Each row's first list position whose slot is >= v (slots ascend
        within a row, so those below v come first)."""
        below = torch.cumsum((slots < v).long(), 0)
        below = torch.cat([below.new_zeros(1), below])
        return ptr[:-1] + below[ptr[1:]] - below[ptr[:-1]]

    lo = first_at_least(s0)
    n = first_at_least(s1) - lo  # each row's slots in the chunk
    every = torch.arange(n.shape[0], device=n.device)
    for j in range(int(n.max()) if n.numel() else 0):
        r = every[n > j]  # the rows with a j-th slot in the chunk
        s = slots[lo[r] + j]
        take = s - s0 if rows is None else rows[s]
        out.index_add_(0, r, src.index_select(0, take))
    return out


def _in_slot_order(out, src, rows, s0, s1, ptr, slots):
    """One index_add_ over the chunk's slots in slot order. The CPU's
    index_add_ adds in index order, so each row takes its slots one after
    another in ascending order: the rounds' sequence, in one pass (the
    tests hold the two forms bit for bit)."""
    n_rows = ptr.shape[0] - 1
    ptr, slots = ptr.long(), slots.long()
    row = torch.repeat_interleave(torch.arange(n_rows), ptr[1:] - ptr[:-1])
    inside = (slots >= s0) & (slots < s1)
    dst = torch.full((s1 - s0,), n_rows, dtype=torch.long)  # n_rows: no row
    dst[slots[inside] - s0] = row[inside]
    if rows is None:
        work = torch.cat([out[:n_rows], out.new_zeros((1, out.shape[1]))])
        work.index_add_(0, dst, src)
        out[:n_rows] = work[:n_rows]
    else:  # padding slots' rows lie outside x: take the listed slots only
        s = torch.nonzero(dst < n_rows).squeeze(1)
        out.index_add_(0, dst[s], src.index_select(0, rows[s0 + s]))
    return out


def _plain(out, src, rows, s0, s1, ptr, slots):
    if out.is_cuda:
        return _by_rounds(out, src, rows, s0, s1, ptr, slots)
    return _in_slot_order(out, src, rows, s0, s1, ptr, slots)


def slot_sum_plain(out, P, s0, ptr, slots):
    return _plain(out, P, None, s0, s0 + P.shape[0], ptr, slots)


def slot_sum_rows_plain(out, x, rows, s0, s1, ptr, slots):
    return _plain(out, x, rows, s0, s1, ptr, slots)


def slot_sum_runs_plain(out, P, s0, ptr):
    """``slot_sum_plain`` with each row's run as its slot list."""
    slots = torch.arange(int(ptr[-1]), dtype=torch.int32, device=ptr.device)
    return slot_sum_plain(out, P, s0, ptr, slots)


def _check(out, src, rows, s0, s1, ptr, slots) -> None:
    """Types first, so that a wrong type raises on any device; ``slots``
    None: the runs form."""
    if out.dtype != torch.float32 or src.dtype != torch.float32:
        raise TypeError(f"slot_sum takes f32 on the card, got {out.dtype} and "
                        f"{src.dtype} (the f64 parity path runs on the CPU)")
    if ptr.dtype != torch.int32 or (slots is not None and slots.dtype != torch.int32) or (
            rows is not None and rows.dtype != torch.int64):
        raise TypeError("slot_sum: ptr and slots are int32, rows int64")
    tensors = [t for t in (out, src, ptr, slots, rows) if t is not None]
    if not all(t.is_cuda and t.device == out.device for t in tensors):
        raise ValueError("slot_sum: every tensor must lie on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("slot_sum takes contiguous tensors")
    if out.dim() != 2 or src.dim() != 2 or out.shape[1] != src.shape[1]:
        raise ValueError(f"slot_sum: out {tuple(out.shape)} and source "
                         f"{tuple(src.shape)} must be [rows, C] alike")
    if out.shape[0] < ptr.shape[0] - 1:
        raise ValueError(f"slot_sum: {ptr.shape[0] - 1} rows' slot lists for "
                         f"an output of {out.shape[0]} rows")
    n_slots = 0 if slots is None else slots.shape[0]
    if max(n_slots, s1, s0) > _INT32_MAX or min(s0, s1) < 0:
        raise ValueError("slot_sum: slot positions must fit int32")


def _lib():
    lib = cuda_build.load("slot_sum")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn, args in ((lib.dgr_slot_sum, [p, i, i, p, p, i, i, p, p]),
                     (lib.dgr_slot_sum_rows, [p, p, i, i, p, p, i, i, p, p]),
                     (lib.dgr_slot_sum_runs, [p, i, i, p, i, i, p, p])):
        if fn.argtypes is None:  # argtypes last: set means all set
            fn.restype = ctypes.c_int
            fn.argtypes = args
    return lib


def _launch(name: str, *args) -> None:
    """Call the C entry point with each tensor's address; the last argument
    is ``out``, whose device the launch runs on."""
    with torch.cuda.device(args[-1].device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        err = getattr(_lib(), name)(*ptrs, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def slot_sum_cuda(out, P, s0, ptr, slots):
    """Launch ``dgr_slot_sum`` on the current stream: out += P's rows."""
    s1 = s0 + P.shape[0]
    _check(out, P, None, s0, s1, ptr, slots)
    n_rows, c = ptr.shape[0] - 1, out.shape[1]
    if n_rows > 0 and c > 0 and s1 > s0:
        _launch("dgr_slot_sum", P, s0, s1, ptr, slots, n_rows, c, out)
        cuda_build.count_launch(slot_sum_cuda)
    return out


def slot_sum_rows_cuda(out, x, rows, s0, s1, ptr, slots):
    """Launch ``dgr_slot_sum_rows`` on the current stream: out += x's rows."""
    _check(out, x, rows, s0, s1, ptr, slots)
    n_rows, c = ptr.shape[0] - 1, out.shape[1]
    if n_rows > 0 and c > 0 and s1 > s0:
        _launch("dgr_slot_sum_rows", x, rows, s0, s1, ptr, slots, n_rows, c, out)
        cuda_build.count_launch(slot_sum_rows_cuda)
    return out


def slot_sum_runs_cuda(out, P, s0, ptr):
    """Launch ``dgr_slot_sum_runs`` on the current stream: out += P's rows
    over each row's run."""
    s1 = s0 + P.shape[0]
    _check(out, P, None, s0, s1, ptr, None)
    n_rows, c = ptr.shape[0] - 1, out.shape[1]
    if n_rows > 0 and c > 0 and s1 > s0:
        _launch("dgr_slot_sum_runs", P, s0, s1, ptr, n_rows, c, out)
        cuda_build.count_launch(slot_sum_runs_cuda)
    return out


slot_sum_cuda.launches = 0
slot_sum_rows_cuda.launches = 0
slot_sum_runs_cuda.launches = 0


def slot_sum(out: torch.Tensor, P: torch.Tensor, s0: int, ptr: torch.Tensor,
             slots: torch.Tensor) -> torch.Tensor:
    """out [>= R, C] += P [S, C] through the slot lists, in place: row r adds
    ``P[s - s0]`` for each of its slots s in [s0, s0 + S), in ascending
    order; ptr [R + 1] and slots int32. Returns out."""
    if out.is_cuda or P.is_cuda:
        return slot_sum_cuda(out, P, s0, ptr, slots)
    return slot_sum_plain(out, P, s0, ptr, slots)


def slot_sum_rows(out: torch.Tensor, x: torch.Tensor, rows: torch.Tensor,
                  s0: int, s1: int, ptr: torch.Tensor,
                  slots: torch.Tensor) -> torch.Tensor:
    """out [>= R, C] += x [N, C] through the slot lists, in place: row r adds
    ``x[rows[s]]`` (rows int64) for each of its slots s in [s0, s1), in
    ascending order. Returns out."""
    if out.is_cuda or x.is_cuda:
        return slot_sum_rows_cuda(out, x, rows, s0, s1, ptr, slots)
    return slot_sum_rows_plain(out, x, rows, s0, s1, ptr, slots)


def slot_sum_runs(out: torch.Tensor, P: torch.Tensor, s0: int,
                  ptr: torch.Tensor) -> torch.Tensor:
    """out [>= R, C] += P [S, C] over runs, in place: row r adds ``P[s - s0]``
    for each s in [ptr[r], ptr[r + 1]) within [s0, s0 + S), in ascending
    order; ptr [R + 1] int32, ascending. Returns out."""
    if out.is_cuda or P.is_cuda:
        return slot_sum_runs_cuda(out, P, s0, ptr)
    return slot_sum_runs_plain(out, P, s0, ptr)
