"""Sparse convolution and sum pooling over exact edge maps, plus norms and
nonlinearities.

Counterpart of the JAX package's ``ops/sparse_conv.py:35-184`` and
``ops/edge_conv.py:sparse_conv_edges``:

    out[p] = sum over edges (k, j, p) of  W[k]^T x[j]   (+ bias)

computed as the JAX package's gather-sum composition (``edge_conv.py:557``):
a gather of input rows into single-offset tiles, one batched matmul against
each tile's kernel slice (the edges' products, in tile order), then a slot
sum (``ops/slot_sum.py``, the kernel ``csrc/slot_sum.cu`` on the card) in
which each output row adds its own products one after another in ascending
slot order, that is in ascending offset. The sum's order depends only on
the map: the same call gives the same bits on every run, however the tiles
are chunked, where an atomic ``index_add_`` would sum a row in another
order each time. Arithmetic follows the JAX package's bf16 path: inputs and
weights are rounded to the compute dtype, products and sums run in f32
(TF32 off), and the result is stored in the compute dtype. The JAX path
also rounds each product to the compute dtype before the sum
(``edge_conv.py:571``); the port sums the f32 products.

Gradients reach the features, kernels and biases (the JAX package
differentiates its XLA convs). The conv's backward is written out
(``_SparseConv``) so that it keeps only the conv's input: the input
gradient is the same conv over the input rows' slot lists, the kernel
gradient a slot sum of each tile's g^T dy over its offset's tiles, in tile
order (``slot_sum_runs``: an offset's tiles are one run). Sum pooling
(``_SumPool``) sums rows through the same lists in both directions, and
the instance norm's per-cloud sums are one-hot matmuls. No
accumulation here is atomic: the backward of ``x[idx]`` or of
``index_select`` would be an ``index_add_``, so none is left to autograd.

``tile_counts`` counts, by pass (``forward``, ``dx``, ``dk``), the tile rows
each call launched and the edges among them: every offset with an edge
takes whole tiles, and a padding row costs a row's products like an edge.
"""

from __future__ import annotations

import torch

from ..utils import cuda_build
from .edge_conv import EdgeMap
from .slot_sum import slot_sum, slot_sum_rows, slot_sum_runs

# Tiles per batched matmul: bounds the gathered [chunk, T, Cin] rows and the
# [chunk, Cin, Cout] kernel slices.
_MAX_CHUNK_ELEMS = 1 << 26


class TileCount:
    """What one pass of the conv launched since the last ``reset``: tile
    rows (``tile_rows``, ``tile_k.shape[0] * tile`` a call) and the edges
    among them (``edges``); the rest are padding. Both are host integers,
    so counting waits for nothing."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.tile_rows = self.edges = 0

    def add(self, em: EdgeMap) -> None:
        cuda_build.count_launch(self, em.tile_k.shape[0] * em.tile, "tile_rows")
        cuda_build.count_launch(self, em.n_edges, "edges")


tile_counts = {"forward": TileCount(), "dx": TileCount(), "dk": TileCount()}


def _conv(x: torch.Tensor, kernel: torch.Tensor, em: EdgeMap, src: torch.Tensor,
          dst_ptr: torch.Tensor, dst_slots: torch.Tensor, n_dst: int) -> torch.Tensor:
    """out[r] = the sum of x[src[s]] @ kernel[k(s)] over row r's slots s
    (``dst_ptr`` / ``dst_slots``), in ascending slot order, in x's dtype;
    slots that read row ``x.shape[0]`` read zeros."""
    cin, cout = kernel.shape[1], kernel.shape[2]
    t = em.tile
    x = torch.cat([x, x.new_zeros((1, cin))])
    out = x.new_zeros((n_dst, cout))
    chunk = max(1, _MAX_CHUNK_ELEMS // (cin * (t + cout)))
    for s in range(0, em.tile_k.shape[0], chunk):
        tk = em.tile_k[s:s + chunk]
        rows = slice(s * t, (s + tk.shape[0]) * t)
        g = x.index_select(0, src[rows]).view(-1, t, cin)
        products = torch.bmm(g, kernel.index_select(0, tk)).view(-1, cout)
        slot_sum(out, products, s * t, dst_ptr, dst_slots)
    return out


class _SparseConv(torch.autograd.Function):
    """The conv with a backward that keeps only its input and kernel: the
    gathered rows and the tiles' kernel slices are taken again in backward
    rather than held from the forward (they are the step's largest saved
    tensors). Input gradient: the same conv over the swapped edge lists
    (out -> in, the input rows' slot lists) with W[k]^T; kernel gradient:
    each tile's g^T dy, summed over its offset's tiles in tile order (an
    offset's tiles are contiguous: offset k's slots are the run of its
    tiles, ``k_ptr[k]`` to ``k_ptr[k + 1]``)."""

    @staticmethod
    def forward(ctx, x, kernel, em):
        ctx.em = em
        ctx.save_for_backward(x, kernel)
        tile_counts["forward"].add(em)
        return _conv(x, kernel, em, em.tile_in, em.out_ptr, em.out_slots, em.n_out)

    @staticmethod
    def backward(ctx, dy):
        x, kernel = ctx.saved_tensors
        em = ctx.em
        dy = dy.contiguous()
        dx = dk = None
        if ctx.needs_input_grad[0]:
            tile_counts["dx"].add(em)
            dx = _conv(dy, kernel.transpose(1, 2), em, em.tile_out, em.in_ptr,
                       em.in_slots, em.n_in)
        if ctx.needs_input_grad[1]:
            tile_counts["dk"].add(em)
            k, cin, cout = kernel.shape
            t, n_tiles = em.tile, em.tile_k.shape[0]
            xp = torch.cat([x, x.new_zeros((1, cin))])
            dyp = torch.cat([dy, dy.new_zeros((1, cout))])
            dk = kernel.new_zeros((k, cin * cout))
            k_ptr = torch.searchsorted(
                em.tile_k, torch.arange(k + 1, device=kernel.device)).int()
            chunk = max(1, _MAX_CHUNK_ELEMS // (t * (cin + cout)))
            for s in range(0, n_tiles, chunk):
                rows = slice(s * t, min(s + chunk, n_tiles) * t)
                g = xp.index_select(0, em.tile_in[rows]).view(-1, t, cin)
                gy = dyp.index_select(0, em.tile_out[rows]).view(-1, t, cout)
                slot_sum_runs(dk, torch.bmm(g.transpose(1, 2), gy).view(-1, cin * cout),
                              s, k_ptr)
            dk = dk.view(k, cin, cout)
        return dx, dk, None


def sparse_conv(feats: torch.Tensor, kernel: torch.Tensor, em: EdgeMap,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """feats [N, Cin] (compute dtype), kernel [K, Cin, Cout] f32 -> [M, Cout];
    products and sums in f32 (f64 for f64 features)."""
    acc = torch.promote_types(feats.dtype, torch.float32)
    out = _SparseConv.apply(feats.to(acc), kernel.to(acc), em)
    if bias is not None:
        out = out + bias
    return out.to(feats.dtype)


class _SumPool(torch.autograd.Function):
    """Sum pooling through the map's slot lists: out[p] adds x[j] over its
    edges in ascending slot order, and the backward dx[j] adds dy[p] over
    the input row's slot lists in the same way."""

    @staticmethod
    def forward(ctx, x, em):
        ctx.em = em
        out = x.new_zeros((em.n_out, x.shape[1]))
        return slot_sum_rows(out, x, em.tile_in, 0, em.tile_in.shape[0],
                             em.out_ptr, em.out_slots)

    @staticmethod
    def backward(ctx, dy):
        em = ctx.em
        dy = dy.contiguous()
        dx = dy.new_zeros((em.n_in, dy.shape[1]))
        return slot_sum_rows(dx, dy, em.tile_out, 0, em.tile_out.shape[0],
                             em.in_ptr, em.in_slots), None


def sparse_sum_pool(feats: torch.Tensor, em: EdgeMap) -> torch.Tensor:
    """Unweighted sum over a map's edges (MinkowskiSumPooling, and with the
    transposed map MinkowskiPoolingTranspose): out[p] = sum of x[j] over the
    edges (k, j, p). Sums in f32 (f64 for f64 features), stored in the
    input's dtype."""
    acc = torch.promote_types(feats.dtype, torch.float32)
    return _SumPool.apply(feats.to(acc).contiguous(), em).to(feats.dtype)


def sparse_avg_pool(feats: torch.Tensor, em: EdgeMap) -> torch.Tensor:
    """``sparse_sum_pool`` over each output row's edge count (at least 1),
    in f32, stored in the input's dtype."""
    counts = torch.bincount(em.tile_out, minlength=em.n_out + 1)[:em.n_out]
    summed = sparse_sum_pool(feats, em).float()
    return (summed / torch.clamp(counts, min=1)[:, None]).to(feats.dtype)


def cat_features(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """ME.cat: the features of two sparse tensors on one coordinate map,
    side by side."""
    return torch.cat([a, b], dim=-1)


def linear(feats: torch.Tensor, kernel: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """A kernel-size-1 convolution on its own grid: x @ W[0] (+ bias)."""
    out = torch.matmul(feats.float(), kernel[0])
    if bias is not None:
        out = out + bias
    return out.to(feats.dtype)


def conv1_ones(occupancy: torch.Tensor, kernel: torch.Tensor,
               bias: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
    """First conv with an all-ones input: out = occupancy [M, K] @ W[:, 0, :].

    Exact: each row sums the kernel rows its map entries select (the JAX
    package's ``models/common.apply_conv1_ones``)."""
    if kernel.shape[1] != 1:
        raise ValueError("the all-ones conv1 needs Cin == 1")
    out = torch.matmul(occupancy, kernel[:, 0, :])
    if bias is not None:
        out = out + bias
    return out.to(dtype)


def batch_norm_infer(feats: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     mean: torch.Tensor, var: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """Inference BatchNorm with running statistics, in f32."""
    inv = torch.rsqrt(var.float() + eps)
    return ((feats.float() - mean) * inv * scale + bias).to(feats.dtype)


def masked_moments(feats: torch.Tensor, mask: torch.Tensor | None = None,
                   group=None):
    """Per-channel mean and biased variance over the rows of [..., C] (every
    leading axis reduced) where ``mask`` [...] is set, in f32; returns
    (mean [C], var [C], count). The port's rows are flat over the batch and
    all valid, so it passes no mask; the JAX package's padded [B, N, C]
    rows pass theirs.

    ``group`` (a ``torch.distributed`` process group): each rank holds a
    shard of the rows, and the moments are those of every rank's rows, in
    two passes: an all-reduce of (sum x, count) gives the mean, then one of
    sum (x - mean)^2 the variance. The all-reduces are differentiable
    (``torch.distributed.nn``), so the backward crosses the ranks; every
    rank must call this in the same order, a rank without rows included."""
    x = feats.float()
    axes = tuple(range(x.dim() - 1))
    m = torch.ones_like(x[..., :1]) if mask is None else mask.float()[..., None]
    if group is None:
        count = torch.clamp(m.sum(), min=1.0)
        mean = (x * m).sum(axes) / count
        return mean, (m * (x - mean) ** 2).sum(axes) / count, count
    from torch.distributed.nn.functional import all_reduce

    sums = all_reduce(torch.cat([(x * m).sum(axes), m.sum().reshape(1)]), group=group)
    count = torch.clamp(sums[-1].detach(), min=1.0)
    mean = sums[:-1] / count
    var = all_reduce((m * (x - mean) ** 2).sum(axes), group=group) / count
    return mean, var, count


def batch_norm_train(feats: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor,
                     momentum: float, eps: float = 1e-5,
                     mask: torch.Tensor | None = None, group=None):
    """Train-mode BatchNorm (the JAX package's ``batch_norm_train``, torch
    semantics): normalise with the batch's biased variance; the running
    statistics become ``(1 - momentum) r + momentum x`` with the unbiased
    variance. Returns (out, new running mean, new running var); the
    statistics carry no gradient. ``group``: the batch is every rank's rows
    (``masked_moments``), so every rank writes the same statistics."""
    mean, var, count = masked_moments(feats, mask, group)
    out = (feats.float() - mean) * torch.rsqrt(var + eps) * scale + bias
    with torch.no_grad():
        unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * unbiased
    return out.to(feats.dtype), new_mean, new_var


def instance_norm(feats: torch.Tensor, batch: torch.Tensor, batch_size: int,
                  eps: float = 1e-5) -> torch.Tensor:
    """Per-cloud, per-channel normalisation (MinkowskiInstanceNorm without
    affine). ``batch`` [N] holds each row's cloud index: statistics are
    taken over each cloud's rows alone, as the JAX package's ``vmap`` of
    ``instance_norm`` over [B, N, C] takes them, in f32 (biased variance).
    Each cloud's sums, and the spread of its statistics over its rows, are
    matmuls with the one-hot [B, N] cloud matrix: a fixed order, forward and
    backward, where an ``index_add_`` would add with atomics."""
    x = feats.float()
    clouds = torch.arange(batch_size, device=x.device)
    onehot = (batch[None, :] == clouds[:, None]).to(x.dtype)
    count = onehot.sum(1, keepdim=True).clamp_min(1)
    d = x - onehot.T @ ((onehot @ x) / count)
    var = (onehot @ (d * d)) / count
    return (d * (onehot.T @ torch.rsqrt(var + eps))).to(feats.dtype)


def relu(feats: torch.Tensor) -> torch.Tensor:
    return torch.clamp(feats, min=0)


def elu(feats: torch.Tensor) -> torch.Tensor:
    """x for x > 0, exp(x) - 1 otherwise (``jax.nn.elu``)."""
    return torch.where(feats > 0, feats, torch.expm1(feats))
