"""Sparse convolution and sum pooling over exact edge maps, plus inference
norms and nonlinearities.

Counterpart of the JAX package's ``ops/sparse_conv.py:35-171`` and
``ops/edge_conv.py:sparse_conv_edges``:

    out[p] = sum over edges (k, j, p) of  W[k]^T x[j]   (+ bias)

computed as a gather of input rows into single-offset tiles, one batched
matmul against each tile's kernel slice, and an ``index_add_`` into the
output. Arithmetic follows the JAX package's bf16 path: inputs and weights
are rounded to the compute dtype, products and sums run in f32 (TF32 off),
and the result is stored in the compute dtype.
"""

from __future__ import annotations

import torch

from .edge_conv import EdgeMap

# Tiles per batched matmul: bounds the gathered [chunk, T, Cin] rows and the
# [chunk, Cin, Cout] kernel slices.
_MAX_CHUNK_ELEMS = 1 << 26


def sparse_conv(feats: torch.Tensor, kernel: torch.Tensor, em: EdgeMap,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """feats [N, Cin] (compute dtype), kernel [K, Cin, Cout] f32 -> [M, Cout]."""
    cin, cout = kernel.shape[1], kernel.shape[2]
    t = em.tile
    x = torch.cat([feats.float(), feats.new_zeros((1, cin), dtype=torch.float32)])
    out = torch.zeros((em.n_out + 1, cout), dtype=torch.float32, device=feats.device)
    n_tiles = em.tile_k.shape[0]
    chunk = max(1, _MAX_CHUNK_ELEMS // (cin * (t + cout)))
    for s in range(0, n_tiles, chunk):
        tk = em.tile_k[s:s + chunk]
        rows = slice(s * t, (s + tk.shape[0]) * t)
        g = x[em.tile_in[rows]].view(-1, t, cin)
        y = torch.bmm(g, kernel[tk])
        out.index_add_(0, em.tile_out[rows], y.view(-1, cout))
    out = out[:em.n_out]
    if bias is not None:
        out = out + bias
    return out.to(feats.dtype)


def sparse_sum_pool(feats: torch.Tensor, em: EdgeMap) -> torch.Tensor:
    """Unweighted sum over a map's edges (MinkowskiSumPooling, and with the
    transposed map MinkowskiPoolingTranspose): out[p] = sum of x[j] over the
    edges (k, j, p). Sums in f32, stored in the input's dtype."""
    x = torch.cat([feats.float(), feats.new_zeros((1, feats.shape[1]),
                                                  dtype=torch.float32)])
    out = torch.zeros((em.n_out + 1, feats.shape[1]), dtype=torch.float32,
                      device=feats.device)
    out.index_add_(0, em.tile_out, x[em.tile_in])
    return out[:em.n_out].to(feats.dtype)


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


def instance_norm(feats: torch.Tensor, batch: torch.Tensor, batch_size: int,
                  eps: float = 1e-5) -> torch.Tensor:
    """Per-cloud, per-channel normalisation (MinkowskiInstanceNorm without
    affine). ``batch`` [N] holds each row's cloud index: statistics are
    taken over each cloud's rows alone, as the JAX package's ``vmap`` of
    ``instance_norm`` over [B, N, C] takes them, in f32 (biased variance)."""
    x = feats.float()
    c = x.shape[1]
    # index_add_ rather than bincount, whose output size syncs the host.
    count = x.new_zeros((batch_size, 1)).index_add_(
        0, batch, x.new_ones((x.shape[0], 1))).clamp_min(1)
    mean = x.new_zeros((batch_size, c)).index_add_(0, batch, x) / count
    d = x - mean[batch]
    var = x.new_zeros((batch_size, c)).index_add_(0, batch, d * d) / count
    return (d * torch.rsqrt(var + eps)[batch]).to(feats.dtype)


def relu(feats: torch.Tensor) -> torch.Tensor:
    return torch.clamp(feats, min=0)


def elu(feats: torch.Tensor) -> torch.Tensor:
    """x for x > 0, exp(x) - 1 otherwise (``jax.nn.elu``)."""
    return torch.where(feats > 0, feats, torch.expm1(feats))
