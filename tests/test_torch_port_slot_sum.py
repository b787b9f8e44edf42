"""Port vs JAX package: the fixed-order slot sum and the convs built on it.

On one small cloud's 3D maps (a same-stride level, a stride-2 down map, its
transposed up map, the k2/s2 pooling map) and a small 6D map:

(a) the slot lists: each output row's (offset, input row) pairs, and each
    input row's (offset, output row) pairs, equal the port's ``Edges`` and
    the JAX ``build_edge_map``'s per-row edges on the same grids; a row's
    offsets ascend. Exact, in integers.
(b) ``_conv`` with ``_MAX_CHUNK_ELEMS`` cut so that chunks split an
    offset's tiles equals the one-chunk conv bit for bit (forward, dx, dk).
(c) the plain versions of ``ops/slot_sum.py`` (the CPU's one pass in slot
    order and the card's rounds), the per-offset form
    ``for k: out[dst_k] += P_k`` and the sequential by-row sum agree bit for
    bit, on chunks that split an offset; the CUDA wrappers refuse CPU
    tensors rather than fall back (the runs wrapper also refuses f64 values
    and int64 pointers).
(d) forward, dx and dk against the JAX ``sparse_conv_edges`` and its
    ``jax.vjp``. f32: within 1e-5 of each result's largest entry (sums in
    another order; measured 2^-22.5 on y and dx, dk equal). bf16 (inputs
    and kernels rounded to bf16 on both sides): the JAX gather path rounds
    every product to bf16 before its f32 sum (``edge_conv.py:571``) and
    stores dk in bf16; the port sums the f32 products and keeps dk in f32.
    Measured here, as a share of the largest entry: y 2^-7.95 to 2^-8.34 on
    the gather-path maps (same-stride, down, 6D) and 0 on the transposed
    map, which the JAX package sums through its scatter path without that
    rounding; dx 0 on every map (both backward paths sum f32 products); dk
    2^-8.3 to 2^-8.9. The bound is 2^-7.
(e) sum pooling (f32 and bf16, with its gradient) and the instance norm
    (with its gradient) against the JAX ``sparse_sum_pool`` /
    ``instance_norm``, within 1e-5 of the largest entry in f32 (bf16 pooling:
    2^-8, one rounding of the stored result).
(f) the runs form (``slot_sum_runs``, the kernel gradient's): on the CPU it
    equals ``slot_sum_plain`` over ``arange`` slots and the sequential
    by-row sum bit for bit, on chunks that split a run and with an empty
    run; the conv's dk through it, with one tile a chunk, equals the
    earlier formula (``slot_sum`` over the offsets' pointers and ``arange``
    tiles, one chunk) bit for bit. Exact: the same adds in the same order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepglobalregistration_tpu.models import unet_plan as jplan
from deepglobalregistration_tpu.ops import edge_conv as jedge
from deepglobalregistration_tpu.ops import sparse_conv as jsc
from deepglobalregistration_tpu.ops import sparse_grid as jsg
from deepglobalregistration_tpu_torch.ops import edge_conv, kernel_map, slot_sum
from deepglobalregistration_tpu_torch.ops import sparse_conv as sc
from deepglobalregistration_tpu_torch.ops import sparse_grid

TILE = 16
CIN, COUT = 8, 16
F32_TOL = 1e-5
BF16_TOL = 2.0 ** -7


@functools.lru_cache(maxsize=None)
def _maps():
    """Port Edges, port tile maps (tile 16) and JAX tile maps of one cloud:
    {name: (edges, port map, JAX map, rows in, rows out, JAX kmap)}."""
    rng = np.random.RandomState(0)
    xyz = (rng.rand(600, 3) * 0.9).astype(np.float32)
    _, g = jax.jit(lambda x: jsg.voxelize(x, jnp.int32(600), 0.05))(jnp.asarray(xyz))
    jp = jax.jit(lambda g: jplan.build_unet_plan(
        g, 3, kernel_map.HYPER_CUBE, 3, 2, 1, with_pooling=True))(g)
    g0 = sparse_grid.voxelize(torch.from_numpy(xyz), 0.05, 0)[1]
    g1 = sparse_grid.stride_down(g0, 2)
    n0, n1 = g0.shape[0], g1.shape[0]
    assert (n0, n1) == (int(jp.grids[0].num), int(jp.grids[1].num))
    offs3 = kernel_map.kernel_offsets(3, 3)
    offs2 = kernel_map.kernel_offsets(2, 3)
    down = kernel_map.build_kernel_map(g0, g1, offs3, 1)
    pool = kernel_map.build_kernel_map(g0, g1, offs2, 1)
    jdown, jup = jedge.build_edge_maps_down_up(jp.down_kmaps[0][:, :n1], 27, TILE)
    kmaps = {"self": np.asarray(jp.self_kmaps[0])[:, :n0],
             "down": np.asarray(jp.down_kmaps[0])[:, :n1],
             "up": np.asarray(jp.up_kmaps[0])[:, :n0],
             "pool": np.asarray(jp.pool_down[0])[:, :n1]}
    out = {
        "self": (kernel_map.build_kernel_map(g0, g0, offs3, 1),
                 jedge.build_edge_map(jnp.asarray(kmaps["self"]), 27, TILE), n0, n0),
        "down": (down, jdown, n0, n1),
        "up": (down.transpose(), jup, n1, n0),
        "pool": (pool, jedge.build_edge_map(jnp.asarray(kmaps["pool"]), 8, TILE),
                 n0, n1),
    }
    # A small 6D correspondence grid (the inlier net's), region HYPER_CUBE.
    c0 = np.unique(rng.randint(0, 6, (400, 3)), axis=0)[:120]
    c6 = np.concatenate([np.zeros((len(c0), 1), np.int64), c0,
                         rng.randint(0, 6, (len(c0), 3))], 1)
    g6 = torch.from_numpy(c6.astype(np.int64))
    e6 = kernel_map.build_kernel_map(g6, g6, kernel_map.kernel_offsets(3, 6), 1)
    kmaps["6d"] = _dense_kmap(e6)
    deg = int(np.max((kmaps["6d"] >= 0).sum(0)))
    out["6d"] = (e6, jedge.build_edge_map(jnp.asarray(kmaps["6d"]), deg, TILE),
                 g6.shape[0], g6.shape[0])
    return {name: (e, edge_conv.build_edge_map(e, TILE), jm, ni, no, kmaps[name])
            for name, (e, jm, ni, no) in out.items()}


def _dense_kmap(e):
    kmap = np.full((e.n_offsets, e.n_out), -1, np.int32)
    kmap[e.k.numpy(), e.out.numpy()] = e.inp.numpy()
    return kmap


def _per_row(rows, keys, n):
    """{row: sorted list of (offset, other row)} of n rows."""
    out = {r: [] for r in range(n)}
    for r, key in zip(rows, keys):
        out[int(r)].append(tuple(int(v) for v in key))
    return {r: sorted(v) for r, v in out.items()}


def _slot_lists(em, ptr, slots, other, n):
    """Each row's (offset, other row) in slot order, and the offsets'
    ascent."""
    k = em.tile_k[slots.long() // em.tile]
    o = other[slots.long()]
    got = {}
    for r in range(n):
        a, b = int(ptr[r]), int(ptr[r + 1])
        got[r] = list(zip(k[a:b].tolist(), o[a:b].tolist()))
        assert all(x[0] < y[0] for x, y in zip(got[r], got[r][1:])), r
    return got


def _jax_per_row(jm, n_in, n_out):
    """{output row: sorted (offset, input row)} of a JAX tile map: through
    ``out_slots`` / ``row_inv`` where the map has them, else its tiles."""
    k = np.asarray(jm.tile_k)
    ti = np.asarray(jm.tile_in)
    t = ti.shape[1]
    if jm.out_slots is not None:
        slots = np.asarray(jm.out_slots)[np.asarray(jm.row_inv)[:n_out]]
        out = np.broadcast_to(np.arange(n_out)[:, None], slots.shape)
        ok = slots >= 0
        pos, out = slots[ok], out[ok]
    else:
        to = np.asarray(jm.tile_out).ravel()
        pos = np.nonzero(to >= 0)[0]
        out = to[pos]
    kk, inp = k[pos // t], ti.ravel()[pos]
    ok = (kk >= 0) & (inp >= 0)
    return _per_row(out[ok], zip(kk[ok], inp[ok]), n_out)


@pytest.mark.parametrize("name", ["self", "down", "up", "pool", "6d"])
def test_slot_lists_equal_edges_and_jax(name):
    e, em, jm, n_in, n_out, _ = _maps()[name]
    assert em.out_slots.dtype == em.in_slots.dtype == torch.int32
    assert em.out_slots.shape[0] == em.in_slots.shape[0] == e.k.shape[0]
    by_out = _slot_lists(em, em.out_ptr, em.out_slots, em.tile_in, n_out)
    by_in = _slot_lists(em, em.in_ptr, em.in_slots, em.tile_out, n_in)
    assert by_out == _per_row(e.out.numpy(), zip(e.k.numpy(), e.inp.numpy()), n_out)
    assert by_in == _per_row(e.inp.numpy(), zip(e.k.numpy(), e.out.numpy()), n_in)
    assert by_out == _jax_per_row(jm, n_in, n_out)


def _inputs(name, dtype=torch.float32, seed=1):
    e, em, _, n_in, n_out, _ = _maps()[name]
    rng = np.random.RandomState(seed)
    k = e.n_offsets
    x = torch.from_numpy(rng.randn(n_in, CIN).astype(np.float32))
    w = torch.from_numpy((rng.randn(k, CIN, COUT) / np.sqrt(CIN * 4)).astype(np.float32))
    g = torch.from_numpy(rng.randn(n_out, COUT).astype(np.float32))
    if dtype == torch.bfloat16:  # both sides start from bf16 values
        x, w = x.bfloat16().float(), w.bfloat16().float()
    return em, x, w, g


def _port_conv(em, x, w, g, dtype=torch.float32):
    x = x.clone().requires_grad_(True)
    w = w.clone().requires_grad_(True)
    y = sc.sparse_conv(x.to(dtype), w, em).float()
    dx, dk = torch.autograd.grad(y, (x, w), g)
    return y.detach(), dx, dk


@pytest.mark.parametrize("name", ["self", "down", "up", "6d"])
def test_chunks_splitting_an_offset_give_the_same_bits(name, monkeypatch):
    em, x, w, g = _inputs(name)
    one = _port_conv(em, x, w, g)
    tiles_per_k = torch.bincount(em.tile_k)
    assert int(tiles_per_k.max()) >= 2  # some offset spans several tiles
    # One tile a forward chunk (and a dk chunk): every offset is split.
    monkeypatch.setattr(sc, "_MAX_CHUNK_ELEMS", CIN * (TILE + COUT))
    many = _port_conv(em, x, w, g)
    for a, b in zip(one, many):
        assert torch.equal(a, b)


def _per_offset(out, P, s0, em, dst, n_rows):
    """``for k: out[dst_k] += P_k``: one index_add_ per offset's tiles in the
    chunk, padding slots dropped."""
    t = em.tile
    tk = em.tile_k[s0 // t:(s0 + P.shape[0]) // t]
    rows = dst[s0:s0 + P.shape[0]]
    for k in torch.unique(tk).tolist():
        sel = (tk == k).repeat_interleave(t) & (rows < n_rows)
        out.index_add_(0, rows[sel], P[sel])
    return out


def _by_row(out, src, s0, s1, ptr, slots, rows=None):
    """The kernel's loop, written out: acc = out[r]; acc += each slot's row."""
    for r in range(ptr.shape[0] - 1):
        acc = out[r].clone()
        for s in slots[int(ptr[r]):int(ptr[r + 1])].tolist():
            if s0 <= s < s1:
                acc += src[s - s0] if rows is None else src[rows[s]]
        out[r] = acc
    return out


@pytest.mark.parametrize("name", ["self", "up", "6d"])
def test_plain_forms_agree_bit_for_bit(name):
    em = _maps()[name][1]
    rng = np.random.RandomState(2)
    t, n_slots = em.tile, em.tile_in.shape[0]
    P = torch.from_numpy(rng.randn(n_slots, 5).astype(np.float32) * 100)
    base = torch.from_numpy(rng.randn(em.n_out, 5).astype(np.float32))
    # Chunks of 3 tiles: most offsets' tiles fall into two chunks.
    for s0 in range(0, n_slots, 3 * t):
        s1 = min(s0 + 3 * t, n_slots)
        args = (P[s0:s1], s0, em.out_ptr, em.out_slots)
        a = slot_sum.slot_sum_plain(base.clone(), *args)
        r = slot_sum._by_rounds(base.clone(), P[s0:s1], None, s0, s1,
                                em.out_ptr, em.out_slots)
        b = _per_offset(base.clone(), P[s0:s1], s0, em, em.tile_out, em.n_out)
        c = _by_row(base.clone(), P[s0:s1], s0, s1, em.out_ptr, em.out_slots)
        assert torch.equal(a, r) and torch.equal(a, b) and torch.equal(a, c)
        assert torch.equal(slot_sum.slot_sum(base.clone(), *args), a)
    x = torch.from_numpy(rng.randn(em.n_in, 5).astype(np.float32))
    rows = em.tile_in
    s0, s1 = 3 * t, n_slots - t  # a chunk that cuts offsets at both ends
    a = slot_sum.slot_sum_rows_plain(base.clone(), x, rows, s0, s1,
                                     em.out_ptr, em.out_slots)
    r = slot_sum._by_rounds(base.clone(), x, rows, s0, s1, em.out_ptr,
                            em.out_slots)
    xp = torch.cat([x, x.new_zeros((1, 5))])
    b = _per_offset(base.clone(), xp[rows[s0:s1]], s0, em, em.tile_out, em.n_out)
    c = _by_row(base.clone(), x, s0, s1, em.out_ptr, em.out_slots, rows)
    assert torch.equal(a, r) and torch.equal(a, b) and torch.equal(a, c)


def test_cuda_wrappers_refuse_cpu_tensors():
    em = _maps()["self"][1]
    out = torch.zeros(em.n_out, 4)
    P = torch.zeros(em.tile_in.shape[0], 4)
    with pytest.raises(ValueError, match="CUDA"):
        slot_sum.slot_sum_cuda(out, P, 0, em.out_ptr, em.out_slots)
    with pytest.raises(ValueError, match="CUDA"):
        slot_sum.slot_sum_rows_cuda(out, torch.zeros(em.n_in, 4), em.tile_in, 0,
                                    P.shape[0], em.out_ptr, em.out_slots)


@pytest.mark.parametrize("case", ["cpu", "f64", "int64_ptr"])
def test_runs_cuda_wrapper_refuses(case):
    em = _maps()["self"][1]
    k_ptr = torch.searchsorted(em.tile_k, torch.arange(28)).int()
    out, P = torch.zeros(27, 4), torch.zeros(em.tile_k.shape[0], 4)
    if case == "cpu":
        with pytest.raises(ValueError, match="CUDA"):
            slot_sum.slot_sum_runs_cuda(out, P, 0, k_ptr)
    elif case == "f64":
        with pytest.raises(TypeError, match="f32"):
            slot_sum.slot_sum_runs_cuda(out.double(), P.double(), 0, k_ptr)
    else:
        with pytest.raises(TypeError, match="int32"):
            slot_sum.slot_sum_runs_cuda(out, P, 0, k_ptr.long())


@functools.lru_cache(maxsize=None)
def _jax_conv_fn(out_rows, dtype):
    def run(x, w, jm, g):
        f = lambda a, b: jedge.sparse_conv_edges(
            a.astype(dtype), b, jm, out_rows=out_rows).astype(jnp.float32)
        y, vjp = jax.vjp(f, x, w)
        return (y,) + vjp(g)
    return jax.jit(run)


def _rel_gap(a, b):
    b = np.asarray(b, np.float32)
    return float(np.abs(np.asarray(a, np.float32) - b).max() / np.abs(b).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["self", "down", "up", "6d"])
def test_conv_and_gradients_match_jax(name, dtype):
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    em, x, w, g = _inputs(name, tdt)
    jm, n_out = _maps()[name][2], _maps()[name][4]
    got = _port_conv(em, x, w, g, tdt)
    want = _jax_conv_fn(n_out, jdt)(x.numpy(), w.numpy(), jm, g.numpy())
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    for label, a, b in zip(("y", "dx", "dk"), got, want):
        assert tuple(a.shape) == b.shape, label
        assert _rel_gap(a, b) <= tol, (label, _rel_gap(a, b))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["pool", "up"])
def test_sum_pool_matches_jax(name, dtype):
    _, em, _, n_in, n_out, kmap = _maps()[name]
    if name == "up":  # the pooling transpose: the pool map's up map
        em = edge_conv.build_edge_map(_maps()["pool"][0].transpose(), TILE)
        kmap = _dense_kmap(_maps()["pool"][0].transpose())
    rng = np.random.RandomState(3)
    x = rng.randn(n_in, 6).astype(np.float32)
    g = rng.randn(n_out, 6).astype(np.float32)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = sc.sparse_sum_pool(xt.to(tdt), em).float()
    dx, = torch.autograd.grad(y, xt, torch.from_numpy(g))
    f = lambda a: jsc.sparse_sum_pool(a.astype(jdt), kmap).astype(jnp.float32)
    jy, vjp = jax.vjp(f, x)
    jdx, = vjp(g)
    tol = F32_TOL if dtype == "f32" else 2.0 ** -8
    assert _rel_gap(y.detach(), jy) <= tol
    assert _rel_gap(dx, jdx) <= tol


def test_instance_norm_matches_jax():
    rng = np.random.RandomState(4)
    counts = [37, 0, 58]  # a cloud without rows too
    batch = np.repeat(np.arange(3), counts)
    rng.shuffle(batch)
    x = (rng.randn(len(batch), 5) * 3 + 1).astype(np.float32)
    g = rng.randn(len(batch), 5).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = sc.instance_norm(xt, torch.from_numpy(batch), 3)
    dx, = torch.autograd.grad(y, xt, torch.from_numpy(g))
    # The JAX package's vmap over clouds: [B, N, C] padded, with a mask.
    pad = max(counts)
    idx = [np.nonzero(batch == b)[0] for b in range(3)]
    xb = np.zeros((3, pad, 5), np.float32)
    mask = np.zeros((3, pad), bool)
    for b, i in enumerate(idx):
        xb[b, :len(i)], mask[b, :len(i)] = x[i], True
    f = lambda a: jax.vmap(jsc.instance_norm)(a, mask)
    jy, vjp = jax.vjp(f, xb)
    gb = np.zeros_like(xb)
    for b, i in enumerate(idx):
        gb[b, :len(i)] = g[i]
    jdx, = vjp(gb)
    want_y = np.zeros_like(x)
    want_dx = np.zeros_like(x)
    for b, i in enumerate(idx):
        want_y[i], want_dx[i] = np.asarray(jy)[b, :len(i)], np.asarray(jdx)[b, :len(i)]
    assert _rel_gap(y.detach(), want_y) <= F32_TOL
    assert _rel_gap(dx, want_dx) <= F32_TOL


def _runs_case(name):
    """(ptr, n_slots) of a map's kernel gradient (offset k's tiles), or of a
    hand-made list with an empty run (row 1) and runs of 1-4 slots."""
    if name == "synthetic":
        return torch.tensor([0, 3, 3, 7, 8, 8, 12], dtype=torch.int32), 12
    em = _maps()[name][1]
    k = int(em.tile_k[-1]) + 1
    return torch.searchsorted(em.tile_k, torch.arange(k + 1)).int(), em.tile_k.shape[0]


@pytest.mark.parametrize("name", ["self", "down", "6d", "synthetic"])
def test_runs_plain_equals_arange_slots(name):
    ptr, n = _runs_case(name)
    rows = ptr.shape[0] - 1
    rng = np.random.RandomState(5)
    P = torch.from_numpy(rng.randn(n, 6).astype(np.float32) * 100)
    base = torch.from_numpy(rng.randn(rows + 2, 6).astype(np.float32))
    slots = torch.arange(n, dtype=torch.int32)
    assert int((ptr[1:] - ptr[:-1]).max()) >= 2  # some run spans 2 slots
    # Chunks of 1, 2 and 3 slots, each splitting runs, then one chunk.
    for width in (1, 2, 3, n):
        a, b, c = base.clone(), base.clone(), base.clone()
        for s0 in range(0, n, width):
            s1 = min(s0 + width, n)
            before = a.clone()
            slot_sum.slot_sum_runs(a, P[s0:s1], s0, ptr)
            slot_sum.slot_sum_plain(b, P[s0:s1], s0, ptr, slots)
            _by_row(c, P[s0:s1], s0, s1, ptr, slots)
            assert torch.equal(a, b) and torch.equal(a, c)
            # A row without a slot in the chunk keeps its bits, and so do
            # the rows past the pointers.
            lo, hi = torch.clamp(ptr[:-1], min=s0), torch.clamp(ptr[1:], max=s1)
            idle = torch.cat([hi <= lo, torch.ones(2, dtype=torch.bool)])
            assert torch.equal(a[idle], before[idle])
        assert torch.equal(a, slot_sum.slot_sum_runs_plain(base.clone(), P, 0, ptr))


@pytest.mark.parametrize("name", ["self", "down", "6d"])
def test_dk_through_runs_equals_arange_slot_sum(name, monkeypatch):
    em, x, w, g = _inputs(name)
    # One tile a dk chunk: every offset's run is split across chunks.
    monkeypatch.setattr(sc, "_MAX_CHUNK_ELEMS", CIN * (TILE + COUT))
    assert sc._MAX_CHUNK_ELEMS // (TILE * (CIN + COUT)) == 0
    _, _, dk = _port_conv(em, x, w, g)
    k, t, n_tiles = w.shape[0], em.tile, em.tile_k.shape[0]
    gx = torch.cat([x, x.new_zeros((1, CIN))]).index_select(0, em.tile_in)
    gy = torch.cat([g, g.new_zeros((1, COUT))]).index_select(0, em.tile_out)
    P = torch.bmm(gx.view(-1, t, CIN).transpose(1, 2), gy.view(-1, t, COUT))
    k_ptr = torch.searchsorted(em.tile_k, torch.arange(k + 1)).int()
    want = slot_sum.slot_sum(torch.zeros(k, CIN * COUT), P.reshape(n_tiles, -1), 0,
                             k_ptr, torch.arange(n_tiles, dtype=torch.int32))
    assert torch.equal(dk, want.view(k, CIN, COUT))
