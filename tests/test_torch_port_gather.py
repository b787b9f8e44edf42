"""Port vs JAX package: the gather probe's two kernels.

``take_plain`` and ``take2d_plain`` (what the port's wrappers run on CPU
tensors, and what the CUDA kernels are held against on the card) against
the TPU kernels ``pallas_take`` and ``pallas_take2d`` of
``tools/pallas_gather_bench.py``, run in Pallas's interpret mode on the CPU
at a table and index count of 8192 and at a table of another size than the
index count, and against its ``xla_gather`` at the probe's full shape and
at the KITTI-scale probe shape. A gather copies words, so equality is
exact. The launch geometry of the sweep's design A
(``tools/gather_sweep.geometry``) is held to cover every index exactly once,
through a model of the kernel's index map.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepglobalregistration_tpu_torch.ops import gather
from deepglobalregistration_tpu_torch.tools import gather_bench, gather_sweep
from tools import pallas_gather_bench as pgb

SMALL = 8192


@pytest.fixture
def interpret_probe(monkeypatch):
    """The probe's kernels in interpret mode, at WORDS = N = 8192."""
    monkeypatch.setattr(pgb.pl, "pallas_call",
                        functools.partial(pgb.pl.pallas_call, interpret=True))
    monkeypatch.setattr(pgb, "WORDS", SMALL)
    monkeypatch.setattr(pgb, "N", SMALL)
    return pgb


@pytest.mark.parametrize("form", ["take", "take2d"])
def test_plain_equals_pallas_interpret(interpret_probe, form):
    table, idx = gather_bench.make_inputs(SMALL, SMALL, device="cpu")
    pallas = {"take": interpret_probe.pallas_take,
              "take2d": interpret_probe.pallas_take2d}[form]
    want = np.asarray(pallas(jnp.asarray(table.numpy()), jnp.asarray(idx.numpy())))
    np.testing.assert_array_equal(want, np.asarray(pgb.xla_gather(
        jnp.asarray(table.numpy()), jnp.asarray(idx.numpy()))))
    tab = table if form == "take" else table.view(SMALL // gather.LANES, gather.LANES)
    plain = getattr(gather, f"{form}_plain")(tab, idx)
    dispatched = getattr(gather, form)(tab, idx)  # CPU tensors: the plain version
    assert plain.dtype == torch.int32 and plain.shape == (SMALL,)
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(dispatched.numpy(), want)


def test_plain_equals_xla_gather_at_the_probe_shape():
    table, idx = gather_bench.make_inputs(device="cpu")
    assert table.shape == (pgb.WORDS,) and idx.shape == (pgb.N,)
    want = np.asarray(jax.jit(pgb.xla_gather)(jnp.asarray(table.numpy()),
                                              jnp.asarray(idx.numpy())))
    np.testing.assert_array_equal(gather.take_plain(table, idx).numpy(), want)
    table2d = table.view(-1, gather.LANES)
    np.testing.assert_array_equal(gather.take2d_plain(table2d, idx).numpy(), want)
    # Ragged: one index fewer than the probe's multiple of its block.
    np.testing.assert_array_equal(gather.take2d_plain(table2d, idx[:-1]).numpy(),
                                  want[:-1])


@pytest.mark.parametrize("form", ["take", "take2d"])
def test_plain_equals_pallas_interpret_with_a_table_of_other_size(interpret_probe,
                                                                  monkeypatch, form):
    words, n = 40 * gather.LANES, 3 * pgb.BLK  # W a multiple of 128, W != N
    monkeypatch.setattr(pgb, "WORDS", words)
    monkeypatch.setattr(pgb, "N", n)
    table, idx = gather_bench.make_inputs(words, n, seed=1, device="cpu")
    pallas = {"take": pgb.pallas_take, "take2d": pgb.pallas_take2d}[form]
    want = np.asarray(pallas(jnp.asarray(table.numpy()), jnp.asarray(idx.numpy())))
    np.testing.assert_array_equal(want, table.numpy()[idx.numpy()])
    tab = table if form == "take" else table.view(words // gather.LANES, gather.LANES)
    np.testing.assert_array_equal(getattr(gather, f"{form}_plain")(tab, idx).numpy(), want)
    np.testing.assert_array_equal(getattr(gather, form)(tab, idx).numpy(), want)


def test_plain_equals_xla_gather_at_the_kitti_probe_shape(monkeypatch):
    words, n = gather_bench.SHAPES["kitti"]
    assert (words, n) == (384 * 384 * 48 // 32, 27 * 65536) and words % gather.LANES == 0
    monkeypatch.setattr(pgb, "WORDS", words)
    monkeypatch.setattr(pgb, "N", n)
    table, idx = gather_bench.make_inputs(words, n, device="cpu")
    want = np.asarray(jax.jit(pgb.xla_gather)(jnp.asarray(table.numpy()),
                                              jnp.asarray(idx.numpy())))
    table2d = table.view(-1, gather.LANES)
    for got in (gather.take_plain(table, idx), gather.take2d_plain(table2d, idx)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(gather.take_plain(table, idx[1:]).numpy(), want[1:])
    np.testing.assert_array_equal(gather.take2d_plain(table2d, idx[:-1]).numpy(),
                                  want[:-1])


def kernel_elements(g: gather_sweep.Geometry, n: int) -> np.ndarray:
    """The elements design A's threads write, in tools/gather_variants.cu's
    order: thread t takes head element t, tail element t, and in each loop
    step m the pieces q = t + (m * kPieces + p) * T for p < kPieces (T
    threads in all). Each element appears once for each time it is
    written."""
    T = g.blocks * g.threads
    k_pieces = g.v // g.words
    tid = np.arange(T)
    body_end = g.head + g.pieces * g.words
    steps = -(-g.pieces // (k_pieces * T)) if g.pieces else 0
    m, p = np.meshgrid(np.arange(steps), np.arange(k_pieces), indexing="ij")
    q = (tid[None, :] + ((m * k_pieces + p).reshape(-1, 1)) * T).ravel()
    q = q[q < g.pieces]
    body = (g.head + q[:, None] * g.words + np.arange(g.words)[None, :]).ravel()
    return np.concatenate([tid[tid < g.head], body,
                           body_end + tid[tid < n - body_end]])


@pytest.mark.parametrize("v", gather_sweep.VS)
@pytest.mark.parametrize("offset", [0, 4])
@pytest.mark.parametrize("n", ["0", "1", "v-1", "v", "N", "N-1", "kitti N"])
def test_geometry_covers_every_index_once(v, offset, n):
    n = {"0": 0, "1": 1, "v-1": v - 1, "v": v, "N": gather_bench.N,
         "N-1": gather_bench.N - 1, "kitti N": gather_bench.KITTI_N}[n]
    resident = 8 * 132
    g = gather_sweep.geometry(n, offset, resident, v=v)
    assert g.head <= 3 and 0 <= g.tail < g.words
    if v == 1:  # one index a thread, a block for every 256
        assert (g.blocks, g.head, g.pieces) == (max(1, -(-n // 256)), 0, n)
    else:
        assert 1 <= g.blocks <= resident
    assert g.head + g.pieces * g.words + g.tail == n
    assert g.blocks * g.threads >= max(g.head, g.tail)
    if g.pieces and v > 1:  # the pieces of idx (and out, at its offset) are aligned
        assert (offset + 4 * g.head) % 16 == 0
    got = np.sort(kernel_elements(g, n))
    np.testing.assert_array_equal(got, np.arange(n))


@pytest.mark.parametrize("v", [2, 4, 8])
def test_geometry_grid_stride_beyond_one_wave(v):
    n = 5 * 2 * 128 * 8 + 3  # several loop steps of a two-block grid
    g = gather_sweep.geometry(n, 12, 2, v=v, threads=128)
    assert g.blocks == 2 and g.head == 1
    np.testing.assert_array_equal(np.sort(kernel_elements(g, n)), np.arange(n))


def test_geometry_is_one_wave():
    resident = 8 * 132  # blocks of 256 that fit an H100 at once
    bench = gather_sweep.geometry(gather_bench.N, 0, resident, v=4, threads=256)
    assert bench.blocks == 432  # 442368 / 4 / 256: one wave, no grid-stride step
    assert gather_sweep.geometry(gather_bench.N - 1, 4, resident, v=4).blocks == 432
    for n in (gather_bench.N, gather_bench.N - 1, gather_bench.KITTI_N - 1):
        for v in gather_sweep.VS:  # one loop step a thread unless the wave is full
            g = gather_sweep.geometry(n, 0, resident, v=v)
            assert g.blocks == resident or (
                g.blocks * g.threads * (v // g.words) >= g.pieces
                > (g.blocks - 1) * g.threads * (v // g.words))
    kitti = gather_bench.KITTI_N
    assert gather_sweep.geometry(kitti, 0, resident, v=8, threads=256).blocks == 864
    assert gather_sweep.geometry(kitti, 0, resident, v=4, threads=256).blocks == resident
    with pytest.raises(ValueError, match="v must be"):
        gather_sweep.geometry(16, 0, resident, v=3)


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_output_lies_at_the_offset_of_the_indices(shift):
    idx = torch.arange(40, dtype=torch.int32)[shift:]
    out = gather_sweep.aligned_like(idx)
    assert out.dtype == torch.int32 and out.shape == idx.shape and out.is_contiguous()
    assert out.data_ptr() % 16 == idx.data_ptr() % 16


def test_inputs_are_the_probes_draws():
    table, idx = gather_bench.make_inputs(device="cpu")
    rng = np.random.default_rng(0)  # tools/pallas_gather_bench.py:92-96
    np.testing.assert_array_equal(
        table.numpy(), rng.integers(0, 1 << 30, pgb.WORDS, dtype=np.int64).astype(np.int32))
    np.testing.assert_array_equal(
        idx.numpy(), rng.integers(0, pgb.WORDS, pgb.N, dtype=np.int64).astype(np.int32))


@pytest.mark.parametrize("form", ["take", "take2d"])
def test_cuda_wrappers_never_run_the_plain_version_on_cpu(monkeypatch, form):
    def forbidden(*a, **k):
        raise AssertionError("plain version called from the CUDA wrapper")

    monkeypatch.setattr(gather, f"{form}_plain", forbidden)
    wrapper = getattr(gather, f"{form}_cuda")
    table = torch.zeros(256, dtype=torch.int32)
    if form == "take2d":
        table = table.view(2, gather.LANES)
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(table, torch.zeros(8, dtype=torch.int32))
    assert wrapper.launches == before


def test_take2d_wrapper_rejects_other_row_widths():
    with pytest.raises(ValueError, match="rows of 128"):
        gather.take2d_cuda(torch.zeros(4, 64, dtype=torch.int32),
                           torch.zeros(8, dtype=torch.int32))


def test_gather_bench_runs_on_cpu():
    r = gather_bench.run(device="cpu", words=SMALL, n=SMALL - 1)
    assert r["device"] == "cpu" and r["clock"] == "host"
    assert r["take_exact"] and r["take2d_exact"]
    assert all(r[f"{k}_ms"] > 0 for k in ("table_index", "take", "take2d"))
