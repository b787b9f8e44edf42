"""Port vs JAX package: the gather probe's two kernels.

``take_plain`` and ``take2d_plain`` (what the port's wrappers run on CPU
tensors, and what the CUDA kernels are held against on the card) against
the TPU kernels ``pallas_take`` and ``pallas_take2d`` of
``tools/pallas_gather_bench.py``, run in Pallas's interpret mode on the CPU
at a table and index count of 8192, and against its ``xla_gather`` at the
probe's full shape. A gather copies words, so equality is exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepglobalregistration_tpu_torch.ops import gather
from deepglobalregistration_tpu_torch.tools import gather_bench
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
