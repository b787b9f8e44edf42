"""The yardstick's peaks and work counts.

Peaks: one NVIDIA H100 SXM at its 700 W limit, NVIDIA's data sheet, dense
rates: 67 TFLOP/s float32 outside the tensor cores, 495 TFLOP/s TF32 on
them, 3.35 TB/s of HBM3. A kernel's least time is the larger of its
operations over the peak rate and its bytes over the memory bandwidth,
each input byte read once and each output byte written once.

- 1-NN (``nn1_scan``, ``nn1_mma``): N0 x N1 candidate pairs, each
  2C + 3 float32 operations (C multiply-adds and the norms) on the CUDA
  cores; the tensor-core kernel runs 3xTF32, 3 x 2 N0 N1 C operations.
  Bytes: both feature sets read, an index and a distance written a row.
- slot sum, by row (the conv's forward and input gradient): the products
  read once ([E, C] float32), the output read and written once, the slot
  list (E int32) and the row pointers (rows + 1 int32).
- conv FLOPs: 2 E Cin Cout a pass.
"""

from __future__ import annotations

F32_FLOPS = 67e12
TF32_FLOPS = 495e12
HBM_BYTES_S = 3.35e12


def nn1_bound_s(kind: str, n0: int, n1: int, c: int) -> float:
    """Least time of one 1-NN search of n0 rows over n1 rows of width c."""
    if kind == "mma":
        ops_s = 3 * 2 * n0 * n1 * c / TF32_FLOPS
    else:
        ops_s = n0 * n1 * (2 * c + 3) / F32_FLOPS
    return max(ops_s, (4 * c * (n0 + n1) + 8 * n0) / HBM_BYTES_S)


def slot_sum_bytes(edges: int, rows: int, c: int) -> int:
    """Bytes one by-row slot sum of ``edges`` products of width ``c`` into
    ``rows`` output rows needs."""
    return 4 * edges * c + 8 * rows * c + 4 * edges + 4 * (rows + 1)


def conv_flops(edges: int, cin: int, cout: int) -> int:
    return 2 * edges * cin * cout
