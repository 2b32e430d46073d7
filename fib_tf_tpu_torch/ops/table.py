"""Voltage-indexed rate lookup tables (port of fib_tf_tpu/ops/table.py).

The native Courtemanche path tabulates its 30 voltage-dependent
intermediates at 1 mV resolution, 150 rows, and picks the row
`clamp(int(V + 100), 0, 149)` with no interpolation (`SimConfig.table`).
The port runs it on the plain path only: a table gather per cell is a
`torch` indexing op, and the engine routes table mode off the kernels.
The MXU variants of the reference (`lookup_onehot*`) are a TPU
workaround and are not carried.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch

TABLE_ROWS = 150       # rows of the native table
V_OFFSET = 100.0       # row index = int(V + 100)


def build_table(
    calc_inter: Callable[[np.ndarray], Dict[str, np.ndarray]],
    keys: Sequence[str],
    rows: int = TABLE_ROWS,
    v_offset: float = V_OFFSET,
) -> np.ndarray:
    """Tabulate `calc_inter` at V = i - v_offset for i in [0, rows), one
    column per key: a float32 `[rows, len(keys)]` array."""
    v = np.arange(rows, dtype=np.float64) - v_offset
    inter = calc_inter(v)
    cols = [np.broadcast_to(np.asarray(inter[k], dtype=np.float64), v.shape)
            for k in keys]
    return np.stack(cols, axis=1).astype(np.float32)


def row_index(v: torch.Tensor, rows: int = TABLE_ROWS,
              v_offset: float = V_OFFSET) -> torch.Tensor:
    """clamp(int(V + offset), 0, rows - 1), the float-to-int conversion
    truncating toward zero as C's (and the reference's astype(int32))."""
    i = (v + v_offset).to(torch.int32)
    return torch.clamp(i, 0, rows - 1)


def lookup(table: torch.Tensor, v: torch.Tensor,
           keys: Sequence[str]) -> Dict[str, torch.Tensor]:
    """Gather the table's rows for a voltage field: each key maps to a
    tensor shaped like `v`.  `table` is `[rows, len(keys)]`."""
    picked = table[row_index(v, table.shape[0]).long()]
    return {k: picked[..., j] for j, k in enumerate(keys)}
