"""Feature CSVs of the meta-model (counterpart:
``montecarlooptionspricer_tpu/nn/data.py``): columns chosen by header
name, an error on a missing column, float32 arrays out.  Parsed by
``pipeline/csv_io.read_table``, the port's native CSV reader
(``csrc/host/fastcsv.cpp``, built at first use), which the tests hold
list for list against its Python plain version ``read_table_plain``.
"""

from __future__ import annotations

import logging
from typing import Sequence, Tuple

import numpy as np

from ..pipeline import csv_io

log = logging.getLogger(__name__)


def read_csv(filename: str, input_columns: Sequence[str],
             target_column: str,
             skip_bad_rows: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """(X [n, len(input_columns)] float32, Y [n] float32).

    Raises on a missing input or target column.  With
    ``skip_bad_rows=False`` a ragged row or a non-numeric field raises too;
    with True such rows (PredictionGen writes malformed inputs through
    verbatim) are dropped and counted in the log.
    """
    header, rows = csv_io.read_table(filename)
    col_index = {name: i for i, name in enumerate(header)}
    for col in list(input_columns) + [target_column]:
        if col not in col_index:
            raise ValueError(f"Input column {col} not found in {filename}")
    idx = [col_index[c] for c in input_columns] + [col_index[target_column]]
    need = max(idx) + 1
    if skip_bad_rows:
        kept = []
        for row in rows:
            if len(row) < need:
                continue
            try:
                kept.append([float(row[i]) for i in idx])
            except ValueError:
                continue
        if len(kept) != len(rows):
            log.info("Skipped %d bad row(s) of %d in %s",
                     len(rows) - len(kept), len(rows), filename)
        table = np.asarray(kept, dtype=np.float32)
    else:
        for r, row in enumerate(rows):
            if len(row) < need:
                raise ValueError(
                    f"Row {r + 1} of {filename} has {len(row)} fields; "
                    f"need {need} (ragged or truncated row)")
        table = np.asarray([[row[i] for i in idx] for row in rows],
                           dtype=np.float32)
    if table.size == 0:
        table = table.reshape(0, len(idx))
    return np.ascontiguousarray(table[:, :-1]), table[:, -1].copy()
