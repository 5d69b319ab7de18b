"""CSV tables (counterpart: ``montecarlooptionspricer_tpu/pipeline/csv_io.py``).

The split mirrors ``std::getline(ss, tok, ',')``: no quoting, no escaping,
and a trailing delimiter yields no empty trailing field.  ``read_table``
runs on the port's native reader (``csrc/host/fastcsv.cpp``, built at
first use by ``kernels/host_build.py``); ``read_table_plain`` is its
Python plain version, which the tests and the card check hold it against,
list for list.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

from ..kernels import host_build


def split_line(line: str) -> List[str]:
    """'a,b,' -> ['a', 'b'] (the final getline hits EOF), 'a,,b' ->
    ['a', '', 'b']."""
    if line.endswith("\n"):
        line = line[:-1]
    if line.endswith("\r"):
        line = line[:-1]
    if not line:
        return []
    parts = line.split(",")
    if parts and parts[-1] == "" and line.endswith(","):
        parts.pop()
    return parts


def read_table(path: str) -> Tuple[List[str], List[List[str]]]:
    """(header, rows) of a CSV file on the native reader, empty and
    whitespace-only lines skipped: utf-8 with replacement and '\\n'-only
    line breaks (a lone '\\r' is field content).  OSError on an unreadable
    path, ValueError on an empty file."""
    return host_build.load("fastcsv").read_table(os.fspath(path))


def read_table_plain(path: str) -> Tuple[List[str], List[List[str]]]:
    """The plain version of ``read_table``, in Python."""
    rows: List[List[str]] = []
    with open(path, "r", encoding="utf-8", errors="replace",
              newline="\n") as f:
        first = f.readline()
        if not first:
            raise ValueError(f"Empty CSV: {path}")
        header = split_line(first)
        for line in f:
            if line.strip() == "":
                continue
            rows.append(split_line(line))
    return header, rows


def write_csv(path: str, header: Sequence[str],
              rows: Sequence[Sequence[str]]) -> None:
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for row in rows:
            f.write(",".join(str(c) for c in row) + "\n")
