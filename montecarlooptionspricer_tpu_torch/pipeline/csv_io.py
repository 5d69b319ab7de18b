"""CSV tables (counterpart: ``montecarlooptionspricer_tpu/pipeline/csv_io.py``,
its Python path; the JAX package's native parser is built into its own
directory, so the port does not load it).

The split mirrors ``std::getline(ss, tok, ',')``: no quoting, no escaping,
and a trailing delimiter yields no empty trailing field.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


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
    """(header, rows) of a CSV file, empty lines skipped: utf-8 with
    replacement and '\\n'-only line breaks (a lone '\\r' is field
    content)."""
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
