"""Opcode counts of a built kernel library's SASS, per kernel and per hot
loop, to compare two builds of the same kernel.

For each kernel whose mangled name matches ``--match``, it prints the
instruction count, the local-memory (spill) loads and stores, and each
loop (a backward branch) holding at least ``--min-ffma`` FFMA
instructions: its address range, length and most common opcodes.

Usage, on a machine with the CUDA toolkit, after a build:
  python -m montecarlooptionspricer_tpu_torch.kernels.sass_loops \\
      build/kernels/libpathgen_tiled_*.so [more libraries] \\
      --match 'tiled_kernelILi8E'
"""

from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

_FUNC = re.compile(r"Function : (\S+)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_INS = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                  r"([A-Z][A-Z0-9_.]*)(.*)$")


def parse(sass: str) -> dict:
    """{kernel: (instructions [(address, opcode, operands)], labels
    {label: address})} from ``cuobjdump -sass`` text."""
    funcs, cur, pending = {}, None, []
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = m.group(1)
            funcs[cur] = ([], {})
            pending = []
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INS.match(line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                funcs[cur][1][label] = addr
            pending = []
            funcs[cur][0].append((addr, m.group(3), m.group(4)))
    return funcs


def loops(ins: list, labels: dict, min_ffma: int) -> list:
    """(start, end, length, opcode counts) of each loop, a branch back to a
    lower address, whose body holds at least ``min_ffma`` FFMA."""
    index = {a: i for i, (a, _, _) in enumerate(ins)}
    out = []
    for i, (addr, op, rest) in enumerate(ins):
        if not op.startswith("BRA"):
            continue
        m = re.search(r"(\.L_x_\d+)", rest)
        target = labels.get(m.group(1)) if m else None
        if target is None:
            m = re.search(r"0x([0-9a-f]+)", rest)
            target = int(m.group(1), 16) if m else None
        if target is None or target >= addr or target not in index:
            continue
        body = collections.Counter(o for _, o, _ in ins[index[target]:i + 1])
        ffma = sum(v for k, v in body.items() if k.startswith("FFMA"))
        if ffma >= min_ffma:
            out.append((target, addr, i + 1 - index[target], body))
    return out


def report(sass: str, match: str, min_ffma: int) -> list:
    """One record per matching kernel: its name, instruction count, LDL and
    STL counts, and its loops (``loops``)."""
    pattern = re.compile(match)
    records = []
    for name, (ins, labels) in sorted(parse(sass).items()):
        if not pattern.search(name):
            continue
        ops = collections.Counter(o.split(".")[0] for _, o, _ in ins)
        records.append({"kernel": name, "instructions": len(ins),
                         "LDL": ops.get("LDL", 0), "STL": ops.get("STL", 0),
                         "loops": loops(ins, labels, min_ffma)})
    return records


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("libraries", nargs="+", type=Path)
    parser.add_argument("--match", default=".",
                        help="regular expression on the mangled kernel name")
    parser.add_argument("--min-ffma", type=int, default=64)
    parser.add_argument("--top", type=int, default=14,
                        help="opcodes shown per loop")
    args = parser.parse_args(argv)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        print("error: cuobjdump not found (the CUDA toolkit)",
              file=sys.stderr)
        return 1
    for lib in args.libraries:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
        print(f"== {lib}")
        for r in report(sass, args.match, args.min_ffma):
            print(f"{r['kernel']}: {r['instructions']} instructions, "
                  f"LDL {r['LDL']}, STL {r['STL']}")
            for start, end, length, body in r["loops"]:
                print(f"   loop {start:#x}-{end:#x}, {length} instructions: "
                      f"{dict(body.most_common(args.top))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
