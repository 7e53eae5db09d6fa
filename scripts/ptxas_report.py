#!/usr/bin/env python3
"""Registers, spills and stack of each of the port's CUDA kernels, as ptxas reports them.

Compiles each ``monai_tpu_torch/csrc/*.cu`` (or the sources named on the command line)
with the port's own nvcc flags plus ``-Xptxas -v``, one nvcc a source, all started
together, into a temporary directory, and prints one line a kernel instance: its
source, its name (demangled where ``c++filt`` is found), registers, spill stores and
loads, and stack frame; then how many instances spill. Needs the CUDA toolkit.

Run from the repository root: ``python3 scripts/ptxas_report.py [window_attention.cu ...]``
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

ENTRY = re.compile(r"Compiling entry function '(\S+)'")
STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
REGS = re.compile(r"Used (\d+) registers")


def demangle(names: list[str]) -> list[str]:
    tool = shutil.which("c++filt")
    if tool is None:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True, check=True).stdout
    return [n.replace("(anonymous namespace)::", "").split("(")[0] for n in out.splitlines()]


def report(source: str, ptxas: str) -> list[tuple]:
    """(source, kernel, registers, spill stores, spill loads, stack) per entry function."""
    rows, name, stack = [], None, None
    for line in ptxas.splitlines():
        if m := ENTRY.search(line):
            name, stack = m.group(1), None
        elif (m := STACK.search(line)) and name:
            stack = tuple(int(x) for x in m.groups())
        elif (m := REGS.search(line)) and name and stack is not None:
            rows.append((source, name, int(m.group(1)), stack[1], stack[2], stack[0]))
            name = None
    return rows


def main() -> None:
    from monai_tpu_torch.ops._build import CSRC_DIR, NVCC_FLAGS, find_nvcc

    sources = [CSRC_DIR / a for a in sys.argv[1:]] or sorted(CSRC_DIR.glob("*.cu"))
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(src, subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o",
                                         str(Path(tmp) / f"{src.stem}.o")],
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
                 for src in sources]
        rows = []
        for src, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed on {src.name}:\n{err}")
            rows += report(src.name, err)
    names = demangle([r[1] for r in rows])
    for r, name in zip(rows, names):
        print(f"{r[0]:26s} regs {r[2]:3d}  spill stores {r[3]:4d} B  loads {r[4]:4d} B  stack {r[5]:4d} B  {name}")
    print(f"{len(rows)} kernel instances, {sum(1 for r in rows if r[3] or r[4])} spill")


if __name__ == "__main__":
    main()
