"""The loops of K7's count kernel in SASS: ``cuobjdump -sass`` of a built
library, the one-selector-word instance (``explain_counts_kernel<0>``),
each backward branch read as a loop [target, branch] with its
instructions (16 bytes each) and the loops it holds.

    python3 probes/k7_sass.py chiprun_out/k7_sass_1.txt
    python3 probes/k7_sass.py DUMP --path 0xad10:0xafb0:1 0xafc0:0xb450:2

reads a dump that ``probes/k7_turns.py`` wrote; ``dump_and_read(so, path)``
writes one (needs the CUDA toolkit's cuobjdump) and reads it.  ``--path``
sums the instructions an executed path issues: each range
``start:end:times`` (hex addresses, both ends included) counted ``times``
times (a loop body at its trip count, a share of a block that serves
several pairs); predicated-off instructions issue too, so a straight
range counts them.
"""
import json
import os
import re
import shutil
import subprocess
import sys

INSTANCE = "explain_counts_kernelILi0E"


def cuobjdump() -> str | None:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    return cand if os.path.exists(cand) else None


def read(path: str, instance: str = INSTANCE) -> dict:
    """The instance's instruction count and loops, outermost first:
    dict(instructions, loops=[dict(start, end, instructions, depth)])."""
    addrs, loops, inside = [], [], False
    for line in open(path):
        if "Function :" in line:
            inside = instance in line
            continue
        if not inside:
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if not m:
            continue
        at = int(m.group(1), 16)
        addrs.append(at)
        b = re.search(r"\bBRA(?:\.\w+)*\s+(?:`\(\.L_x_\d+\)\s*)?(0x[0-9a-f]+)",
                      m.group(2))
        if b and int(b.group(1), 16) <= at:
            loops.append((int(b.group(1), 16), at))
    out = []
    for lo, hi in sorted(loops, key=lambda x: (x[0], -x[1])):
        depth = sum(1 for a, b in loops if a <= lo and hi <= b
                    and (a, b) != (lo, hi))
        out.append(dict(start=lo, end=hi, instructions=(hi - lo) // 16 + 1,
                        depth=depth))
    return dict(instructions=len(addrs), loops=out)


def dump_and_read(so: str, path: str) -> dict | None:
    tool = cuobjdump()
    if tool is None:
        return None
    res = subprocess.run([tool, "-sass", so], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    with open(path, "w") as f:
        f.write(res.stdout)
    return read(path)


def path_count(path: str, ranges: list[str],
               instance: str = INSTANCE) -> float:
    """Instructions of the instance issued along ``ranges``
    (``start:end:times``, hex, inclusive)."""
    addrs = []
    inside = False
    for line in open(path):
        if "Function :" in line:
            inside = instance in line
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line) if inside else None
        if m:
            addrs.append(int(m.group(1), 16))
    total = 0
    for r in ranges:
        lo, hi, times = r.split(":")
        lo, hi = int(lo, 16), int(hi, 16)
        total += float(times) * sum(1 for a in addrs if lo <= a <= hi)
    return total


if __name__ == "__main__":
    if "--path" in sys.argv:
        at = sys.argv.index("--path")
        print(path_count(sys.argv[1], sys.argv[at + 1:]))
    else:
        print(json.dumps(read(sys.argv[1]), indent=1))
