"""Compare the placement kernel's B1 machine code with another checkout's.

B6, the zone-anchor solve, is a compile-time mode of
``volcano_tpu_torch/ops/csrc/place.cu``'s ``place_kernel`` (its template
argument ``kTopo``), so that the B1 instances, ``place_kernel<R, false>``,
compile to the machine code the kernel had before the mode existed. This
builds the other checkout's ``place.cu`` with the same nvcc flags, takes
both libraries' SASS (``cuobjdump -sass``), and compares each B1 instance's
instructions, R = 2..8, with the ``/* address */`` and ``/* encoding */``
columns removed. It prints one JSON line (per R: equal or not, the
instruction counts, and the B6 instance's count beside them) and exits 1
when an instance differs. Needs nvcc and cuobjdump (the card's machine)::

    mkdir -p chip_archive/parent
    git archive HEAD~1 volcano_tpu_torch/ops/csrc | tar -x -C chip_archive/parent
    python3 tools/place_sass.py chip_archive/parent
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from volcano_tpu_torch.ops import build  # noqa: E402

# B1's instance in either checkout (place_kernel<R> before the mode,
# place_kernel<R, false> with it) and B6's
B1 = re.compile(r"place_kernelILi(\d)E(?:Lb0E)?EEv")
B6 = re.compile(r"place_kernelILi(\d)ELb1EEEv")


def compile_place(csrc: str, out: str) -> None:
    proc = subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o", out,
         os.path.join(csrc, "place.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {csrc}:\n{proc.stdout}"
                           f"{proc.stderr}")


def sass(lib: str) -> dict:
    """Each function's instructions, by mangled name."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        if cur is not None and "/*" in line:
            ins = re.sub(r"/\*.*?\*/", "", line).strip()
            if ins:
                cur.append(ins)
    return funcs


def instances(funcs: dict, pattern) -> dict:
    out = {}
    for name, ins in funcs.items():
        m = pattern.search(name)
        if m:
            out[int(m.group(1))] = ins
    return out


def main(argv) -> int:
    other = os.path.abspath(argv[0])
    with tempfile.TemporaryDirectory() as tmp:
        theirs, ours = (os.path.join(tmp, f"{n}.so") for n in ("old", "new"))
        compile_place(os.path.join(other, "volcano_tpu_torch", "ops",
                                   "csrc"), theirs)
        compile_place(str(build.CSRC), ours)
        old, new = sass(theirs), sass(ours)
    old_b1, new_b1 = instances(old, B1), instances(new, B1)
    new_b6 = instances(new, B6)
    report = {}
    for R in sorted(set(old_b1) | set(new_b1)):
        a, b = old_b1.get(R), new_b1.get(R)
        report[R] = {"equal": a is not None and a == b,
                     "instructions_before": len(a or ()),
                     "instructions_b1": len(b or ()),
                     "instructions_b6": len(new_b6.get(R, ()))}
    print("place_sass", json.dumps(report), flush=True)
    same = len(report) == 7 and all(r["equal"] for r in report.values())
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
