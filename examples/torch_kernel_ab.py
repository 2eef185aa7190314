"""Phase 3 of ``chip_smoke.py`` (each attention kernel against its plain
version, its emulation in float32, SDPA and its bound) for several
checkouts, in turns, on one card.

    python examples/torch_kernel_ab.py TREE [TREE ...] [--float32-only] [--out PATH]

Each TREE is the root of a checkout (this one is ``.``). The trees run in the
order given, each in a process of its own that imports that tree's package
and ``chip_smoke.py``, builds its kernels and runs its phase 3
(``phase_kernels``, ``phase_flash_kernel``) on this checkout's phase-3 cases
(``KERNEL_CASES``, ``FLASH_CASES``), so an older tree is timed at the shapes
added since. To compare two versions, unpack the older one with ``git
archive`` into a directory that git ignores and list them older, newer,
newer, older. ``--float32-only`` keeps the float32 cases and the two
bfloat16 latency shapes. Each process prints its ``[3]`` lines; the records
(one per run, with the card's name and power limit) go to ``--out`` as
JSON, and a table of kernel ms per case and run ends the output. Needs one
CUDA card and ``nvcc``, like ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

RUN = """
import json, sys
sys.path.insert(0, {tree!r})
import chip_smoke as cs
cases = json.loads({cases!r})
cs.KERNEL_CASES = [(tuple(s), tuple(d)) for s, d in cases["kernel"]]
cs.FLASH_CASES = [(tuple(s), tuple(d)) for s, d in cases["flash"]]
card = cs.nvidia_smi_line()
cs.phase_build()
record = {{"tree": {tree!r}, "card": card,
          "kernels": [cs.phase_kernels(card), cs.phase_flash_kernel(card)]}}
print("AB " + json.dumps(record), flush=True)
"""


def phase3_cases(float32_only: bool) -> dict:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    def keep(cases, latency):
        out = []
        for shape, dtypes in cases:
            kept = [d for d in dtypes if not float32_only or d == "float32"
                    or (d == "bfloat16" and tuple(shape) == latency)]
            if kept:
                out.append((list(shape), kept))
        return out

    return {"kernel": keep(cs.KERNEL_CASES, cs.LATENCY_SHAPE),
            "flash": keep(cs.FLASH_CASES, cs.FLASH_LATENCY_SHAPE)}


# A phase-3 line's case and kernel ms: "[3] fused_rope B=2 N=448 H=8 D=128
# float32 <variant>: ... kernel 0.0702 ms" or "[3] flash B=.. H=.. N=.. D=..
# float32 contiguous <variant>: ...".
LINE = re.compile(r"^\[3\] (fused_rope|flash) (B=\d+ \S+ \S+ D=\d+) (\w+) ?(contiguous|packed-v)? "
                  r"(\w+): .*kernel ([0-9.]+) ms")


def run_tree(tree: Path, cases: dict) -> tuple[dict, dict]:
    """(the run's record, {(kernel, shape, dtype, layout): (variant, ms)})."""
    script = RUN.format(tree=str(tree.resolve()), cases=json.dumps(cases))
    proc = subprocess.run([sys.executable, "-c", script], cwd=tree, capture_output=True,
                          text=True)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("[")]
    sys.stdout.write("".join(line + "\n" for line in lines))
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-8000:])
        raise SystemExit(f"phase 3 of {tree} failed (exit {proc.returncode})")
    record = json.loads(next(
        line for line in proc.stdout.splitlines() if line.startswith("AB "))[3:])
    times = {}
    for line in lines:
        m = LINE.match(line)
        if m:
            kernel, shape, dtype, layout, variant, ms = m.groups()
            times[(kernel, shape, dtype, layout or "")] = (variant, float(ms))
    return record, times


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="+", type=Path)
    parser.add_argument("--float32-only", action="store_true")
    parser.add_argument("--out", type=Path)
    args = parser.parse_args()
    cases = phase3_cases(args.float32_only)
    records, times = [], []
    for i, tree in enumerate(args.trees):
        print(f"== run {i + 1}: {tree}", flush=True)
        record, run_times = run_tree(tree, cases)
        records.append(record)
        times.append(run_times)
    if args.out:
        args.out.write_text(json.dumps(
            [{**r, "times": {" ".join(k): v for k, v in t.items()}}
             for r, t in zip(records, times)], indent=1))
    print("kernel ms by run (" + ", ".join(map(str, args.trees)) + ") ["
          + records[0]["card"] + "]")
    for key in times[0]:
        print(" ".join(k for k in key if k) + ": " + ", ".join(
            f"{t[key][1]:.4f} ({t[key][0]})" if key in t else "-" for t in times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
