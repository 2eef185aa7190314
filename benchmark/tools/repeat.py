"""Run one cell several times, one process a run, one after another, and
keep each run's result line and the end of its standard error.

    python -m benchmark.tools.repeat --workload <cell> --seeds 11,12,13 \
        --seconds 30 [--trace 1] --out chiprun_out/<file>.jsonl

Each line of ``--out`` is {"seed", "rc", "wall_s", "result", "stderr_tail"}.
A summary of every run's numbers ends the output.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def _text(out) -> str:
    return out.decode(errors="replace") if isinstance(out, bytes) else (out or "")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds a run may take")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    rc_all = 0
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "benchmark.run", "--workload", args.workload,
                 "--seed", str(seed), "--seconds", str(args.seconds),
                 "--trace", str(args.trace)],
                capture_output=True, text=True, timeout=args.timeout)
        except subprocess.TimeoutExpired as e:  # the child is killed
            proc = subprocess.CompletedProcess(e.cmd, 124, _text(e.stdout), _text(e.stderr))
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        tail = proc.stderr.strip().splitlines()[-40:]
        rec = {"seed": seed, "rc": proc.returncode, "wall_s": wall, "result": result,
               "stderr_tail": tail}
        with out.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        rc_all = rc_all or proc.returncode
        metrics = {k: round(v["value"], 4) for k, v in (result or {}).get("metrics", {}).items()}
        checks = {k: v["value"] for k, v in (result or {}).get("checks", {}).items()}
        print(f"seed {seed} rc {proc.returncode} wall {wall:.1f} s correct "
              f"{(result or {}).get('correct')} {metrics} {checks}", flush=True)
        if result is None:
            print("\n".join(tail[-25:]), flush=True)
    return rc_all


if __name__ == "__main__":
    sys.exit(main())
