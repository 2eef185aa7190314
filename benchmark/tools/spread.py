"""Spreads of a cell's metrics over sets of runs, as the bounds are set
from them: for each set (one ``repeat`` output file) and metric, the
median and the distance between the first and third quartile
(``statistics.quantiles(values, n=4)``) as a share of the median; then
the widest over the sets, five times it, and the largest compared number
of every run (the lower reading of the output check).

    python -m benchmark.tools.spread chiprun_out/set1.jsonl chiprun_out/set2.jsonl
"""

from __future__ import annotations

import json
import statistics
import sys


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    median = statistics.median(values)
    if median == 0:  # a count that reads 0 in most runs
        return 0.0 if q3 == q1 else float("inf")
    return (q3 - q1) / median


def main(argv=None) -> int:
    files = (argv if argv is not None else sys.argv[1:])
    widest: dict = {}
    checks: dict = {}
    for path in files:
        runs = [json.loads(line) for line in open(path) if line.strip()]
        results = [r["result"] for r in runs if r.get("result")]
        print(f"{path}: {len(results)} results of {len(runs)} runs; seeds "
              f"{[r['seed'] for r in runs]}; correct {[x['correct'] for x in results]}")
        for name in sorted({m for x in results for m in x["metrics"]}):
            values = [x["metrics"][name]["value"] for x in results if name in x["metrics"]]
            if len(values) < 2:
                continue
            s = spread(values)
            widest[name] = max(widest.get(name, 0.0), s)
            print(f"  {name}: median {statistics.median(values):.6g}, spread {100 * s:.3f}% "
                  f"({', '.join(f'{v:.6g}' for v in values)})")
        for x in results:
            for k, c in x.get("checks", {}).items():
                if isinstance(c["value"], (int, float)):
                    checks[k] = max(checks.get(k, float("-inf")), c["value"])
    for name, s in sorted(widest.items()):
        print(f"widest {name}: {100 * s:.3f}%, five times: {500 * s:.3f}%")
    for k, v in sorted(checks.items()):
        print(f"largest {k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
