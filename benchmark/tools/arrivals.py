"""Find a typical arrival path for an open-loop mix, without a card: the
median, over candidate paths, of how long a request waits in bursts.

    python -m benchmark.tools.arrivals --workload <cell> --knee 14 \
        --seconds 51 [--paths 201] [--seeds 2147484201,2147484202,2147484203]

Every run of an open-loop cell offers its requests at the times of one
Poisson path (the mix's ``arrival_seed``). Each candidate path is scored by
a single server at the knee's rate: requests in order of arrival, each
served in a time proportional to its bucket's frames (their mean 1 / knee),
and the score is the 95th percentile of the time from arrival to served,
averaged over the request orders of ``--seeds``. The path whose score is
the median of the candidates is printed; it goes into the mix by hand.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import numpy as np


def score(reqs: list, frames: np.ndarray, knee: float) -> float:
    """95th percentile (ms) of the single server's time from arrival to
    served."""
    service = frames / frames.mean() / knee
    t, waits = 0.0, []
    for r, s in zip(reqs, service):
        t = max(t, r["due"]) + s
        waits.append(t - r["due"])
    return float(np.percentile(waits, 95)) * 1e3


def main(argv=None) -> int:
    from .. import pack, spec
    from ..traffic import common

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--knee", type=float, required=True, help="the sustained rate, req/s")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--paths", type=int, default=201)
    ap.add_argument("--seeds", default="2147484201,2147484202,2147484203")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    mix = spec.mix(cell["traffic"])
    model = spec.model(spec.config(cell["config"]))
    gen = spec.generator(mix["kind"])
    seeds = [int(s) for s in args.seeds.split(",")]
    voices = pack.voices(seeds[0], model["audio"]["sample_rate"])
    scores = {}
    for path in range(args.paths):
        each = []
        for seed in seeds:
            reqs = gen.requests({**mix, "arrival_seed": path}, model, voices, seed, args.seconds)
            frames = np.array([common.planned_chunks(r["text"], voices[r["voice"]], model)[0].bucket
                               for r in reqs], dtype=float)
            each.append(score(reqs, frames, args.knee))
        scores[path] = statistics.mean(each)
    ranked = sorted(scores, key=scores.get)
    mid = ranked[len(ranked) // 2]
    q = statistics.quantiles(scores.values(), n=4)
    print(f"median path {mid}: score {scores[mid]:.1f} ms; quartiles {q[0]:.1f}, {q[2]:.1f} ms; "
          f"the mix's path {mix['arrival_seed']} scores {scores.get(mix['arrival_seed'], float('nan')):.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
