"""Find the highest rate an open-loop cell sustains: one set-up, then a
window at each offered rate, lowest first.

    python -m benchmark.tools.sweep --workload <cell> --seed <n> \
        --rates 8,10,12,14 [--seconds 20]

For each rate it prints the completed audio-s/s and requests/s, the
latency's median and 95th percentile from the due time, the median of the
last quarter of the requests against the first quarter's (a backlog that
grows shows as a ratio well above 1) and how long after the last due time
the last response came. The rate found goes into the mix file by hand.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

import torch


def main(argv=None) -> int:
    from .. import pack, spec
    from ..run import load_program
    from ..traffic import common
    from ..weights import make_weights

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seeds", default="", help="the requests' seeds, a window each at each rate")
    ap.add_argument("--arrival-seed", type=int, default=None,
                    help="the arrival path's seed in place of the mix's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    cfg, mix = spec.config(cell["config"]), spec.mix(cell["traffic"])
    model = spec.model(cfg)
    gen = spec.generator(mix["kind"])
    voices = pack.voices(args.seed, model["audio"]["sample_rate"])
    rates = [float(r) for r in args.rates.split(",")]
    seeds = [int(x) for x in args.seeds.split(",")] if args.seeds else [args.seed]
    if args.arrival_seed is not None:
        mix = {**mix, "arrival_seed": args.arrival_seed}
    plans = {(r, s): gen.requests({**mix, "rate_rps": r}, model, voices, s, args.seconds)
             for r in rates for s in seeds}
    buckets = sorted({b for reqs in plans.values() for b in common.buckets(reqs, voices, model)})
    weights_np = pack.to_numpy(make_weights(model, args.seed, "cuda"))
    tmp = Path(tempfile.mkdtemp(prefix="vv-sweep-"))
    api = load_program(cfg, mix, model, args.seed, weights_np, voices, buckets, tmp, "cuda")
    sr = model["audio"]["sample_rate"]
    try:
        for rate, seed in plans:
            reqs = plans[(rate, seed)]
            out = gen.drive(reqs, {**mix, "rate_rps": rate}, model, voices, api,
                            seconds=args.seconds)
            recs = out["records"]
            ok = [r for r in recs if r.get("ok")]
            span = max(r["end"] for r in ok) - out["start"]
            lat = [(r["end"] - r["due"]) * 1e3 for r in ok]
            q = max(1, len(recs) // 4)
            first = sorted((r["end"] - r["due"]) * 1e3 for r in recs[:q] if r.get("ok"))
            last = sorted((r["end"] - r["due"]) * 1e3 for r in recs[-q:] if r.get("ok"))
            print("SWEEP " + json.dumps({
                "rate_rps": rate, "seed": seed, "requests": len(recs), "failed": len(recs) - len(ok),
                "audio_s_per_s": sum(len(r["pcm"]) for r in ok) / sr / span,
                "completed_rps": len(ok) / span,
                "p50_ms": common.percentile(lat, 50), "p95_ms": common.percentile(lat, 95),
                "last_over_first_quarter": common.percentile(last, 50)
                / max(common.percentile(first, 50), 1e-9),
                "drain_s": max(r["end"] for r in ok) - (out["start"] + reqs[-1]["due"]),
            }), flush=True)
    finally:
        api.cleanup()
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
