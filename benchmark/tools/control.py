"""Readings of the output check's number without the program: the plain
reference in float32 against itself computed in a lower precision, on the
requests a run of the cell would compare.

    python -m benchmark.tools.control --workload <cell> --seeds 1,2,3 \
        [--seconds 30] [--precisions fp8,bfloat16]

``fp8`` is the control (the precision below the configuration's
bfloat16): the check has to fail it. ``bfloat16`` rounds the same products'
operands to bfloat16, an estimate of what a sound bfloat16 program reads.
The run's sample is taken as if every request of the schedule had finished.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def readings(model: dict, mix: dict, seed: int, seconds: float, precisions, device) -> dict:
    """One seed's readings: the sampled requests' reference in float32, and
    its relative error in each of ``precisions``."""
    from .. import pack, spec
    from ..reference import check
    from ..weights import make_weights

    gen = spec.generator(mix["kind"])
    voices = pack.voices(seed, model["audio"]["sample_rate"])
    reqs = gen.requests(mix, model, voices, seed, seconds)
    lengths = {r["i"]: len(r["text"]) for r in reqs}
    picked = check.sample([{"i": r["i"], "ok": True} for r in reqs], lengths,
                          mix["check"]["sample"], seed)
    weights = make_weights(model, seed, device)
    out = {"seed": seed, "requests": len(picked)}
    t0 = time.perf_counter()
    ref = [check.expected_pcm(reqs[i]["text"], voices[reqs[i]["voice"]], model, weights,
                              device) for i in picked]
    out["reference_s"] = time.perf_counter() - t0
    out["audio_s"] = sum(len(r) for r in ref) / model["audio"]["sample_rate"]
    out["rms"] = [float(torch.tensor(r, dtype=torch.float64).pow(2).mean().sqrt()) for r in ref]
    for p in precisions:
        errs = [check.relative_error(
            check.expected_pcm(reqs[i]["text"], voices[reqs[i]["voice"]], model, weights,
                               device, precision=p), r) for i, r in zip(picked, ref)]
        out[p] = {"max": max(errs), "each": errs}
    return out


def main(argv=None) -> int:
    from .. import spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--precisions", default="fp8,bfloat16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    cfg, mix = spec.config(cell["config"]), spec.mix(cell["traffic"])
    model = spec.model(cfg)
    for seed in [int(s) for s in args.seeds.split(",")]:
        out = readings(model, mix, seed, args.seconds, args.precisions.split(","), "cuda")
        print("CONTROL " + json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
