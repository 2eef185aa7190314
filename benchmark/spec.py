"""What a run is made of, found by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), the configuration's backbone
(its ``"architecture"``, a module ``archs/<architecture>.py``), its traffic mix
(``traffic/<mix>.json``, whose ``kind`` names a generator module in
``traffic/``), the per-layer metrics' readers (``metrics/<metric>.py``) and
the limits of its output check (``limits/<cell>.json``).

A new cell, configuration, architecture, mix or metric is an entry in
``BENCHMARK.json`` and files of its own; nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK_JSON = ROOT / "BENCHMARK.json"


def benchmark() -> dict:
    return json.loads(BENCHMARK_JSON.read_text())


def cell(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def mix(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def limits(cell_name: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell_name}.json").read_text())


def architecture(name: str):
    """The module of the backbone called ``name`` (``archs/<name>.py``)."""
    return importlib.import_module(f"benchmark.archs.{name}")


def _architecture_of(cfg: dict):
    """The module of the backbone a configuration names: an error naming
    the file where it names none, or one that has no module."""
    where = f"benchmark/configs/{cfg.get('name')}.json"
    name = cfg.get("architecture")
    if not isinstance(name, str) or not name.isidentifier():
        raise ValueError(f"{where} names no architecture: it needs a top-level "
                         f"\"architecture\" key, the name of a module in benchmark/archs/")
    try:
        return architecture(name)
    except ModuleNotFoundError as e:
        if e.name != f"benchmark.archs.{name}":
            raise
        raise ValueError(f"{where} names the architecture {name!r}, but there is no module "
                         f"benchmark/archs/{name}.py") from e


def generator(kind: str):
    """The traffic module that serves mixes of this ``kind``."""
    return importlib.import_module(f"benchmark.traffic.{kind}")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(ctx)`` (a name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_for(cell_name: str, trace: bool) -> list[dict]:
    """The metrics a cell reports: its end-to-end ones without a trace, its
    per-layer ones with one."""
    spec = benchmark()
    out = []
    for m in spec["per_layer" if trace else "end_to_end"]:
        if "workloads" not in m or cell_name in m["workloads"]:
            out.append(m)
    return out


def model(cfg: dict) -> dict:
    """A configuration file's architecture and ModelConfig keys → the sizes
    and settings the benchmark's own code (weights, reference, traffic)
    reads; the backbone's sizes, under ``"dit"``, from its architecture."""
    mc = cfg["model_config"]
    arch = _architecture_of(cfg)
    from .reference.pipeline import VOCAB_CHARS

    return {
        "architecture": cfg["architecture"],
        "dit": arch.backbone(mc),
        "vocoder": {"dim": mc["vocoder_dim"], "intermediate_dim": mc["vocoder_intermediate_dim"],
                    "num_layers": mc["vocoder_num_layers"]},
        "audio": {"sample_rate": mc["sample_rate"], "n_mels": mc["n_mels"], "n_fft": mc["n_fft"],
                  "hop_length": mc["hop_length"], "win_length": mc["win_length"]},
        "sampler": {"nfe_step": mc["nfe_step"], "cfg_strength": mc["cfg_strength"],
                    "sway_sampling_coef": mc["sway_sampling_coef"]},
        "planning": {"max_chunk_duration": mc["max_chunk_duration"],
                     "min_target_duration": mc["min_target_duration"],
                     "cross_fade_duration": mc["cross_fade_duration"],
                     "frame_buckets": list(mc["frame_buckets"])},
        "speed": mc["speed"],
        "random_seed": mc["random_seed"],
        "max_batch_size": mc["max_batch_size"],
        "compute_dtype": mc["compute_dtype"],
        "vocab_size": len(VOCAB_CHARS),
    }
