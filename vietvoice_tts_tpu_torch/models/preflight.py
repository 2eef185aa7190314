"""Conversion-day preflight: validate a reference tarball BEFORE converting.

The decisive numerics event — converted real weights passing the mel golden
gate against the actual ONNX graphs (reference I/O contract at
``vietvoicetts/core/tts_engine.py:228-230``) — can only run
once ``model-bin.pt`` is in hand. This tool turns "fails 40 minutes into
conversion" into "fails in 5 seconds with a checklist" by checking, read-only
and without touching the network or a device:

1. **Graph presence** — the three expected graphs exist in the tarball
   (``preprocess.onnx`` / ``transformer.onnx`` / ``decode.onnx``, layout at
   ``vietvoicetts/core/model.py:65-106``).
2. **Evaluator op coverage** — each graph's op histogram
   (``probe.probe_graph``) diffed against the numpy evaluator's registry
   (``onnx_eval._OPS``). Any op outside the registry would abort the golden
   gate's reference side mid-run as ``UnsupportedOp``; preflight lists them
   per graph up front.
3. **Architecture constructibility** — probed facts (``infer_architecture``)
   must be conflict-free and must produce a valid ``ModelConfig`` /
   ``DiTConfig`` / ``VocoderConfig`` (dim divisible by heads, bucket grid
   divisibility, embedding-table row convention vs ``vocab.txt``); plus
   the attention route the probed head shape takes on the card: kernel 1
   (``csrc/fused_rope_attention.cu``) or kernel 2
   (``csrc/flash_attention.cu``) — a head shape neither kernel takes is an
   error, because the card cannot serve it.
4. **Name-map + heuristic weight coverage** — a dry-run of the exact
   resolution the converter performs (``map_initializers_to_params``):
   which parameter leaves the auto-discovered name map pins, which fall to
   shape/orientation heuristics, which are UNRESOLVED, and which explicit
   map entries are stale (reference initializers that don't exist in this
   tarball).

The report is one JSON document; ``ok`` is true only when conversion would
produce a complete, non-synthetic pack and the golden gate's evaluator side
can run every node. CLI::

    python -m vietvoice_tts_tpu_torch.models.preflight model-bin.pt [--out report.json]
"""

from __future__ import annotations

import tarfile
from pathlib import Path
from typing import Dict, Optional

from ..utils.logging import get_logger
from .onnx_eval import _OPS
from .probe import (
    infer_architecture,
    initializer_orientations,
    load_models_from_tarball,
    probe_graph,
)

log = get_logger("preflight")

EXPECTED_GRAPHS = ("preprocess", "transformer", "decode")

# Graph I/O arity from the reference's session calls
# (core/tts_engine.py:133-187): preprocess → 8 outputs (noise, 4 rope
# tables, cond/uncond embeddings, ref_signal_len); transformer consumes 8
# tensors (those minus ref_signal_len, plus time_step) and yields
# (noise', time_step'); decode maps (noise, ref_signal_len) → waveform.
_IO_ARITY = {
    "preprocess": {"min_inputs": 3, "min_outputs": 8},
    "transformer": {"min_inputs": 7, "min_outputs": 2},
    "decode": {"min_inputs": 2, "min_outputs": 1},
}


def _read_vocab_size(tar_path) -> Optional[int]:
    """Line count of vocab.txt inside the tarball (None when absent)."""
    with tarfile.open(tar_path, "r") as tar:
        for member in tar.getmembers():
            if member.isfile() and Path(member.name).name == "vocab.txt":
                fh = tar.extractfile(member)
                if fh is None:
                    return None
                return sum(
                    1 for _ in fh.read().decode("utf-8").splitlines()
                )
    return None


def _op_coverage(models) -> Dict[str, dict]:
    """Per-graph op histogram vs the onnx_eval registry."""
    out: Dict[str, dict] = {}
    for stem, model in models.items():
        hist = probe_graph(model)["op_histogram"]
        unsupported = sorted(op for op in hist if op not in _OPS)
        out[stem] = {
            "num_nodes": sum(hist.values()),
            "op_histogram": hist,
            "unsupported_ops": unsupported,
        }
    return out


def attention_route(heads: int, head_dim: int, n_frames: int) -> dict:
    """The DiT's attention route on the card for this head shape (the choice
    ``models/dit.py:DiT._attend`` makes): ``kernel`` 1 (the fused RoPE
    attention on the packed QKV), 2 (the split-heads route's attention), or
    None when neither kernel takes the shape — with ``use_kernels`` such a
    model raises on the card. Both kernels take any frame count."""
    from ..ops.kernels import flash_attention, fused_rope_attention

    shape = f"heads={heads} head_dim={head_dim}"
    if fused_rope_attention.supports_shape(heads, head_dim, n_frames):
        return {"kernel": 1, "advice": (
            f"{shape}: kernel 1 serves attention (csrc/fused_rope_attention.cu, "
            "RoPE fused on the packed QKV)")}
    if flash_attention.supports_shape(heads, head_dim, n_frames):
        return {"kernel": 2, "advice": (
            f"{shape}: kernel 2 serves attention on the split-heads route "
            "(csrc/flash_attention.cu)")}
    return {"kernel": None, "advice": (
        f"{shape}: no CUDA attention kernel takes head_dim {head_dim} (kernel 1: "
        f"{fused_rope_attention.HEAD_DIMS}, kernel 2: {flash_attention.HEAD_DIMS}) "
        "— the card cannot serve this model with use_kernels")}


def _architecture_checks(arch: dict, vocab_size: Optional[int]) -> dict:
    """Probed facts → constructibility verdicts + advisory notes."""
    from .convert import apply_probed_architecture
    from .dit import DiTConfig
    from .vocoder import VocoderConfig

    result: dict = {
        "facts": arch.get("facts", {}),
        "conflicts": arch.get("conflicts", {}),
        "errors": [],
        "notes": [],
    }
    for fact, votes in arch.get("conflicts", {}).items():
        result["errors"].append(
            f"conflicting graph evidence for {fact}: {votes} "
            f"(sources: {[s['from'] for s in arch.get('evidence', {}).get(fact, [])]})"
        )

    facts = arch.get("facts", {})
    try:
        cfg = apply_probed_architecture(None, arch)
    except ValueError as e:
        result["errors"].append(str(e))
        result["config"] = None
        return result

    # Field-level validity the dataclasses would otherwise only trip at
    # trace time.
    if cfg.dit_dim % cfg.dit_heads:
        result["errors"].append(
            f"dim {cfg.dit_dim} is not divisible by heads {cfg.dit_heads}"
        )
    try:
        dit_cfg = DiTConfig(
            dim=cfg.dit_dim, depth=cfg.dit_depth, heads=cfg.dit_heads,
            ff_mult=cfg.dit_ff_mult, n_mels=cfg.n_mels, text_dim=cfg.text_dim,
            text_conv_layers=cfg.text_conv_layers,
        )
        VocoderConfig(
            dim=cfg.vocoder_dim, intermediate_dim=cfg.vocoder_intermediate_dim,
            num_layers=cfg.vocoder_num_layers, n_mels=cfg.n_mels,
            n_fft=cfg.n_fft, hop_length=cfg.hop_length,
        )
    except Exception as e:  # noqa: BLE001 — report, don't crash preflight
        result["errors"].append(f"model config not constructible: {e}")
        result["config"] = None
        return result

    route = attention_route(dit_cfg.heads, dit_cfg.head_dim, cfg.max_frames)
    (result["notes"] if route["kernel"] else result["errors"]).append(route["advice"])
    result["attention_route"] = route
    if cfg.n_fft % cfg.hop_length:
        result["notes"].append(
            f"n_fft {cfg.n_fft} not divisible by hop {cfg.hop_length}: "
            "overlap-add stride count is fractional — verify the iSTFT head"
        )
    rows = facts.get("embedding_rows")
    if rows is not None and vocab_size is not None and rows not in (
        vocab_size,
        vocab_size + 1,
    ):
        result["errors"].append(
            f"char-embedding table has {rows} rows but vocab.txt has "
            f"{vocab_size} entries (expected {vocab_size} or {vocab_size + 1}) "
            "— the filler-row convention must be resolved in the name map"
        )
    result["config"] = {
        f: getattr(cfg, f)
        for f in (
            "dit_dim", "dit_depth", "dit_heads", "text_dim", "text_conv_layers",
            "n_mels", "n_fft", "hop_length", "vocoder_dim",
            "vocoder_intermediate_dim", "vocoder_num_layers",
        )
    }
    return result


def _weight_coverage(models, tar_path, name_map, vocab_size, arch) -> dict:
    """Dry-run the converter's leaf resolution; classify each leaf.

    ``arch`` is the probe result preflight_report already computed (the
    transformer graph walk is the expensive part — don't repeat it)."""
    from ..config import ModelConfig
    from .convert import (
        _auto_name_map,
        _spec_entries,
        apply_probed_architecture,
        map_initializers_to_params,
    )
    from .dit import DiTConfig, init_dit_params
    from .vocoder import VocoderConfig, init_vocoder_params

    try:
        cfg = apply_probed_architecture(None, arch)
    except ValueError:
        cfg = ModelConfig(device="cpu")  # architecture errors are reported elsewhere

    merged = {
        f"{stem}.{name}": t.array
        for stem, m in models.items()
        for name, t in m.graph.initializers.items()
        if t.array is not None
    }
    map_source = "(explicit)"
    stale: list[str] = []
    if name_map is None:
        auto, map_source = _auto_name_map(tar_path)
        if auto:
            name_map = {}
            for leaf, spec in auto.items():
                missing = [
                    e["name"] for e in _spec_entries(spec) if e["name"] not in merged
                ]
                if missing:
                    stale.append(leaf)
                else:
                    name_map[leaf] = spec
    elif name_map:
        stale = [
            leaf
            for leaf, spec in name_map.items()
            if any(e["name"] not in merged for e in _spec_entries(spec))
        ]

    dit_cfg = DiTConfig(
        dim=cfg.dit_dim, depth=cfg.dit_depth, heads=cfg.dit_heads,
        ff_mult=cfg.dit_ff_mult, n_mels=cfg.n_mels, text_dim=cfg.text_dim,
        text_conv_layers=cfg.text_conv_layers,
        vocab_size=vocab_size or cfg.vocab_size,
    )
    voc_cfg = VocoderConfig(
        dim=cfg.vocoder_dim, intermediate_dim=cfg.vocoder_intermediate_dim,
        num_layers=cfg.vocoder_num_layers, n_mels=cfg.n_mels, n_fft=cfg.n_fft,
        hop_length=cfg.hop_length,
    )
    template = {
        "dit": init_dit_params(0, dit_cfg),
        "vocoder": init_vocoder_params(1, voc_cfg),
    }
    orientations = {
        f"{stem}.{name}": orient
        for stem, m in models.items()
        for name, orient in initializer_orientations(m.graph).items()
    }
    _params, report = map_initializers_to_params(
        merged, template, name_map=name_map, orientations=orientations
    )
    mapped = name_map or {}
    by_map = sorted(p for p in report["resolved"] if p in mapped)
    by_heuristic = sorted(p for p in report["resolved"] if p not in mapped)
    return {
        "name_map_source": map_source,
        "name_map_entries": len(mapped),
        "name_map_stale_entries": sorted(stale),
        "initializers": len(merged),
        "leaves_total": len(report["resolved"]) + len(report["unresolved"]),
        "resolved_by_map": len(by_map),
        "resolved_by_heuristic": len(by_heuristic),
        "heuristic_leaves": by_heuristic,
        "unresolved_leaves": sorted(report["unresolved"]),
        "unused_initializers": report["unused_initializers"],
        "transposed": len(report["transposed"]),
    }


def preflight_report(
    tar_path, name_map: Optional[dict] = None
) -> dict:
    """Run every preflight check against one reference tarball.

    Returns a JSON-serializable report; ``report["ok"]`` is True only when
    conversion + the golden gate can run to completion. ``blockers`` lists
    what must be fixed first; ``warnings`` lists advisory findings that do
    not block conversion (heuristic-resolved leaves, unused initializers,
    I/O-arity surprises).
    """
    tar_path = Path(tar_path)
    models = load_models_from_tarball(tar_path)
    models = {k: v for k, v in models.items() if k in EXPECTED_GRAPHS}
    vocab_size = _read_vocab_size(tar_path)

    blockers: list[str] = []
    warnings: list[str] = []

    missing = [g for g in EXPECTED_GRAPHS if g not in models]
    for g in missing:
        blockers.append(f"graph {g}.onnx missing from tarball")
    if vocab_size is None:
        blockers.append("vocab.txt missing from tarball")

    ops = _op_coverage(models)
    for stem, entry in ops.items():
        for op in entry["unsupported_ops"]:
            blockers.append(
                f"{stem}.onnx uses op '{op}' (×{entry['op_histogram'][op]}) "
                "not in the numpy evaluator registry — the golden gate's "
                "reference side would raise UnsupportedOp; extend "
                "models/onnx_eval.py first"
            )

    arch = infer_architecture(models) if models else {"facts": {}, "conflicts": {}}
    arch_report = _architecture_checks(arch, vocab_size) if models else {
        "facts": {}, "conflicts": {}, "errors": [], "notes": [], "config": None,
    }
    blockers.extend(arch_report["errors"])

    # Topology-level verification (round-4 verdict #2): the per-block op
    # sequence of transformer.onnx against the model's block, and the DSP
    # constants embedded in preprocess.onnx against the frontend's
    # assumptions. A structurally different export fails HERE in seconds,
    # not 40 minutes into the golden gate.
    from ..config import ModelConfig
    from .topology import verify_preprocess, verify_transformer

    topo: Dict[str, dict] = {}
    if "transformer" in models:
        topo["transformer"] = verify_transformer(
            models["transformer"],
            arch.get("facts", {}),
            expected_sway_coef=ModelConfig.sway_sampling_coef,
        )
        blockers.extend(
            f"transformer topology: {e}" for e in topo["transformer"]["errors"]
        )
        warnings.extend(
            f"transformer topology: {w}" for w in topo["transformer"]["warnings"]
        )
    if "preprocess" in models:
        topo["preprocess"] = verify_preprocess(
            models["preprocess"], arch.get("facts", {})
        )
        blockers.extend(
            f"preprocess constants: {e}" for e in topo["preprocess"]["errors"]
        )
        warnings.extend(
            f"preprocess constants: {w}" for w in topo["preprocess"]["warnings"]
        )

    io_report: Dict[str, dict] = {}
    for stem, model in models.items():
        g = model.graph
        arity = _IO_ARITY[stem]
        io_report[stem] = {
            "inputs": [v.name for v in g.inputs],
            "outputs": [v.name for v in g.outputs],
        }
        if len(g.inputs) < arity["min_inputs"] or len(g.outputs) < arity["min_outputs"]:
            warnings.append(
                f"{stem}.onnx I/O arity {len(g.inputs)}→{len(g.outputs)} is "
                f"below the reference contract "
                f"({arity['min_inputs']}→{arity['min_outputs']}, "
                "core/tts_engine.py:228-230) — confirm the export variant"
            )

    weights = (
        _weight_coverage(models, tar_path, name_map, vocab_size, arch)
        if models
        else None
    )
    if weights is not None:
        for leaf in weights["unresolved_leaves"]:
            blockers.append(
                f"parameter leaf '{leaf}' unresolved — the pack would ship "
                "seeded weights there (synthetic=true); extend the name map"
            )
        if weights["name_map_stale_entries"]:
            warnings.append(
                f"{len(weights['name_map_stale_entries'])} name-map entries "
                "reference initializers absent from this tarball (stale; "
                "their leaves fall back to heuristics): "
                f"{weights['name_map_stale_entries'][:5]}"
            )
        if weights["heuristic_leaves"]:
            warnings.append(
                f"{len(weights['heuristic_leaves'])} leaves resolved by "
                "shape/orientation heuristics rather than the explicit map "
                "— correct if shapes are unambiguous, but pin them in the "
                "name map for an auditable conversion"
            )
        if weights["unused_initializers"]:
            warnings.append(
                f"{len(weights['unused_initializers'])} graph initializers "
                "were not consumed by any parameter leaf (constants/shape "
                "tensors are expected here; large float tensors are not): "
                f"{weights['unused_initializers'][:5]}"
            )

    report = {
        "tarball": str(tar_path),
        "ok": not blockers,
        "blockers": blockers,
        "warnings": warnings,
        "graphs_found": sorted(models),
        "vocab_size": vocab_size,
        "op_coverage": ops,
        "architecture": arch_report,
        "topology": topo,
        "io_contract": io_report,
        "weights": weights,
    }
    log.info(
        "Preflight %s: %s (%d blockers, %d warnings)",
        tar_path,
        "OK" if report["ok"] else "BLOCKED",
        len(blockers),
        len(warnings),
    )
    return report


def main(argv=None) -> int:  # pragma: no cover — thin CLI
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tarball", help="reference model-bin.pt")
    ap.add_argument("--name-map", default=None, help="explicit name_map.json")
    ap.add_argument("--out", default=None, help="write JSON here instead of stdout")
    args = ap.parse_args(argv)
    nm = json.loads(Path(args.name_map).read_text()) if args.name_map else None
    report = preflight_report(args.tarball, name_map=nm)
    text = json.dumps(report, indent=2, default=str)
    if args.out:
        Path(args.out).write_text(text)
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(text)
    # Per-block topology verdict (round-4 verdict #2 'Done' criterion).
    tr_topo = report.get("topology", {}).get("transformer")
    if tr_topo:
        s = tr_topo["summary"]
        n = s["attention_blocks"]
        print(
            f"topology: {n} attention blocks — pre-norm {s['pre_norm_ok']}/{n}, "
            f"AdaLN {s['adaln_ok']}/{n}, RoPE {s['rope_ok']}/{n}, "
            f"attn-core {s['attn_core_ok']}/{n}, "
            f"gated-residual {s['gated_residual_ok']}/{n}, "
            f"FFN {s['ffn_ok']}/{n}; "
            f"euler={'ok' if tr_topo['euler'].get('ok') else 'FAIL'} "
            f"cfg={'ok' if tr_topo['cfg'].get('ok') else 'FAIL'} "
            f"time_grid={tr_topo['time_grid'].get('match')}",
            file=sys.stderr,
        )
    pre_topo = report.get("topology", {}).get("preprocess")
    if pre_topo:
        print(
            "preprocess constants: "
            + ("ok " if pre_topo["ok"] else "FAIL ")
            + str({k: (v if not isinstance(v, dict) else "ok")
                   for k, v in pre_topo["checks"].items()}),
            file=sys.stderr,
        )
    print(
        ("PREFLIGHT OK — conversion can proceed" if report["ok"]
         else f"PREFLIGHT BLOCKED — {len(report['blockers'])} blockers"),
        file=sys.stderr,
    )
    return 0 if report["ok"] else 1


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
