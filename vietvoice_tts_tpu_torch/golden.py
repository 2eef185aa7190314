"""Golden numerics harness of the PyTorch port: mel comparison vs the ONNX reference.

The port's counterpart of the repo's root ``golden.py``. BASELINE.json gates
numerics on "mel allclose (atol 1e-2) vs the ONNX reference per utterance".
ORT's noise cannot be reproduced in torch, so the protocol shares the
*reference's* noise tensor (reference loop semantics at
``vietvoicetts/core/tts_engine.py:148-187``):

1. **Reference side** (:func:`reference_side`): run the preprocess graph,
   capture its noise tensor, run the transformer loop to the final mel
   latent. onnxruntime runs the graphs where it is installed, else the
   package's numpy evaluator (``models/onnx_eval.py``); the card's machine
   has no onnxruntime, so the evaluator serves there. ``--save-ref out.npz``
   keeps these arrays, so the reference side runs once.
2. **Torch side** (:func:`torch_side`): convert the tarball into a weight
   pack (``models/convert.py``), rebuild the conditioning from the same
   reference audio, and integrate the port's sampler from the SAME noise via
   ``EngineCore.mel_latent_batch(x0=...)``.
3. Compare final mel latents over the synthesized (non-reference) region:
   MAE, max-abs, allclose at ``--atol``.

Besides the gate, the harness prices the serving knobs on one pack, each
from one shared noise, drift REPORTED, not judged (:func:`precision_drift`,
:func:`cfg_cache_sweep`, :func:`deep_cache_sweep`).

Runnable forms::

    python -m vietvoice_tts_tpu_torch.golden --onnx-tarball model-bin.pt
    python -m vietvoice_tts_tpu_torch.golden --onnx-tarball model-bin.pt --save-ref ref.npz
    python -m vietvoice_tts_tpu_torch.golden --ref-npz ref.npz --pack packs/v1
    python -m vietvoice_tts_tpu_torch.golden --cpu --onnx-tarball f5_fixture.pt
    python -m vietvoice_tts_tpu_torch.golden --precision-drift 384,448,512,704 --pack packs/v1
    python -m vietvoice_tts_tpu_torch.golden --cfg-cache-sweep 1,2,4 --ref-npz ref.npz \
        --pack packs/v1 --serving-precision
    python -m vietvoice_tts_tpu_torch.golden --deep-cache-sweep 1:7,2:7,2:11,3:7 \
        --ref-npz ref.npz --pack packs/v1 --serving-precision

Prints ONE JSON line; status "skipped" (with the reason) when the reference
artifacts are absent. Everything runs on the card unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


# ---------------------------------------------------------------------------
# Reference side (runs the ONNX graphs)
# ---------------------------------------------------------------------------


def _session_factory():
    """ORT when installed, else the built-in numpy evaluator
    (``models/onnx_eval.py``) — same ``run``/``get_inputs`` surface."""
    try:
        import onnxruntime as ort

        return lambda data: ort.InferenceSession(data)
    except ImportError:
        from .models.onnx_eval import EvalSession

        return EvalSession


def reference_side(tarball: str, text: str, nfe_step: int = 32) -> dict:
    """Run the reference graphs → {audio, combined_text, noise, ref_mel,
    ref_signal_len, nfe_step}. Mirrors ``core/tts_engine.py:133-187``.
    ``nfe_step`` must match the graph's embedded schedule (32 for the real
    model, ``core/model_config.py:29``; fixture tests use fewer)."""
    import tarfile

    from .models.convert import extract_assets
    from .pipeline.audio import AudioProcessor
    from .pipeline.text import TextProcessor

    make_session = _session_factory()

    with tempfile.TemporaryDirectory() as td:
        assets = extract_assets(tarball, td)
        if not assets["vocab"]:
            raise RuntimeError("tarball holds no vocab.txt")
        tp = TextProcessor(str(Path(td) / "vocab.txt"))
        meta = json.loads((Path(td) / "audio_metadata.json").read_text())
        sample = meta[0]
        ref_audio_path = Path(td) / "audios" / sample["file_name"]
        ref_text = sample["text"]

        ap = AudioProcessor()
        ref_int16 = ap.load_audio(str(ref_audio_path), 24000)
        audio_f32 = ref_int16.astype(np.float32)

        sessions = {}
        with tarfile.open(tarball) as tar:
            for member in tar.getmembers():
                if member.name.endswith(".onnx"):
                    stem = Path(member.name).stem
                    sessions[stem] = make_session(tar.extractfile(member).read())
        pre, trans = sessions["preprocess"], sessions["transformer"]

        combined = tp.clean_text(ref_text) + tp.clean_text(text)
        # Reference feeds [1, L] int64 char ids (unk→0, text_processor.py:30).
        text_ids = tp.text_to_indices([list(combined)]).astype(np.int64)
        # Duration heuristic parity (core/tts_engine.py:54-64, speed 0.9).
        ref_frames = len(audio_f32) // 256 + 1
        rate = tp.calculate_text_length(ref_text, ".,?!:") / (len(audio_f32) / 24000.0)
        tgt_dur = max(tp.calculate_text_length(tp.clean_text(text), ".,?!:") / rate / 0.9, 1.0)
        max_duration = np.asarray([ref_frames + int(tgt_dur * 24000) // 256 + 1], np.int64)

        pre_inputs = {
            i.name: v
            for i, v in zip(
                pre.get_inputs(),
                (audio_f32.reshape(1, 1, -1), text_ids, max_duration),
            )
        }
        outs = pre.run(None, pre_inputs)
        noise, ref_signal_len = outs[0], outs[-1]

        t_names = [i.name for i in trans.get_inputs()]
        state = list(outs[: len(t_names) - 1]) + [np.asarray([0], np.int32)]
        for _ in range(0, nfe_step - 1):
            o = trans.run(None, dict(zip(t_names, state)))
            state[0], state[-1] = o[0], o[1]
        return {
            "audio": audio_f32 / 32768.0,
            "combined_text": combined,
            "noise": np.asarray(noise, np.float32),
            "ref_mel": np.asarray(state[0], np.float32),
            "ref_signal_len": int(np.asarray(ref_signal_len).reshape(-1)[0]),
            "nfe_step": nfe_step,
        }


# ---------------------------------------------------------------------------
# Torch side
# ---------------------------------------------------------------------------


def _as_latent_layout(a: np.ndarray, n_mels: int) -> np.ndarray:
    """Coerce a reference tensor into the [B, N, n_mels] layout."""
    a = np.asarray(a, np.float32)
    if a.ndim == 2:
        a = a[None]
    if a.shape[-1] != n_mels and a.shape[-2] == n_mels:
        a = np.swapaxes(a, -1, -2)  # [B, n_mels, N] → [B, N, n_mels]
    return a


def _latent_inputs(cfg, pack: Path, ref: dict):
    """Shared input prep → (``mel_latent_batch``'s positional arguments,
    noise, ref_mel, ref_len)."""
    from .pipeline.text import TextProcessor

    noise = _as_latent_layout(ref["noise"], cfg.n_mels)
    ref_mel = _as_latent_layout(ref["ref_mel"], cfg.n_mels)
    n_frames = noise.shape[1]
    hop = cfg.hop_length

    audio = np.asarray(ref["audio"], np.float32).reshape(-1)
    wave = np.zeros((1, n_frames * hop), np.float32)
    wave[0, : min(len(audio), n_frames * hop)] = audio[: n_frames * hop]

    tp = TextProcessor(str(pack / "vocab.txt"))
    ids, _ = tp.encode_padded(str(ref["combined_text"]), n_frames)
    ref_len = int(ref["ref_signal_len"])
    args = (wave, np.asarray([ref_len], np.int32), ids[None],
            np.asarray([n_frames], np.int32))
    return args, noise, ref_mel, ref_len


def torch_latent(pack_dir, ref: dict, **config_overrides) -> tuple[np.ndarray, dict]:
    """The port's final mel latent from the reference's noise → (latent
    [1, N, n_mels], info). ``config_overrides`` reach the ModelConfig
    (``device``, ``compute_dtype``, ``use_kernels``, ...)."""
    from .runtime.engine_core import EngineCore
    from .runtime.serialization import load_params
    from .runtime.session import config_from_pack

    pack = Path(pack_dir)
    cfg = config_from_pack(pack, nfe_step=int(ref["nfe_step"]), **config_overrides)
    core = EngineCore(cfg, load_params(pack / "params.msgpack"), cfg.vocab_size)
    args, noise, ref_mel, ref_len = _latent_inputs(cfg, pack, ref)
    # A float32 core runs its batches in true float32, TF32 off
    # (``EngineCore._numerics``): TF32 would feed the tensor cores 10-bit
    # mantissas and drift the 31-step solve. It is the counterpart of the
    # JAX harness's jax.default_matmul_precision("highest").
    latent = core.mel_latent_batch(*args, x0=noise)
    return latent, {"ref_mel": ref_mel, "ref_len": ref_len, "n_frames": int(noise.shape[1])}


def compare_latents(latent: np.ndarray, ref_mel: np.ndarray, ref_len: int,
                    atol: float = 1e-2) -> dict:
    """The golden report over the synthesized frames ``ref_len:``: padded
    query rows are garbage until the final mask, so only valid frames
    compare."""
    n_frames = latent.shape[1]
    target = slice(ref_len, n_frames)
    diff = np.abs(latent[0, target] - ref_mel[0, target])
    full_diff = np.abs(latent[0] - ref_mel[0])
    return {
        "metric": "mel_mae_vs_onnx",
        "status": "ok",
        "mel_mae": float(diff.mean()),
        "mel_max_abs": float(diff.max()),
        "mel_mae_full": float(full_diff.mean()),
        "allclose": bool(np.allclose(latent[0, target], ref_mel[0, target], atol=atol)),
        "atol": atol,
        "frames": int(n_frames),
        "ref_frames": ref_len,
    }


def torch_side(pack_dir, ref: dict, atol: float = 1e-2, **config_overrides) -> dict:
    """Integrate the port's sampler from the reference's noise; compare mels.

    ``ref`` needs: audio (f32 [-1,1]), combined_text, noise, ref_mel,
    ref_signal_len, nfe_step. Returns the comparison report (one dict, the
    keys of the JAX harness's ``tpu_side``). Fixture rehearsals pass
    ``compute_dtype="float32"`` to isolate conversion bugs from
    serving-precision noise; the real gate runs the serving default (bf16
    compute) because that is what ships."""
    latent, info = torch_latent(pack_dir, ref, **config_overrides)
    return compare_latents(latent, info["ref_mel"], info["ref_len"], atol)


def _free_device() -> None:
    """Return a released core's device memory before the next one is built."""
    import torch

    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _require_exact_first(interval: int, what: str) -> None:
    """A sweep's first setting is the baseline every row's drift and speedup
    are measured against, so it must be the exact solve (interval 1)."""
    if int(interval) != 1:
        raise ValueError(
            f"{what}: the first setting must be exact (interval 1), got {interval}: "
            "drift and speedup are measured against it"
        )


def _price(pack_dir, ref: dict, settings, repeats: int, config_overrides: dict) -> tuple:
    """Run the latent pipeline once per ``(row label, config knobs)`` from the
    reference's noise, the first setting the exact baseline → (rows, frames).

    The pack is loaded once; each setting builds its own ``EngineCore`` and
    releases it before the next. Per row: drift vs the baseline's latent
    over the synthesized frames, MAE vs ``ref["ref_mel"]`` and the best of
    ``repeats`` timed solves after an untimed first one (``mel_latent_batch``
    returns host numpy, so a solve's time ends after the device's work)."""
    from .runtime.engine_core import EngineCore
    from .runtime.serialization import load_params
    from .runtime.session import config_from_pack

    pack = Path(pack_dir)
    params = load_params(pack / "params.msgpack")
    rows, base_latent, n_frames = [], None, 0
    for label, knobs in settings:
        cfg = config_from_pack(pack, nfe_step=int(ref["nfe_step"]), **knobs,
                               **config_overrides)
        args, noise, ref_mel, ref_len = _latent_inputs(cfg, pack, ref)
        n_frames = noise.shape[1]
        core = EngineCore(cfg, params, cfg.vocab_size)
        latent = core.mel_latent_batch(*args, x0=noise)
        times = []
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            core.mel_latent_batch(*args, x0=noise)
            times.append(time.perf_counter() - t0)
        del core
        _free_device()
        target = slice(ref_len, n_frames)
        if base_latent is None:
            base_latent = latent
        drift = np.abs(latent[0, target] - base_latent[0, target])
        vs_ref = np.abs(latent[0, target] - ref_mel[0, target])
        rows.append({
            **label,
            "mel_mae_vs_exact": float(drift.mean()),
            "mel_max_abs_vs_exact": float(drift.max()),
            "mel_mae_vs_onnx": float(vs_ref.mean()),
            "latent_ms": round(min(times) * 1e3, 2),
        })
    base_ms = rows[0]["latent_ms"]
    for row in rows:
        row["speedup_vs_exact"] = round(base_ms / row["latent_ms"], 3) if row["latent_ms"] else None
    return rows, int(n_frames)


def cfg_cache_sweep(pack_dir, ref: dict, intervals=(1, 2, 4), repeats: int = 3,
                    **config_overrides) -> dict:
    """Price the CFG cache: mel drift + solve time per ``nfe_uncond_interval``.

    For each k the full latent pipeline runs from the SAME noise; k=1, which
    must come first (``ValueError`` otherwise), is the exact-reference
    baseline (``models/sampler.py``). Per k: mel MAE/max-abs drift vs the
    k=1 latent over the synthesized region, MAE vs the reference mel
    (``mel_mae_vs_onnx``) and the best-of-``repeats`` wall time of a solve.
    ``config_overrides`` reach the ModelConfig (``device``,
    ``compute_dtype``, ...)."""
    intervals = tuple(int(k) for k in intervals)
    _require_exact_first(intervals[0] if intervals else 0, "cfg_cache_sweep")
    rows, frames = _price(
        pack_dir, ref,
        [({"uncond_interval": k}, {"nfe_uncond_interval": k}) for k in intervals],
        repeats, config_overrides,
    )
    return {"metric": "cfg_cache_price", "frames": frames, "rows": rows}


def deep_cache_sweep(pack_dir, ref: dict, settings=((1, 7), (2, 7), (2, 11), (3, 7)),
                     repeats: int = 3, **config_overrides) -> dict:
    """Price the deep-block cache: mel drift + solve time per (interval r,
    shallow blocks j) setting (``models/sampler.py``), by the protocol of
    :func:`cfg_cache_sweep`; the first setting must have r=1, the exact
    baseline (``ValueError`` otherwise)."""
    settings = tuple((int(r), int(j)) for r, j in settings)
    _require_exact_first(settings[0][0] if settings else 0, "deep_cache_sweep")
    rows, frames = _price(
        pack_dir, ref,
        [({"deep_cache_interval": r, "deep_cache_blocks": j},
          {"nfe_deep_cache_interval": r, "nfe_deep_cache_blocks": j}) for r, j in settings],
        repeats, config_overrides,
    )
    return {"metric": "deep_cache_price", "frames": frames, "rows": rows}


def precision_drift(pack_dir, frames=(384, 448, 512, 704), ref_frames: int = 188,
                    seed: int = 0, **config_overrides) -> dict:
    """Serving-precision (bf16 compute) drift vs true f32, per frame bucket,
    on one pack — no ONNX side needed.

    Both runs integrate from the SAME injected noise on the SAME weights,
    drawn per bucket in the JAX harness's order (the reference wave, the
    text ids, the noise), so one seed gives both packages the same inputs;
    the only variable is the compute dtype. The JAX harness's serving side
    also rounds its device-to-host transfer to f16, a field of its TPU link
    that the port does not have. ``config_overrides`` reach both
    ModelConfigs (``device``, ...)."""
    from .runtime.engine_core import EngineCore
    from .runtime.serialization import load_params
    from .runtime.session import config_from_pack

    pack = Path(pack_dir)
    params = load_params(pack / "params.msgpack")
    cfg32 = config_from_pack(pack, **{**config_overrides, "compute_dtype": "float32"})
    cfg_srv = config_from_pack(pack, **config_overrides)  # the serving default dtype
    core32 = EngineCore(cfg32, params, cfg32.vocab_size)
    core_srv = EngineCore(cfg_srv, params, cfg_srv.vocab_size)

    rng = np.random.default_rng(seed)
    hop = cfg32.hop_length
    rows = []
    for n in frames:
        wave = np.zeros((1, n * hop), np.float32)
        wave[0, : ref_frames * hop] = rng.uniform(-0.4, 0.4, ref_frames * hop)
        ids = np.full((1, n), -1, np.int32)
        ids[0, : n // 2] = rng.integers(1, 60, n // 2)
        x0 = rng.standard_normal((1, n, cfg32.n_mels)).astype(np.float32)
        args = (wave, np.asarray([ref_frames], np.int32), ids, np.asarray([n], np.int32))
        lat32 = core32.mel_latent_batch(*args, x0=x0)
        lat_srv = core_srv.mel_latent_batch(*args, x0=x0)
        d = np.abs(lat32[0, ref_frames:] - lat_srv[0, ref_frames:])
        scale = float(np.abs(lat32[0, ref_frames:]).mean())
        rows.append({
            "frames": int(n),
            "mel_mae": float(d.mean()),
            "mel_max_abs": float(d.max()),
            "rel_mae": float(d.mean() / scale) if scale else None,
        })
    del core32, core_srv
    _free_device()
    return {
        "metric": "serving_precision_drift",
        "compute_dtype": str(cfg_srv.compute_dtype),
        "ref_frames": ref_frames,
        "rows": rows,
    }


def _skip(reason: str) -> int:
    print(json.dumps({"metric": "mel_mae_vs_onnx", "status": "skipped", "reason": reason}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--onnx-tarball", default=None, help="reference model-bin.pt")
    ap.add_argument("--pack", default=None, help="existing converted weight pack")
    ap.add_argument("--ref-npz", default=None, help="precomputed reference-side npz")
    ap.add_argument("--save-ref", default=None, help="write reference-side npz here")
    ap.add_argument("--name-map", default=None, help="JSON name_map for conversion")
    ap.add_argument("--text", default="Xin chào Việt Nam.")
    ap.add_argument("--nfe-step", type=int, default=32,
                    help="the schedule embedded in the transformer graph")
    ap.add_argument("--atol", type=float, default=1e-2)
    ap.add_argument("--cpu", action="store_true",
                    help="run the torch side on the CPU (default: the card)")
    ap.add_argument(
        "--serving-precision",
        action="store_true",
        help="run the torch side in the serving dtype (bf16 compute) instead "
        "of the default f32 numerics mode, which measures conversion "
        "correctness",
    )
    ap.add_argument(
        "--precision-drift",
        default=None,
        metavar="N1,N2,...",
        help="instead of the golden gate, measure bf16-serving vs f32 mel "
        "drift per frame bucket on --pack (no reference side needed)",
    )
    ap.add_argument(
        "--cfg-cache-sweep",
        default=None,
        metavar="K1,K2,...",
        help="instead of the golden gate, price the CFG cache: run the "
        "latent pipeline at each nfe_uncond_interval (e.g. 1,2,4; the first "
        "must be 1, the exact baseline) from the same noise and print mel "
        "drift vs exact + solve-time speedup",
    )
    ap.add_argument(
        "--deep-cache-sweep",
        default=None,
        metavar="R1:J1,R2:J2,...",
        help="instead of the golden gate, price the deep-block cache: run "
        "the latent pipeline at each (interval r, shallow blocks j) pair "
        "(e.g. 1:7,2:7,2:11; the first must have r=1, the exact baseline) "
        "from the same noise and print mel drift vs exact + solve-time speedup",
    )
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    # Sweep settings are checked before any reference or pack is read.
    try:
        frames = intervals = settings = None
        if args.precision_drift:
            frames = tuple(int(x) for x in args.precision_drift.split(","))
        if args.cfg_cache_sweep:
            intervals = tuple(int(x) for x in args.cfg_cache_sweep.split(","))
            _require_exact_first(intervals[0], "--cfg-cache-sweep")
        if args.deep_cache_sweep:
            settings = tuple(
                tuple(int(v) for v in pair.split(":", 1))
                for pair in args.deep_cache_sweep.split(",")
            )
            if any(len(s) != 2 for s in settings):
                raise ValueError("--deep-cache-sweep takes R:J pairs")
            _require_exact_first(settings[0][0], "--deep-cache-sweep")
    except ValueError as e:
        ap.error(str(e))

    if frames:
        if not args.pack:
            return _skip("--precision-drift needs --pack")
        print(json.dumps(precision_drift(args.pack, frames=frames, device=device)))
        return 0

    # -- acquire reference-side arrays ---------------------------------------
    if args.ref_npz:
        with np.load(args.ref_npz, allow_pickle=False) as z:
            ref = {k: z[k] for k in z.files}
    else:
        if not args.onnx_tarball:
            return _skip("no --onnx-tarball and no --ref-npz")
        from .models.onnx_eval import UnsupportedOp

        try:
            ref = reference_side(args.onnx_tarball, args.text, args.nfe_step)
        except UnsupportedOp as e:
            return _skip(
                f"graphs use op '{e}' outside the built-in evaluator's subset "
                "and onnxruntime is not installed — run the reference side "
                "elsewhere with --save-ref and pass --ref-npz here"
            )
        if args.save_ref:
            np.savez(
                args.save_ref,
                **{k: np.asarray(v) for k, v in ref.items() if k != "combined_text"},
                combined_text=np.asarray(str(ref["combined_text"])),
            )

    # -- acquire the weight pack ---------------------------------------------
    if args.pack:
        pack = Path(args.pack)
    else:
        if not args.onnx_tarball:
            return _skip("no --pack and no --onnx-tarball to convert")
        from .models.convert import convert_reference_tarball

        pack = Path(tempfile.mkdtemp(prefix="vv_golden_")) / "pack"
        name_map = (
            json.loads(Path(args.name_map).read_text()) if args.name_map else None
        )
        report = convert_reference_tarball(args.onnx_tarball, pack, name_map=name_map)
        weights = report.get("weights", {})
        if weights.get("skipped") or weights.get("unresolved"):
            return _skip(
                f"conversion incomplete: {weights.get('skipped') or weights['unresolved'][:5]}"
                " — extend the name map (see docs/CONVERSION_RUNBOOK.md)"
            )

    overrides = {"device": device}
    if not args.serving_precision:
        overrides["compute_dtype"] = "float32"
    precision = "serving" if args.serving_precision else "float32"
    if intervals:
        sweep = cfg_cache_sweep(pack, ref, intervals=intervals, **overrides)
        print(json.dumps({**sweep, "precision": precision}))
        return 0
    if settings:
        sweep = deep_cache_sweep(pack, ref, settings=settings, **overrides)
        print(json.dumps({**sweep, "precision": precision}))
        return 0
    result = torch_side(pack, ref, atol=args.atol, **overrides)
    result["precision"] = precision
    print(json.dumps(result))
    return 0 if result["allclose"] else 1


if __name__ == "__main__":
    sys.exit(main())
