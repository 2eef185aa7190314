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

Runnable forms::

    python -m vietvoice_tts_tpu_torch.golden --onnx-tarball model-bin.pt
    python -m vietvoice_tts_tpu_torch.golden --onnx-tarball model-bin.pt --save-ref ref.npz
    python -m vietvoice_tts_tpu_torch.golden --ref-npz ref.npz --pack packs/v1
    python -m vietvoice_tts_tpu_torch.golden --cpu --onnx-tarball f5_fixture.pt

Prints ONE JSON line; status "skipped" (with the reason) when the reference
artifacts are absent. The torch side runs on the card unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
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
    """Shared input prep: (wave, ref_len, ids, total_len, noise, ref_mel)."""
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
    return wave, ref_len, ids, n_frames, noise, ref_mel


def torch_latent(pack_dir, ref: dict, **config_overrides) -> tuple[np.ndarray, dict]:
    """The port's final mel latent from the reference's noise → (latent
    [1, N, n_mels], info). ``config_overrides`` reach the ModelConfig
    (``device``, ``compute_dtype``, ``use_kernels``, ...)."""
    from .runtime.engine_core import EngineCore, _true_float32
    from .runtime.serialization import load_params
    from .runtime.session import config_from_pack

    pack = Path(pack_dir)
    cfg = config_from_pack(pack, nfe_step=int(ref["nfe_step"]), **config_overrides)
    params = load_params(pack / "params.msgpack")
    core = EngineCore(cfg, params, cfg.vocab_size)

    wave, ref_len, ids, n_frames, noise, ref_mel = _latent_inputs(cfg, pack, ref)
    # The f32 numerics mode is true float32: TF32 would feed the tensor
    # cores 10-bit mantissas and drift the 31-step solve (the counterpart of
    # the JAX harness's jax.default_matmul_precision("highest")).
    f32_mode = cfg.compute_dtype == "float32"
    with _true_float32() if f32_mode else contextlib.nullcontext():
        latent = core.mel_latent_batch(
            wave,
            np.asarray([ref_len], np.int32),
            ids[None],
            np.asarray([n_frames], np.int32),
            x0=noise,
        )
    return latent, {"ref_mel": ref_mel, "ref_len": ref_len, "n_frames": int(n_frames)}


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
    args = ap.parse_args(argv)

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

    overrides = {"device": "cpu" if args.cpu else "cuda"}
    if not args.serving_precision:
        overrides["compute_dtype"] = "float32"
    result = torch_side(pack, ref, atol=args.atol, **overrides)
    result["precision"] = "serving" if args.serving_precision else "float32"
    print(json.dumps(result))
    return 0 if result["allclose"] else 1


if __name__ == "__main__":
    sys.exit(main())
