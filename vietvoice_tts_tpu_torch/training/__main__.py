"""``python -m vietvoice_tts_tpu_torch.training`` — train the DiT from a manifest.

The JAX trainer's flags (``vietvoice_tts_tpu/training/__main__.py``), plus
``--device`` (default ``cuda``; without a card the command exits 1 and
trains nothing, ``--device cpu`` trains on the CPU). A pack that already
lies under ``--model-cache-dir`` decides the model's widths; the trained DiT
is written back into it. ``--mesh-data`` / ``--mesh-model`` above 1 train
on a mesh of ranks: launch every rank with the same command under
``torchrun --nproc-per-node <data × model>``; outside such a launch the
command exits 1 with a message that names ``torchrun``. Rank 0 alone
prints, checkpoints and exports.
"""

from __future__ import annotations

import argparse
import sys

from ..cli import _config_for_pack
from ..parallel.mesh import launch_mesh
from .loop import TrainRunConfig, train
from .train import TrainConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="vietvoice-tts-torch-train")
    ap.add_argument("--manifest", default=None, help="JSON-lines {audio, text} manifest")
    ap.add_argument("--steps", type=int, default=10_000)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--learning-rate", type=float, default=1e-4)
    ap.add_argument("--checkpoint-dir", default="checkpoints/dit")
    ap.add_argument("--model-cache-dir", default=None)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument(
        "--device",
        default="cuda",
        help="Where to train: cuda (default; fails without a card), cuda:<index> or cpu",
    )
    return ap


def main() -> None:
    args = build_parser().parse_args()
    kwargs = dict(
        device=args.device, mesh_data_axis=args.mesh_data, mesh_model_axis=args.mesh_model
    )
    if args.model_cache_dir:
        kwargs["model_cache_dir"] = args.model_cache_dir
    try:
        # A pack that exists already decides the architecture (as in the CLI).
        config = _config_for_pack(kwargs)
        mesh = launch_mesh(args.mesh_data, args.mesh_model)
    except (RuntimeError, ValueError) as e:  # no CUDA device; a mesh without its ranks
        print(f"Error: {e}", file=sys.stderr)
        sys.exit(1)
    lead = mesh is None or mesh.rank == 0
    if lead:
        print(f"Device: {config.device}", flush=True)
    summary = train(
        model_config=config,
        train_config=TrainConfig(learning_rate=args.learning_rate),
        run_config=TrainRunConfig(
            steps=args.steps,
            batch_size=args.batch_size,
            checkpoint_dir=args.checkpoint_dir,
        ),
        manifest_path=args.manifest,
        mesh=mesh,
    )
    if lead:
        print({k: summary[k] for k in ("final_step", "final_loss")})


if __name__ == "__main__":
    main()
