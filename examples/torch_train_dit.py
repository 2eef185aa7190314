"""Train the flow-matching DiT with the PyTorch port, on one card or a mesh.

    python examples/torch_train_dit.py                          # one card
    torchrun --nproc-per-node 2 examples/torch_train_dit.py     # tensor parallel 2

A small model (dim 256, depth 4) on the toy manifest of a seeded pack made
under ``models/torch_train_dit/``; ``train(..., manifest_path=...)`` takes a
real JSON-lines ``{audio, text}`` manifest. Checkpoints go to
``checkpoints/dit`` every 50 steps (the run resumes from the latest), and the
trained DiT is exported into the pack. Every rank runs this script; rank 0
alone prints, checkpoints and exports.
"""

import os

from vietvoice_tts_tpu_torch import ModelConfig
from vietvoice_tts_tpu_torch.parallel.mesh import launch_mesh
from vietvoice_tts_tpu_torch.training.loop import TrainRunConfig, train
from vietvoice_tts_tpu_torch.training.train import TrainConfig

model = ModelConfig(
    device="cuda",
    dit_dim=256,
    dit_depth=4,
    dit_heads=8,
    text_dim=128,
    text_conv_layers=2,
    model_cache_dir="models/torch_train_dit",
)
mesh = launch_mesh(data=1, model=int(os.environ.get("WORLD_SIZE", "1")))
summary = train(
    model,
    TrainConfig(learning_rate=3e-4, warmup_steps=100),
    TrainRunConfig(steps=200, batch_size=8, checkpoint_dir="checkpoints/dit",
                   checkpoint_every=50, log_every=20),
    mesh=mesh,
)
if mesh is None or mesh.rank == 0:
    print(f"final step {summary['final_step']}, loss {summary['final_loss']}")
