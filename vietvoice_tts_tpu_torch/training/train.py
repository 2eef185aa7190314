"""Conditional flow-matching training for the DiT mel generator.

Port of ``vietvoice_tts_tpu/training/train.py``. Objective (F5-TTS family):
draw t ~ U[0,1], noise x₀, data x₁ (ground-truth mel); the network predicts
the straight-line velocity v = x₁ − x₀ from x_t = (1−t)·x₀ + t·x₁,
conditioned on a randomly span-masked copy of the mel (infilling) and the
character sequence. Conditioning is dropped with probability
``cfg_dropout`` to train the classifier-free-guidance branch the sampler
uses (``models/sampler.py``).

Differences from the JAX module, none in the arithmetic:

- The random draws are separate from the loss. ``jax.random`` cannot be
  reproduced in torch, so :func:`draw` takes them from a
  ``torch.Generator`` and :func:`flow_matching_loss` is deterministic in
  them; a test rebuilds the same :class:`Draws` from a JAX key.
- The optimizer is :class:`AdamW`, a ``torch.optim.Optimizer`` with optax's
  ``adamw`` arithmetic, over one parameter group (optax decays every leaf),
  after :func:`clip_by_global_norm` (optax's rule, not
  ``clip_grad_norm_``'s), with its learning rate set before each update
  from :func:`learning_rate`, optax's warm-up-cosine schedule at the update
  count. Neither optax nor orbax is needed.
- The DiT runs its plain attention (``use_kernels=False``), as the JAX
  trainer runs XLA (``loop.py:75``): neither CUDA kernel has a backward.

On a mesh (``make_train_step(..., mesh=)``), what GSPMD does for the JAX
step is written out: every rank takes the same global batch and the same
global draws and keeps its rows of the data axis; the loss's numerator and
denominator are each summed over the data group (averaging per-rank losses
is wrong when ranks hold different numbers of scored frames); the gradients
are summed over the data group; tensor parallelism shards the DiT
(``DiTConfig.model_group``, Megatron's f and g in its layers), and the
global-norm clip sums the squares of each sharded leaf over the model group
once and of each replicated leaf once, so every rank clips by the same norm.

On the card without a mesh, a step is one replay of a CUDA graph captured
per shape (:class:`TrainStep`), the counterpart of ``jax.jit`` of the JAX
step: the update's learning rate and bias corrections are the graph's
inputs, computed on the host from the update count.

Mixed precision: ``compute_dtype="bfloat16"`` builds the DiT with bfloat16
compute while its parameters, the master weights, and the Adam moments stay
float32; ``linear`` casts each weight per use, so gradients come out
float32 and need no loss scaling. ``"float32"`` is the exact reference path
and runs without TF32 on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import numpy as np
import torch

from ..models.dit import DiT, DiTConfig
from ..models.params import dit_state
from ..parallel import comm
from ..parallel.sharding import shard_batch
from ..runtime.engine_core import _true_float32, captures_graphs
from ..runtime.graphs import GraphCache

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
DECAY_STEPS = 1_000_000  # the schedule's length, warm-up included


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    warmup_steps: int = 1000
    max_grad_norm: float = 1.0
    cfg_dropout: float = 0.1  # P(drop cond+text) per sample
    min_span_frac: float = 0.7  # masked-infill span, fraction of target
    max_span_frac: float = 1.0
    # "bfloat16": bf16 matmul/attention compute, float32 master weights and
    # Adam moments. "float32" is the exact reference path.
    compute_dtype: str = "float32"


@dataclasses.dataclass
class Draws:
    """One step's random draws, per row: the flow time ``t`` [B], the noise
    ``x0`` [B, N, n_mels], the infill span's fraction of the row ``frac``
    [B] (in [min_span_frac, max_span_frac)) and its start as a fraction of
    the free room ``start_u`` [B], and the CFG dropout ``drop`` [B] bool."""

    t: torch.Tensor
    x0: torch.Tensor
    frac: torch.Tensor
    start_u: torch.Tensor
    drop: torch.Tensor

    def to(self, device) -> "Draws":
        return Draws(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))

    def rows(self, lo: int, hi: int) -> "Draws":
        return Draws(*(getattr(self, f.name)[lo:hi] for f in dataclasses.fields(self)))


def draw(generator: torch.Generator, b: int, n: int, n_mels: int, cfg: TrainConfig) -> Draws:
    """Draw a step's randomness from ``generator``, in the order the fields
    are listed, on the generator's device."""
    kw = dict(generator=generator, device=generator.device)
    t = torch.rand(b, **kw)
    x0 = torch.randn(b, n, n_mels, **kw)
    frac = cfg.min_span_frac + (cfg.max_span_frac - cfg.min_span_frac) * torch.rand(b, **kw)
    start_u = torch.rand(b, **kw)
    drop = torch.rand(b, **kw) < cfg.cfg_dropout
    return Draws(t, x0, frac, start_u, drop)


@dataclasses.dataclass
class FlowInputs:
    """What the loss feeds the DiT and scores it on."""

    xt: torch.Tensor  # [B, N, n_mels] noisy latent
    cond: torch.Tensor  # [B, N, n_mels] unmasked mel, 0 in the span and on dropped rows
    text_ids: torch.Tensor  # [B, N], −1 on dropped rows
    valid: torch.Tensor  # [B, N] bool, frame < length
    infill: torch.Tensor  # [B, N] bool, the scored span
    v_target: torch.Tensor  # [B, N, n_mels]


def flow_inputs(mel, text_ids, lengths, draws: Draws) -> FlowInputs:
    """The JAX loss's arithmetic (``train.py:70-102``) on given draws:
    span length and start truncated to int32, ``max_start`` at least 1."""
    n = mel.shape[1]
    frame_idx = torch.arange(n, dtype=torch.int32, device=mel.device)
    lengths = lengths.to(torch.int32)
    valid = frame_idx[None, :] < lengths[:, None]
    t = draws.t[:, None, None]
    x1 = mel.float()
    xt = (1.0 - t) * draws.x0 + t * x1
    span_len = (draws.frac * lengths.float()).to(torch.int32)
    max_start = torch.clamp(lengths - span_len, min=1)
    start = (draws.start_u * max_start.float()).to(torch.int32)
    in_span = (frame_idx[None, :] >= start[:, None]) & (
        frame_idx[None, :] < (start + span_len)[:, None]
    )
    zero = torch.zeros((), device=mel.device)
    cond = torch.where((valid & ~in_span)[..., None], x1, zero)
    cond = torch.where(draws.drop[:, None, None], zero, cond)
    text_ids = torch.where(draws.drop[:, None], torch.full_like(text_ids, -1), text_ids)
    return FlowInputs(xt, cond, text_ids, valid, in_span & valid, x1 - draws.x0)


def flow_matching_loss(dit: DiT, mel, text_ids, lengths, draws: Draws, data_group=None):
    """Masked flow-matching MSE, a scalar float32 tensor: the squared error
    of the predicted velocity on the infill span's frames, summed, over
    (span frames × n_mels), times n_mels, as the JAX loss has it. The JAX
    function's ``train_cfg`` is in ``draws`` here (span fractions, dropout).

    With a ``data_group`` the rows are this rank's share of the batch and
    the denominator is summed over the group: the result is this rank's
    share of the global loss, and the group's shares sum to it."""
    m = mel.shape[-1]
    f = flow_inputs(mel, text_ids, lengths, draws)
    v_pred = dit(f.xt, f.cond, f.text_ids, draws.t, f.valid)
    err = (v_pred - f.v_target) ** 2
    w = f.infill[..., None].float()
    den = comm.all_reduce(torch.sum(w) * m, data_group)
    return torch.sum(err * w) / torch.clamp(den, min=1.0) * m


def learning_rate(count: int, cfg: TrainConfig) -> float:
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup_steps, 1_000_000,
    0.1·lr)`` at update count ``count`` (0 for the first update)."""
    peak, warmup = cfg.learning_rate, cfg.warmup_steps
    if count < warmup:
        return peak * count / warmup  # linear from 0
    alpha = 0.0 if peak == 0.0 else 0.1 * peak / peak  # optax: end / peak
    decay = DECAY_STEPS - warmup
    c = min(count - warmup, decay)
    return peak * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / decay)) + alpha)


@torch.no_grad()
def clip_by_global_norm(
    grads: list, max_norm: float, sharded: list | None = None, model_group=None
) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place: with ‖g‖ = √(Σ ‖leaf‖²),
    every leaf stays as it is if ‖g‖ < max_norm, else becomes g / ‖g‖ ·
    max_norm. Returns ‖g‖ (0-dim, float32). A few multi-tensor launches for
    all leaves, and no host sync: the test runs on the device, and a kept
    leaf is divided and multiplied by exactly 1.

    Under tensor parallelism ``sharded[i]`` says whether leaf i is this
    rank's shard of a leaf split over ``model_group``: its squares are
    summed over the group, a replicated leaf's are counted once."""
    norms = torch.stack(torch._foreach_norm(grads))
    if model_group is None:
        norm = torch.linalg.vector_norm(norms)
    else:
        split = torch.tensor(sharded, dtype=norms.dtype).to(norms.device)
        sq = norms.square()
        norm = torch.sqrt(
            comm.all_reduce((sq * split).sum(), model_group) + (sq * (1.0 - split)).sum()
        )
    keep = norm < max_norm
    one = torch.ones((), device=norm.device)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(one, max_norm)))
    return norm


class AdamW(torch.optim.Optimizer):
    """``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8, decay on every leaf) as
    a torch optimizer, with optax's float32 arithmetic step for step:
    μ ← (1−b1)·g + b1·μ, ν ← (1−b2)·g² + b2·ν; the update
    (μ / (1 − b1ᵗ)) / (√(ν / (1 − b2ᵗ)) + eps) + decay·p, times −lr.

    ``torch.optim.AdamW`` computes the bias corrections 1 − bᵗ in float64
    where optax takes them in float32, and 1 − f32(0.999) is 1.3e-5 off
    1e-3: its updates differ from optax's by ~6e-6 of their size, and that
    difference, not rounding, would set the parity bound. Here they agree
    to rounding. State per parameter: ``step``, ``exp_avg`` (μ),
    ``exp_avg_sq`` (ν), float32 like the master weights.

    An update is two halves, so that the device half can be captured in a
    CUDA graph (:class:`TrainStep`): :meth:`begin_update`, on the host,
    makes the state at the first update, advances every parameter's count
    (a CPU tensor, as before graphs: checkpoints keep their format) and
    returns the update's scalars; :meth:`apply` is the arithmetic on the
    device, with those scalars as a tensor there, and reads nothing on the
    host. :meth:`step` is the two in a row at the group's ``lr``."""

    def __init__(self, params, weight_decay: float, lr: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    @torch.no_grad()
    def begin_update(self, lr: float) -> torch.Tensor:
        """Make the state if there is none, count one more update and return
        [lr, 1 − b1ᵗ, 1 − b2ᵗ] for it (update t, from 1), float32 on the CPU:
        the corrections in float32, as optax takes them."""
        for group in self.param_groups:
            group["lr"] = lr
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
        count = st["step"]  # the same for every parameter
        f32 = torch.float32
        return torch.stack([torch.tensor(lr, dtype=f32)] + [
            1 - torch.tensor(b, dtype=f32) ** count for b in ADAM_BETAS])

    @torch.no_grad()
    def apply(self, scalars: torch.Tensor) -> None:
        """The update on every parameter's ``.grad``, from :meth:`begin_update`'s
        scalars on the parameters' device."""
        b1, b2 = ADAM_BETAS
        lr, bc1, bc2 = scalars
        for group in self.param_groups:
            params = group["params"]
            states = [self.state[p] for p in params]
            grads = [p.grad for p in params]
            mu = [st["exp_avg"] for st in states]
            nu = [st["exp_avg_sq"] for st in states]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1 - b2)
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, sq)
            del sq
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, ADAM_EPS)
            update = torch._foreach_div(mu, bc1)
            torch._foreach_div_(update, denom)
            del denom
            torch._foreach_add_(update, torch._foreach_mul(params, group["weight_decay"]))
            torch._foreach_mul_(update, -lr)
            torch._foreach_add_(params, update)

    @torch.no_grad()
    def step(self) -> None:
        params = self.param_groups[0]["params"]
        self.apply(self.begin_update(self.param_groups[0]["lr"]).to(params[0].device))


def make_optimizer(params, cfg: TrainConfig) -> AdamW:
    """:class:`AdamW` over one parameter group with ``cfg.weight_decay``
    (optax's ``adamw`` decays every leaf). The learning rate is set per
    update by :func:`apply_update` from :func:`learning_rate`."""
    return AdamW(list(params), weight_decay=cfg.weight_decay)


def update_count(opt: torch.optim.Optimizer) -> int:
    """Updates the optimizer has made (its state's ``step``, 0 before the first)."""
    for state in opt.state.values():
        return int(state["step"])
    return 0


def apply_update(
    opt: torch.optim.Optimizer, cfg: TrainConfig, sharded: list | None = None, model_group=None
) -> None:
    """The optax chain's update on gradients already in ``.grad``: clip by
    global norm, then AdamW at the schedule's rate for this update count.
    ``sharded`` / ``model_group``: see :func:`clip_by_global_norm`."""
    params = [p for group in opt.param_groups for p in group["params"]]
    clip_by_global_norm([p.grad for p in params], cfg.max_grad_norm, sharded, model_group)
    scalars = opt.begin_update(learning_rate(update_count(opt), cfg))
    opt.apply(scalars.to(params[0].device))


def train_dit_config(dit_cfg: DiTConfig, train_cfg: TrainConfig) -> DiTConfig:
    """The DiT the trainer builds: ``train_cfg``'s compute dtype, plain
    (differentiable) attention."""
    return dataclasses.replace(
        dit_cfg, compute_dtype=getattr(torch, train_cfg.compute_dtype), use_kernels=False
    )


def init_train_state(tree: dict, dit_cfg: DiTConfig, train_cfg: TrainConfig, device="cuda"):
    """(DiT with float32 master weights from the pack's ``dit`` pytree on
    ``device``, its optimizer). On the card unless ``device`` says
    otherwise, as ``ModelConfig.device``."""
    dit = DiT(train_dit_config(dit_cfg, train_cfg))
    dit.load_state_dict(dit_state(tree, torch.float32), assign=True)
    dit = dit.to(device).train()
    return dit, make_optimizer(dit.parameters(), train_cfg)


def sharded_leaves(dit: DiT) -> list:
    """For each parameter of ``dit`` (in ``parameters()`` order), whether it
    is a tensor-parallel shard: its shape differs from the whole model's."""
    if dit.cfg.model_group is None:
        return [False] * len(list(dit.parameters()))
    with torch.device("meta"):
        whole = DiT(dataclasses.replace(dit.cfg, model_group=None))
    shapes = dict((n, p.shape) for n, p in whole.named_parameters())
    return [p.shape != shapes[n] for n, p in dit.named_parameters()]


_UNSET = object()  # TrainStep.graphs before the first call decides it


class TrainStep:
    """``step(dit, opt, draws, mel, text_ids, lengths) → loss``: one forward
    and backward of :func:`flow_matching_loss` and one update of ``opt``
    (clip by global norm, then AdamW at the schedule's rate). ``dit`` must
    be built as :func:`init_train_state` builds it.

    On the card without a mesh each step is one replay of a CUDA graph
    captured for its key (batch, bucket frames, compute dtype, the two TF32
    flags): the counterpart of JAX compiling the step once per shape,
    ``jax.jit(make_train_step(...), donate_argnums=(0, 1))``. The graph
    holds the forward, the backward, the clip and the AdamW arithmetic. Its
    inputs, copied in before each replay, are the batch, the draws and the
    update's scalars [lr, 1 − b1ᵗ, 1 − b2ᵗ], which :meth:`AdamW.begin_update`
    computes on the host from the host-side count. The CPU and a mesh run
    the same body eagerly (gloo cannot be captured), so a replay gives an
    eager step's bits.

    - A key's first step is the eager run that precedes its capture
      (``GraphCache.run(warm_is_call=True)``): k batches make k updates.
    - The graphs read the parameters and the optimizer's state by address.
      Load a checkpoint before the first step, as ``train()`` does, and
      keep a step to one model and optimizer: either raises otherwise.
    - The gradients live in the graphs' memory pool, which the graphs of
      other keys share, so after a graph step ``.grad`` is None.
    - The returned loss is a copy: the graph's output is overwritten by the
      key's next replay.

    No setting turns graphs off, and a capture that fails raises. ``graphs``
    is the :class:`GraphCache`, made at the first call on the card off a
    mesh. Set it to None for eager steps on the card (``chip_smoke.py``
    compares the two) or to a cache with another graph class (the CPU
    tests)."""

    def __init__(self, dit_cfg: DiTConfig, train_cfg: TrainConfig, mesh=None):
        self.want = train_dit_config(dit_cfg, train_cfg)
        self.train_cfg = train_cfg
        self.mesh = mesh
        self.data_group = mesh.data_group if mesh is not None else None
        self.numerics = (
            _true_float32 if train_cfg.compute_dtype == "float32" else contextlib.nullcontext
        )
        self.graphs = _UNSET
        self._sharded = None
        self._owner = None  # (dit, opt, opt.state) the graphs were captured for

    def __call__(self, dit: DiT, opt: AdamW, draws: Draws, mel, text_ids, lengths) -> torch.Tensor:
        if dit.cfg != self.want:
            raise ValueError(f"the DiT was built with {dit.cfg}, this step trains {self.want}")
        if self.data_group is not None:
            mel, text_ids, lengths = shard_batch(self.mesh, mel, text_ids, lengths)
            rows = mel.shape[0]
            draws = draws.rows(self.mesh.data_index * rows, (self.mesh.data_index + 1) * rows)
        if self._sharded is None:
            self._sharded = sharded_leaves(dit)
        if self.graphs is _UNSET:
            self.graphs = GraphCache(mel.device) if captures_graphs(mel.device, self.mesh) else None
        if self.graphs is not None:
            self._check_owner(dit, opt)
        scalars = opt.begin_update(learning_rate(update_count(opt), self.train_cfg))
        fields = (getattr(draws, f.name) for f in dataclasses.fields(Draws))
        inputs = (mel, text_ids, lengths, *fields, scalars)
        with self.numerics():
            if self.graphs is None:
                opt.zero_grad(set_to_none=True)
                return self._body(dit, opt, *inputs[:-1], scalars.to(mel.device))
            return self._replay(dit, opt, inputs)

    def _body(self, dit, opt, mel, text_ids, lengths, t, x0, frac, start_u, drop, scalars):
        """Forward, backward, clip and AdamW on tensors on the device → the
        loss. What a graph holds: it reads nothing on the host."""
        draws = Draws(t, x0, frac, start_u, drop)
        loss = flow_matching_loss(dit, mel, text_ids, lengths, draws, self.data_group)
        loss.backward()
        grads = [p.grad for group in opt.param_groups for p in group["params"]]
        if self.data_group is not None:
            flat = comm.all_reduce(torch._utils._flatten_dense_tensors(grads), self.data_group)
            for g, total in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
                g.copy_(total)
            loss = comm.all_reduce(loss.detach(), self.data_group)
        clip_by_global_norm(grads, self.train_cfg.max_grad_norm, self._sharded,
                            dit.cfg.model_group)
        opt.apply(scalars)
        return loss.detach()

    def _check_owner(self, dit, opt) -> None:
        if self._owner is None:
            self._owner = (dit, opt, opt.state)
        elif any(a is not b for a, b in zip(self._owner, (dit, opt, opt.state))):
            raise ValueError(
                "this step's graphs were captured for another model, optimizer or optimizer "
                "state: load a checkpoint before the first step, one step per model")

    def _replay(self, dit, opt, inputs) -> torch.Tensor:
        b, n = inputs[0].shape[:2]
        key = (b, n, self.train_cfg.compute_dtype,
               torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        # Gradients of None: a new key's eager run makes its own and its
        # capture allocates them in the pool; a replay writes the pool's.
        drop_grads = functools.partial(opt.zero_grad, set_to_none=True)
        drop_grads()
        loss = self.graphs.run(key, lambda *xs: self._body(dit, opt, *xs), inputs,
                               prepared=drop_grads, warm_is_call=True)
        drop_grads()
        return loss.clone()


def make_train_step(dit_cfg: DiTConfig, train_cfg: TrainConfig, mesh=None) -> TrainStep:
    """Build the :class:`TrainStep` ``step(dit, opt, draws, mel, text_ids,
    lengths) → loss``.

    On a ``mesh`` every rank passes the same global batch and draws; the
    step keeps this rank's rows of the data axis, sums the gradients over
    the data group and returns the global loss."""
    return TrainStep(dit_cfg, train_cfg, mesh)


def as_tensors(mel: np.ndarray, text_ids: np.ndarray, lengths: np.ndarray, device):
    """A numpy batch from ``data.TextMelDataset`` → tensors on ``device``."""
    return (
        torch.from_numpy(np.asarray(mel, np.float32)).to(device),
        torch.from_numpy(np.asarray(text_ids, np.int64)).to(device),
        torch.from_numpy(np.asarray(lengths, np.int32)).to(device),
    )
