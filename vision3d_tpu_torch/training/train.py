"""Training step for SECOND (port of ``vision3d_tpu/training/train.py``).

Adam (b1 0.9, b2 0.999, eps 1e-8) at a per-step one-cycle learning rate
with peak ``cfg.train.max_lr``, after global-norm gradient clipping at
``cfg.train.grad_clip_norm``. One ``train_step`` holds target assignment
(no gradient), the training-mode forward (which updates the batch-norm
running statistics), the loss, the backward pass and the optimizer update.
Nothing in a step reads a value back from the device: the learning rate is
a function of the host-side step count and the clip factor stays a tensor.

The schedule and the clip are optax's, written out, because the JAX package
is the reference: ``optax.cosine_onecycle_schedule`` is a piecewise cosine
with boundaries ``int(0.3*T)`` and ``T`` (not torch's ``OneCycleLR``, which
peaks one step earlier and ends lower), and ``optax.clip_by_global_norm``
scales by ``max_norm / norm`` only when ``norm >= max_norm``, with no
epsilon in the denominator.
"""

import math
from dataclasses import dataclass
from typing import Dict

import torch

from vision3d_tpu_torch.config import Config
from vision3d_tpu_torch.core.anchors import make_anchors
from vision3d_tpu_torch.core.targets import assign_targets_batch
from vision3d_tpu_torch.models.losses import proposal_loss
from vision3d_tpu_torch.models.second import Second, init_second


def make_lr_schedule(cfg: Config, steps_per_epoch: int):
    """step count (from 0) -> learning rate: cosine from peak/25 up to the
    peak over the first ``int(0.3*T)`` steps, cosine down to peak/25/1e4
    at step T = epochs * steps_per_epoch, constant after."""
    total = max(cfg.train.epochs * steps_per_epoch, 1)
    peak = cfg.train.max_lr
    init, end = peak / 25.0, peak / 25.0 / 1e4
    b1 = int(0.3 * total)

    def cosine(pct, start, stop):
        return stop + (start - stop) / 2.0 * (math.cos(math.pi * pct) + 1.0)

    def schedule(count: int) -> float:
        if count < b1:
            return cosine(count / b1, init, peak)
        if count < total:
            return cosine((count - b1) / (total - b1), peak, end)
        return end

    return schedule


def clip_by_global_norm_(grads, max_norm: float):
    """Scale ``grads`` in place by ``max_norm / norm`` where their global
    L2 norm is at least ``max_norm``. Returns the norm (a 0-d tensor)."""
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    scale = torch.where(norm >= max_norm, max_norm / norm, torch.ones_like(norm))
    torch._foreach_mul_(grads, scale)
    return norm


class Optimizer:
    """Global-norm clip, then Adam at ``schedule(step)``: the chain of
    ``make_optimizer`` in the JAX package."""

    def __init__(self, params, cfg: Config, steps_per_epoch: int):
        self.params = [p for p in params]
        self.schedule = make_lr_schedule(cfg, steps_per_epoch)
        self.max_norm = cfg.train.grad_clip_norm
        self.adam = torch.optim.Adam(self.params, lr=self.schedule(0),
                                     betas=(0.9, 0.999), eps=1e-8)

    def step(self, count: int):
        """One update from the parameters' ``.grad``; ``count`` is the
        number of updates made before this one."""
        grads = [p.grad for p in self.params if p.grad is not None]
        clip_by_global_norm_(grads, self.max_norm)
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(count)
        self.adam.step()

    def zero_grad(self):
        self.adam.zero_grad(set_to_none=True)

    def state_dict(self):
        return self.adam.state_dict()

    def load_state_dict(self, sd):
        self.adam.load_state_dict(sd)


def make_optimizer(cfg: Config, steps_per_epoch: int, params) -> Optimizer:
    return Optimizer(params, cfg, steps_per_epoch)


@dataclass
class TrainState:
    """What a checkpoint holds: the model (parameters and batch-norm
    statistics), the optimizer (Adam moments) and the step count."""

    model: Second
    optimizer: Optimizer
    step: int = 0
    diagnostics: dict = None   # capacity counters of the last step (0-d tensors)


def create_train_state(cfg: Config, generator: torch.Generator = None,
                       steps_per_epoch: int = 1000, device="cuda",
                       state_dict=None):
    """Returns (model, optimizer, state). Fresh weights come from
    ``generator`` (default: a CPU generator seeded 0) through
    ``init_second``, or from ``state_dict``."""
    model = Second(cfg)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_second(model, generator or torch.Generator().manual_seed(0))
    model = model.to(device).train()
    tx = make_optimizer(cfg, steps_per_epoch, model.parameters())
    return model, tx, TrainState(model=model, optimizer=tx, step=0)


def make_train_step(model: Second, tx: Optimizer, cfg: Config, anchors=None):
    """Build ``train_step(state, batch) -> (state, losses)``.

    Batch dict fields (fixed capacity, tensors on the model's device):
      points (B, P, C) f32 | num_points (B,) i32
      boxes (B, G, 7) f32 | class_idx (B, G) i32
      gt_mask (B, G) bool | box_ignore (B, G) bool
    ``losses`` holds the 0-d tensors loss / cls_loss / reg_loss; the
    model's capacity counters of the step are left in
    ``state.diagnostics``.
    """
    if anchors is None:
        anchors = torch.as_tensor(make_anchors(cfg),
                                  device=next(model.parameters()).device)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model.train()
        with torch.no_grad():
            targets = assign_targets_batch(
                batch["boxes"], batch["class_idx"], batch["gt_mask"],
                batch["box_ignore"], anchors, cfg)
        tx.zero_grad()
        cls_map, reg_map, diag = model(batch["points"], batch["num_points"])
        losses = proposal_loss(cls_map, reg_map, targets, cfg)
        losses["loss"].backward()
        tx.step(state.step)
        state.step += 1
        state.diagnostics = diag
        return state, {k: v.detach() for k, v in losses.items()}

    return train_step
