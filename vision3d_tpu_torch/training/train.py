"""Training steps for SECOND and PV-RCNN (port of
``vision3d_tpu/training/train.py``).

Adam (b1 0.9, b2 0.999, eps 1e-8) at a per-step one-cycle learning rate
with peak ``cfg.train.max_lr``, after global-norm gradient clipping at
``cfg.train.grad_clip_norm``. One ``train_step`` holds target assignment
(no gradient), the training-mode forward (which updates the batch-norm
running statistics), the loss, the backward pass and the optimizer update.
Nothing in a step reads a value back from the device: the learning rate is
a function of the host-side step count and the clip factor stays a tensor
(the copies of host constants to the card, spans ``v3d:sync``, wait for
the stream).

The schedule and the clip are optax's, written out, because the JAX package
is the reference: ``optax.cosine_onecycle_schedule`` is a piecewise cosine
with boundaries ``int(0.3*T)`` and ``T`` (not torch's ``OneCycleLR``, which
peaks one step earlier and ends lower), and ``optax.clip_by_global_norm``
scales by ``max_norm / norm`` only when ``norm >= max_norm``, with no
epsilon in the denominator.

PV-RCNN trains in one of two modes (``make_pvrcnn_train_step``'s
``train_stage2``), as the JAX step does: stage 1 alone, SECOND's proposal
loss on the maps of a forward that also runs the point branch (without
gradient: its outputs reach no loss, but its batch norms take the batch's
statistics; its parameters get no gradient and Adam leaves them as they
are), or both stages, the proposal loss plus the refinement loss and the
keypoint-segmentation loss, with gradients everywhere. Each two-stage step
draws the grid points and the random background keypoints from a CPU
generator seeded from (seed, step), so the card and the CPU draw alike;
the draws are those of JAX's distributions, not its numbers.

In a process group (``parallel/mesh.py``, one process per card, each on its
shard of the global batch) a step computes what the JAX mesh computes over
the global batch: the batch norms' statistics and the loss normalisers are
global sums, so each rank's loss is its share of the global loss; the
gradients are summed over the ranks before the clip, so every rank makes
the same update; the losses and the counters a step returns are the global
batch's; and a two-stage step draws for the global batch and takes its
rank's slice.
"""

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from vision3d_tpu_torch.config import Config
from vision3d_tpu_torch.core.anchors import make_anchors
from vision3d_tpu_torch.core.targets import (assign_refinement_targets_keypoints,
                                             assign_targets_batch)
from vision3d_tpu_torch.models.losses import proposal_loss
from vision3d_tpu_torch.models.pvrcnn import PV_RCNN, init_pvrcnn
from vision3d_tpu_torch.models.refinement import refinement_loss
from vision3d_tpu_torch.models.second import Second, init_second
from vision3d_tpu_torch.parallel import mesh
from vision3d_tpu_torch.training.profiler import annotate


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


def _train_state(model, init, cfg: Config, generator, steps_per_epoch: int,
                 device, state_dict):
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init(model, generator or torch.Generator().manual_seed(0))
    model = model.to(device).train()
    tx = make_optimizer(cfg, steps_per_epoch, model.parameters())
    return model, tx, TrainState(model=model, optimizer=tx, step=0)


def create_train_state(cfg: Config, generator: torch.Generator = None,
                       steps_per_epoch: int = 1000, device="cuda",
                       state_dict=None):
    """Returns (model, optimizer, state). Fresh weights come from
    ``generator`` (default: a CPU generator seeded 0) through
    ``init_second``, or from ``state_dict``."""
    return _train_state(Second(cfg), init_second, cfg, generator, steps_per_epoch,
                        device, state_dict)


def _make_step(model, tx: Optimizer, cfg: Config, anchors, losses_of):
    """``train_step(state, batch, **draws) -> (state, losses)`` around
    ``losses_of(state, batch, targets, anchors, **draws) -> (losses,
    diag)``: target assignment without gradient, the training-mode forward
    and loss, the backward pass and the optimizer update."""
    if anchors is None:
        anchors = torch.as_tensor(make_anchors(cfg),
                                  device=next(model.parameters()).device)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], **draws):
        with annotate("train_step"):
            model.train()
            with torch.no_grad(), annotate("target_assign"):
                targets = assign_targets_batch(
                    batch["boxes"], batch["class_idx"], batch["gt_mask"],
                    batch["box_ignore"], anchors, cfg)
            with annotate("optimizer"):
                tx.zero_grad()
            with annotate("loss_forward"):
                losses, diag = losses_of(state, batch, targets, anchors, **draws)
            with annotate("backward"):
                losses["loss"].backward()
            with annotate("allreduce"):
                mesh.all_reduce_gradients(tx.params)
            with annotate("optimizer"):
                tx.step(state.step)
            state.step += 1
            state.diagnostics = mesh.sum_over_ranks(diag)
            return state, mesh.sum_over_ranks({k: v.detach() for k, v in losses.items()})

    return train_step


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
    def losses_of(state, batch, targets, anchors):
        cls_map, reg_map, diag = model(batch["points"], batch["num_points"])
        return proposal_loss(cls_map, reg_map, targets, cfg), diag

    return _make_step(model, tx, cfg, anchors, losses_of)


def create_pvrcnn_train_state(cfg: Config, generator: torch.Generator = None,
                              steps_per_epoch: int = 1000, device="cuda",
                              state_dict=None, two_stage: bool = True):
    """``create_train_state`` of a PV_RCNN, stage 1 alone or both stages
    (the JAX package's ``create_pvrcnn_train_state``), fresh weights from
    ``init_pvrcnn``. The optimizer holds every parameter."""
    return _train_state(PV_RCNN(cfg, two_stage=two_stage), init_pvrcnn, cfg, generator,
                        steps_per_epoch, device, state_dict)


def pvrcnn_draws(cfg: Config, batch_size: int, seed: int, step: int):
    """The random numbers of one two-stage step, drawn on the CPU from a
    generator seeded from (seed, step): the grid points' uniform draws
    ``u`` (B, n_cls * topk, num_gridpoints, 3) in [0, 1) and the random
    background keypoints ``neg`` (B, refinement_num_negatives), uniform
    over [0, num_keypoints). JAX draws the same distributions from
    ``fold_in(PRNGKey(seed), step)``."""
    state = np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(state))
    n = cfg.num_classes * cfg.proposal.topk
    u = torch.rand((batch_size, n, cfg.gridpool.num_gridpoints, 3), generator=gen)
    neg = torch.randint(0, cfg.num_keypoints,
                        (batch_size, cfg.train.refinement_num_negatives), generator=gen)
    return u, neg


def keypoint_seg_loss(seg_logits, keypoints, batch, neg, cfg: Config):
    """Softmax cross-entropy of the keypoint-segmentation logits (B, K,
    n_cls + 1) against the class and background channels of
    ``assign_refinement_targets_keypoints``, over the keypoints whose
    ignore channel is off, normalised by their count over the (global)
    batch clamped to 1."""
    with torch.no_grad():
        cls_t, _ = assign_refinement_targets_keypoints(
            neg, keypoints, batch["boxes"], batch["class_idx"], batch["gt_mask"], cfg)
    valid = cls_t[..., -1] == 0.0
    ce = -(cls_t[..., :-1] * F.log_softmax(seg_logits, dim=-1)).sum(-1)
    return torch.where(valid, ce, 0.0).sum() / mesh.global_sum(valid.sum()).clamp(min=1)


def make_pvrcnn_train_step(model: PV_RCNN, tx: Optimizer, cfg: Config, anchors=None,
                           train_stage2: bool = True, seed: int = 0):
    """Build ``train_step(state, batch, u=None, neg=None) -> (state,
    losses)`` of PV-RCNN (batch fields as ``make_train_step``'s).

    ``train_stage2=False``: SECOND's proposal loss on a training-mode
    ``forward`` (stage 1 with the point branch run without gradient);
    ``losses`` as SECOND's. ``True``: ``two_stage`` in training mode, and
    ``loss`` = proposal loss + ``refine_loss`` + ``seg_loss``, with
    ``cls_loss``, ``reg_loss``, ``refine_cls_loss`` and
    ``refine_reg_loss`` beside them. Its draws are ``pvrcnn_draws(cfg, B,
    seed, state.step)``, or ``u`` / ``neg`` where given (e.g. JAX's)."""
    if not train_stage2:
        return make_train_step(model, tx, cfg, anchors)

    def two_stage_losses(state, batch, targets, anchors, u=None, neg=None):
        if u is None or neg is None:
            # drawn for the global batch; each rank takes its slice
            du, dneg = pvrcnn_draws(cfg, batch["points"].shape[0] * mesh.world_size(),
                                    seed, state.step)
            u = mesh.rank_slice(du) if u is None else u
            neg = mesh.rank_slice(dneg) if neg is None else neg
        out, diag = model.two_stage(batch["points"], batch["num_points"], anchors, u=u)
        losses = proposal_loss(out["cls_map"], out["reg_map"], targets, cfg)
        refine = refinement_loss(
            out["box_deltas"], out["conf_logits"], out["proposals"],
            torch.ones(out["proposals"].shape[:2], dtype=torch.bool,
                       device=out["proposals"].device),
            batch["boxes"], batch["gt_mask"], cfg)
        losses.update(refine)
        with annotate("sync"):
            neg = neg.to(out["keypoints"].device)
        losses["seg_loss"] = keypoint_seg_loss(out["seg_logits"], out["keypoints"],
                                               batch, neg, cfg)
        losses["loss"] = losses["loss"] + refine["refine_loss"] + losses["seg_loss"]
        return losses, diag

    return _make_step(model, tx, cfg, anchors, two_stage_losses)
