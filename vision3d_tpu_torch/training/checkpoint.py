"""Checkpoint save / restore (port of
``vision3d_tpu/training/checkpoint.py``): one ``torch.save`` file
``<ckpt_dir>/epoch_{E}`` holding the model's state_dict, the optimizer's
and the step count. The learning-rate schedule is a function of the step,
so it resumes by itself."""

import glob
import os
import os.path as osp

import torch

from vision3d_tpu_torch.training.train import TrainState


def save_checkpoint(ckpt_dir: str, state: TrainState, epoch: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = osp.abspath(osp.join(ckpt_dir, f"epoch_{epoch}"))
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}, path)
    return path


def load_checkpoint(path: str, target: TrainState) -> TrainState:
    """Restore into ``target`` (an initialised state), in place."""
    device = next(target.model.parameters()).device
    ckpt = torch.load(osp.abspath(path), map_location=device, weights_only=True)
    target.model.load_state_dict(ckpt["model"], strict=True)
    target.optimizer.load_state_dict(ckpt["optimizer"])
    target.step = int(ckpt["step"])
    return target


def model_state_dict(path: str) -> dict:
    """The model's state_dict alone, on the CPU, for evaluation and
    inference."""
    ckpt = torch.load(osp.abspath(path), map_location="cpu", weights_only=True)
    return ckpt["model"]


def maybe_resume(ckpt_dir: str, target: TrainState):
    """(state, first epoch to run): the newest ``epoch_*`` wins; with none,
    the untouched state and epoch 0."""
    candidates = sorted(glob.glob(osp.join(ckpt_dir, "epoch_*")),
                        key=lambda p: int(p.rsplit("_", 1)[-1]))
    if not candidates:
        return target, 0
    newest = candidates[-1]
    return load_checkpoint(newest, target), int(newest.rsplit("_", 1)[-1]) + 1
