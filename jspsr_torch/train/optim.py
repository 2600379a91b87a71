"""Optimizers and per-epoch LR schedules (counterpart of
``jspsr_tpu/train/optim.py``; reference utils/common_config.py:241-368).

The optimizers are torch's own, as in the reference: ``AdamW`` (decoupled
weight decay), ``Adam`` and ``SGD`` (L2 decay added to the gradient) and
``RMSprop`` (alpha 0.99), all with eps 1e-8. They match the JAX package's
optax chains step for step, except RMSprop: optax's ``scale_by_rms`` adds
eps inside the square root, torch (and the reference) outside, so the two
differ where the running square is not far above 1e-8.

``diff_lr`` is two param groups: parameters under a top-level module whose
name contains ``postprocessor`` run at ``DIFF_LR``, the rest at the
config's lr. Each group carries its ``name`` ('base' or 'diff').

Schedules are closed-form functions epoch -> lr, stepped once per epoch:

- WarmupStepLR: epochs 0..w-1 at lr/10^(w-e) (the SequentialLR warmup
  quirk, common_config.py:339-358), then StepLR with the epoch counter
  rebased to 0 at the warmup boundary: lr * gamma^((e - w) // step_size).
- StepLR / CosineAnnealingLR / OneCycleLR / ConstantLR as in torch.
"""

from __future__ import annotations

import math

import torch

DIFF_LR = 0.0003  # per-module LR for 'postprocessor' (common_config.py:252)


def param_groups(model: torch.nn.Module, diff_lr: bool, lr: float) -> list:
    """One 'base' group, or 'base' and 'diff' (the postprocessor) with
    ``diff_lr``; groups without parameters are left out."""
    groups = {"base": [], "diff": []}
    for name, param in model.named_parameters():
        diff = diff_lr and "postprocessor" in name.split(".")[0]
        groups["diff" if diff else "base"].append(param)
    lrs = {"base": lr, "diff": DIFF_LR}
    return [{"params": ps, "lr": lrs[g], "name": g}
            for g, ps in groups.items() if ps]


def build_optimizer(p, model: torch.nn.Module) -> torch.optim.Optimizer:
    """p: config with .optimizer and .optimizer_kwargs."""
    kw = p.optimizer_kwargs
    lr = kw.lr
    # a YAML "momentum:" / "weight_decay:" with no value parses to None
    wd = float(kw.get("weight_decay") or 0.0)
    momentum = float(kw.get("momentum") or 0.0)
    groups = param_groups(model, bool(kw.get("diff_lr")), lr)
    name = p.optimizer.lower()
    if name == "sgd":
        return torch.optim.SGD(groups, lr=lr, momentum=momentum,
                               weight_decay=wd)
    if name == "adam":
        return torch.optim.Adam(groups, lr=lr, eps=1e-8, weight_decay=wd)
    if name == "adamw":
        return torch.optim.AdamW(groups, lr=lr, eps=1e-8, weight_decay=wd)
    if name == "rmsprop":
        return torch.optim.RMSprop(groups, lr=lr, alpha=0.99, eps=1e-8,
                                   momentum=momentum, weight_decay=wd)
    raise NotImplementedError(f"Undefined optimizer: {p.optimizer}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float,
                      base_lr: float | None = None):
    """Set every group's learning rate for this epoch. Torch steps every
    param group by the same multiplicative schedule, so the 'diff' group
    follows DIFF_LR * (lr / base_lr)."""
    factor = (lr / base_lr) if base_lr else None
    for group in optimizer.param_groups:
        if group.get("name") == "diff":
            group["lr"] = DIFF_LR * factor if factor is not None else DIFF_LR
        else:
            group["lr"] = lr
    return optimizer


def build_lr_schedule(p):
    """Returns fn(epoch:int) -> float, stepped once per epoch."""
    name = p.scheduler.lower()
    base_lr = p.optimizer_kwargs.lr
    sk = p.get("scheduler_kwargs") or {}
    epochs = p.epochs
    warmup = sk.get("warmup_epoch", 0)
    max_lr = sk.get("max_lr", 0.1)
    step_size = sk.get("step_size") or epochs // 3
    gamma = sk.get("gamma") if sk.get("gamma") is not None else 0.1

    if name == "warmupsteplr":
        def fn(e):
            if e < warmup:
                return base_lr / (10.0 ** (warmup - e))
            return base_lr * gamma ** ((e - warmup) // step_size)
        return fn
    if name == "steplr":
        return lambda e: base_lr * gamma ** (e // step_size)
    if name == "cosineannealinglr":
        eta_min = 1e-6
        return lambda e: eta_min + (base_lr - eta_min) * (
            1 + math.cos(math.pi * e / epochs)
        ) / 2
    if name == "onecyclelr":
        div_factor = 90.0
        final_div = 1e4
        initial = max_lr / div_factor
        final = initial / final_div
        pct_start = 0.3
        up = max(1, int(round(pct_start * epochs)) - 1)
        down = epochs - up - 1

        def fn(e):
            if e <= up:
                t = e / up
                return initial + (max_lr - initial) * (1 - math.cos(math.pi * t)) / 2
            t = min(1.0, (e - up) / max(down, 1))
            return final + (max_lr - final) * (1 + math.cos(math.pi * t)) / 2
        return fn
    if name == "constantlr":
        return lambda e: base_lr
    raise NotImplementedError(f"Undefined scheduler: {p.scheduler}")
