"""The first train steps of a config, in plain PyTorch: the model in train
mode (BatchNorm on batch statistics), the loss, the backward and AdamW at
the schedule's learning rate, written out by hand.

Loss (the shipped ``loss:`` weights): ``L1`` mean |p - t|, ``L2`` mean
(p - t)², ``Grad`` half the sum of the mean absolute differences of the
normalised Sobel gradients (kernels / 8, replicate padding).

AdamW (torch's defaults as the port builds it: betas 0.9, 0.999, eps
1e-8): p <- p (1 - lr wd); m <- b1 m + (1 - b1) g; v <- b2 v + (1 - b2)
g²; p <- p - lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps).

The learning rate of epoch e under ``WarmupStepLR``: lr / 10^(warmup - e)
while e < warmup, else lr gamma^((e - warmup) // step_size)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))


def sobel(x):
    xp = F.pad(x, (1, 1, 1, 1), mode="replicate")
    kx = torch.tensor(SOBEL_X, device=x.device, dtype=x.dtype) / 8.0
    ky = torch.tensor(SOBEL_Y, device=x.device, dtype=x.dtype) / 8.0
    return (F.conv2d(xp, kx.view(1, 1, 3, 3)),
            F.conv2d(xp, ky.view(1, 1, 3, 3)))


def losses(pred, gt, weights: dict) -> dict:
    out = {}
    for name in weights:
        if name == "L1":
            out[name] = (pred - gt).abs().mean()
        elif name == "L2":
            out[name] = (pred - gt).square().mean()
        elif name == "Grad":
            (px, py), (gx, gy) = sobel(pred), sobel(gt)
            out[name] = 0.5 * ((px - gx).abs().mean()
                               + (py - gy).abs().mean())
        else:
            raise NotImplementedError(f"reference loss {name}")
    out["Total"] = sum(weights[n] * out[n] for n in weights)
    return out


def epoch_lr(program: dict, epoch: int) -> float:
    sched = (program.get("scheduler") or "").lower()
    if sched != "warmupsteplr":
        raise NotImplementedError(f"reference scheduler {sched}")
    lr = float(program["optimizer_kwargs"]["lr"])
    sk = program.get("scheduler_kwargs") or {}
    warm = int(sk.get("warmup_epoch", 0))
    if epoch < warm:
        return lr / 10.0 ** (warm - epoch)
    gamma = sk.get("gamma", 0.1)
    return lr * gamma ** ((epoch - warm) // int(sk["step_size"]))


def adamw_step(params: list, state: dict, lr: float, wd: float, t: int,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    with torch.no_grad():
        for p in params:
            g = p.grad
            m, v = state.setdefault(id(p), (torch.zeros_like(p),
                                            torch.zeros_like(p)))
            p.mul_(1.0 - lr * wd)
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (v / (1.0 - b2 ** t)).sqrt_().add_(eps)
            p.addcdiv_(m, denom, value=-lr / (1.0 - b1 ** t))


def step_generator(generator, seed: int, step: int) -> None:
    """Reseed ``generator`` for global step ``step`` of a run seeded with
    ``seed``, from a 64-bit hash of the pair (the port's Trainer draws
    its drop-path masks so)."""
    generator.manual_seed(int(np.random.SeedSequence(
        [int(seed), int(step)]).generate_state(1, np.uint64)[0]))


def run_steps(model, batches, program: dict, epoch: int = 0,
              seed: int = 0, device="cpu") -> dict:
    """Steps ``model`` (train mode) over ``batches`` (a list of (inputs,
    gt), or a function of the step index giving one), handing it a
    generator reseeded before step t from (``seed``, t). Returns ``losses``
    (each step's total, as floats), ``grad`` ({name: norm of the first
    step's gradient}) and ``change`` ({name: norm of the parameters'
    change over all steps})."""
    if (program.get("optimizer") or "").lower() != "adamw":
        raise NotImplementedError(f"reference optimizer "
                                  f"{program.get('optimizer')}")
    wd = float(program["optimizer_kwargs"].get("weight_decay") or 0.0)
    lr = epoch_lr(program, epoch)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in named]
    start = [p.detach().clone() for p in params]
    state, out_losses, grad = {}, [], {}
    model.train()
    gen = torch.Generator(device)
    n = len(batches) if isinstance(batches, list) else batches.steps
    for t in range(1, n + 1):
        inputs, gt = batches[t - 1] if isinstance(batches, list) \
            else batches(t - 1)
        for p in params:
            p.grad = None
        step_generator(gen, seed, t - 1)
        total = losses(model(inputs, generator=gen), gt,
                       program["loss"])["Total"]
        total.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if t == 1:
            grad = {name: p.grad.norm() for name, p in named}
        out_losses.append(total.detach())
        adamw_step(params, state, lr, wd, t)
        del inputs, gt, total
    change = {name: (p.detach() - s).norm()
              for (name, p), s in zip(named, start)}
    return {"losses": [float(x) for x in out_losses],
            "grad": {k: float(v) for k, v in grad.items()},
            "change": {k: float(v) for k, v in change.items()}}
