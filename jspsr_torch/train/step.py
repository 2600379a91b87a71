"""Train step (counterpart of ``make_train_step`` in
``jspsr_tpu/train/step.py``).

One step: train mode, forward, loss dict, ``Total.backward()``, one
optimizer update. The JAX package fuses this into one jitted program with
functional BatchNorm state; here the model's BatchNorm modules update their
running statistics in place during the forward, as torch's do.

``accum_steps=N`` splits the batch into N microbatches and applies one
update with the mean gradient. BatchNorm uses each microbatch's own
statistics, and the running statistics after the step are the MEAN of the
N per-microbatch updates of the step's starting statistics, as in the JAX
package's scan (``(1-m)·old + m·mean_i(batch_i)``). Torch alone would
chain them (each microbatch updating the previous one's result), so the
step restores the starting statistics before each microbatch and averages
the results. Each BatchNorm's ``num_batches_tracked`` goes up by one per
step.

``remat`` is not yet ported: ``torch.utils.checkpoint`` re-runs the
forward, and with it BatchNorm's in-place running-statistics update, in the
backward, where ``jax.checkpoint`` updates them once (the state is
functional there). The eval step comes with the eval slice.
"""

from __future__ import annotations

import torch


def _bn_modules(model: torch.nn.Module) -> list:
    return [m for m in model.modules()
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
            and m.track_running_stats]


def make_train_step(model: torch.nn.Module, criterion, optimizer,
                    accum_steps: int = 1, monitor: bool = False,
                    remat: bool = False):
    """Returns ``train_step(inputs, gt) -> loss dict``: ``inputs`` a list of
    NCHW tensors in the model's input order, ``gt`` (B,1,H,W). The loss
    values are detached 0-d tensors on the model's device (no host sync).
    With ``monitor`` the dict also holds the gradient, input and
    prediction ranges (reference train_utils.py:241-267)."""
    if remat:
        raise NotImplementedError(
            "remat is not yet ported: torch.utils.checkpoint would re-run "
            "BatchNorm's running-statistics update in the backward")
    accum_steps = int(accum_steps)
    params = [p for p in model.parameters() if p.requires_grad]
    bns = _bn_modules(model)

    def step_full(inputs, gt):
        pred = model(inputs)
        losses = criterion(pred, gt)
        losses["Total"].backward()
        return losses, pred

    def step_accum(inputs, gt):
        b = gt.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} does not divide into {accum_steps} "
                             "microbatches")
        mb = b // accum_steps
        start = [(m.running_mean.clone(), m.running_var.clone(),
                  m.num_batches_tracked.clone()) for m in bns]
        bn_sum = [(torch.zeros_like(mean), torch.zeros_like(var))
                  for mean, var, _ in start]
        loss_sum, preds = None, []
        for i in range(accum_steps):
            sl = slice(i * mb, (i + 1) * mb)
            for m, (mean, var, count) in zip(bns, start):
                m.running_mean.copy_(mean)
                m.running_var.copy_(var)
                m.num_batches_tracked.copy_(count)
            losses, pred = step_full([x[sl] for x in inputs], gt[sl])
            losses = {k: v.detach() for k, v in losses.items()}
            loss_sum = losses if loss_sum is None else {
                k: loss_sum[k] + v for k, v in losses.items()}
            preds.append(pred.detach())
            for m, (s_mean, s_var) in zip(bns, bn_sum):
                s_mean.add_(m.running_mean)
                s_var.add_(m.running_var)
        inv = 1.0 / accum_steps
        with torch.no_grad():
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(inv)
            for m, (s_mean, s_var) in zip(bns, bn_sum):
                m.running_mean.copy_(s_mean * inv)
                m.running_var.copy_(s_var * inv)
        return {k: v * inv for k, v in loss_sum.items()}, torch.cat(preds)

    def train_step(inputs, gt):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        if accum_steps > 1:
            losses, pred = step_accum(inputs, gt)
        else:
            losses, pred = step_full(inputs, gt)
        out = {k: v.detach() for k, v in losses.items()}
        if monitor:
            with torch.no_grad():
                grads = [p.grad for p in params if p.grad is not None]
                out["grad_min"] = torch.stack([g.min() for g in grads]).min()
                out["grad_max"] = torch.stack([g.max() for g in grads]).max()
                out["input_min"] = inputs[0].min()
                out["input_max"] = inputs[0].max()
                out["pred_min"] = pred.detach().min()
                out["pred_max"] = pred.detach().max()
        optimizer.step()
        return out

    return train_step
