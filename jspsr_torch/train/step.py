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

``generator`` is handed to the model's forward for its random draws
(CompletionFormer's drop path; JSPSR draws nothing), as the JAX package
hands its model a per-step key. Before each step the caller reseeds it
with ``seed_step_generator(generator, seed, step)``: the draws of global
step ``step`` are then a function of (seed, step) alone, as JAX's are
(``jax.random.fold_in(PRNGKey(seed), state.step)``), so a run brought to
step k and a run resumed at step k draw the same masks. They are not
JAX's bits: torch's generator is another generator. LRRU's StoDepth
draws nothing: the JAX package's LRRU passes no key to its blocks, so a
block is always kept in training (``models/lrru.py``).

A parameter that the loss does not reach gets a zero gradient after the
backward, as ``jax.grad`` gives it (LRRU's heads of rounds 1-3, whose
outputs enter only detached): the optimizer then decays it and carries its
state, as optax does. Where every parameter has a gradient this changes
nothing.

``remat`` runs the whole model forward under one checkpoint
(``nn.remat.checkpoint``, the JAX package's ``jax.checkpoint(fwd)``): its
activations are computed again in the backward, BatchNorm updates its
running statistics in the first forward only, and ``generator`` replays
its draws, so the step is the step without ``remat``, bit for bit, with
each microbatch's activations recomputed under ``accum_steps``.

Under a process group (data parallelism, ``parallel.mesh``) each rank
steps on its shard of the global batch: the forward and backward run in
``data_parallel(group)``, so BatchNorm takes the global batch's
statistics (and PVT's drop path draws its masks), the gradients are all-reduced to their mean
(``all_reduce_grads``) after the backward and before the monitor and the
update, and the loss dict is reduced to the ranks' mean, so every rank
logs and applies the same step. With ``accum_steps`` the ranks first
gather the global batch (``all_gather_rows``): microbatch i is rows
``[i*mb, (i+1)*mb)`` of the global batch, as the JAX step's scan splits
its batch-sharded array (``jspsr_tpu/train/step.py:62-72``), and each
rank takes its share of those rows (``mb`` must divide by the world
size).

The step's phases are profiler ranges (``utils/tracing.ranged``), named
in the trace only while a ``torch.profiler`` runs: ``step.forward`` (with
``zero_grad``), ``step.loss``, ``step.backward`` and ``step.optimizer``
(the unreached gradients' fill, the all-reduce, the monitor, the update
and the loss dict's reduction).

``make_eval_step`` is the eval-mode forward with the losses, among them
the per-sample totals that the eval loop reads.
"""

from __future__ import annotations

import numpy as np
import torch

from jspsr_torch.nn.remat import check_recomputable, checkpoint
from jspsr_torch.parallel.mesh import (
    all_gather_rows,
    all_reduce_grads,
    data_parallel,
    process_group,
    rank_world,
    reduce_step_outputs,
)
from jspsr_torch.utils import tracing


def seed_step_generator(generator: torch.Generator | None, seed: int,
                        step: int) -> None:
    """Reseed ``generator`` (nothing without one) for global step ``step``
    of a run seeded with ``seed``, from a 64-bit hash of the pair:
    neighbouring steps, and neighbouring seeds, start unrelated streams."""
    if generator is not None:
        generator.manual_seed(int(np.random.SeedSequence(
            [int(seed), int(step)]).generate_state(1, np.uint64)[0]))


def fill_unreached_grads(params) -> None:
    """A zero gradient for every parameter the backward did not reach
    (``grad is None``), as ``jax.grad`` gives one."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def _bn_modules(model: torch.nn.Module) -> list:
    return [m for m in model.modules()
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
            and m.track_running_stats]


def make_train_step(model: torch.nn.Module, criterion, optimizer,
                    accum_steps: int = 1, monitor: bool = False,
                    remat: bool = False,
                    generator: torch.Generator | None = None):
    """Returns ``train_step(inputs, gt) -> loss dict``: ``inputs`` a list of
    NCHW tensors in the model's input order, ``gt`` (B,1,H,W). The loss
    values are detached 0-d tensors on the model's device (no host sync).
    With ``monitor`` the dict also holds the gradient, input and
    prediction ranges (reference train_utils.py:241-267)."""
    accum_steps = int(accum_steps)
    params = [p for p in model.parameters() if p.requires_grad]
    bns = _bn_modules(model)
    if remat:
        check_recomputable(model)

    def forward(inputs):
        if remat:
            return checkpoint(model, inputs, generator=generator,
                              generators=(generator,))
        return model(inputs, generator=generator)

    def step_full(inputs, gt):
        with tracing.ranged("step.forward"):
            pred = forward(inputs)
        with tracing.ranged("step.loss"):
            losses = criterion(pred, gt)
        with tracing.ranged("step.backward"):
            losses["Total"].backward()
        return losses, pred

    def step_accum(inputs, gt, group):
        rank, world = rank_world(group)
        if group is not None:  # the global batch, in rank order
            inputs = [all_gather_rows(x, group) for x in inputs]
            gt = all_gather_rows(gt, group)
        b = gt.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} does not divide into {accum_steps} "
                             "microbatches")
        mb = b // accum_steps
        if mb % world:
            raise ValueError(f"microbatch {mb} of the global batch {b} does "
                             f"not divide over {world} ranks")
        share = mb // world
        start = [(m.running_mean.clone(), m.running_var.clone(),
                  m.num_batches_tracked.clone()) for m in bns]
        bn_sum = [(torch.zeros_like(mean), torch.zeros_like(var))
                  for mean, var, _ in start]
        loss_sum, preds = None, []
        for i in range(accum_steps):
            sl = slice(i * mb + rank * share, i * mb + (rank + 1) * share)
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
        with tracing.ranged("step.forward"):
            model.train()
            optimizer.zero_grad(set_to_none=True)
            group = process_group()
        with data_parallel(group):
            if accum_steps > 1:
                losses, pred = step_accum(inputs, gt, group)
            else:
                losses, pred = step_full(inputs, gt)
        with tracing.ranged("step.optimizer"):
            fill_unreached_grads(params)
            all_reduce_grads(params, group)
            out = {k: v.detach() for k, v in losses.items()}
            if monitor:
                with torch.no_grad():
                    grads = [p.grad for p in params]
                    out["grad_min"] = torch.stack(
                        [g.min() for g in grads]).min()
                    out["grad_max"] = torch.stack(
                        [g.max() for g in grads]).max()
                    out["input_min"] = inputs[0].min()
                    out["input_max"] = inputs[0].max()
                    out["pred_min"] = pred.detach().min()
                    out["pred_max"] = pred.detach().max()
            optimizer.step()
            return reduce_step_outputs(out, group)

    return train_step


def make_eval_step(model: torch.nn.Module, criterion=None):
    """Returns ``eval_step(inputs, gt=None) -> (pred, loss dict)``: an
    eval-mode forward without autograd and, given a criterion and ``gt``,
    its losses, with ``_total_per_sample`` (B,): the criterion's total on
    each sample alone. The eval loop averages those, so a padded remainder
    batch and a batch-statistic loss (BerHu's threshold) give what one
    sample at a time gives (the JAX package's vmap of the criterion).
    ``model=`` runs the same step on another module (a replica of
    ``model`` on another device: ``eval_model``'s mesh)."""

    home = model

    @torch.no_grad()
    def eval_step(inputs, gt=None, model=None):
        model = home if model is None else model
        model.eval()
        pred = model(inputs)
        losses = {}
        if criterion is not None and gt is not None:
            losses = {k: v.detach() for k, v in criterion(pred, gt).items()}
            losses["_total_per_sample"] = torch.stack(
                [criterion(pred[i:i + 1], gt[i:i + 1])["Total"]
                 for i in range(pred.shape[0])])
        return pred, losses

    eval_step.model = home  # what a mesh replicates (``eval.loop``)
    return eval_step
