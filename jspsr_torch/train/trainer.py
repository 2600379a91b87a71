"""Training orchestration (counterpart of ``jspsr_tpu/train/trainer.py``;
reference main.py:47-315): the constructor and the epoch loop.

``Trainer(p, device=...)`` builds the model from the factory (seeded from
``p.seed``), the criterion, the optimizer and its per-epoch schedule, the
train and valid datasets and loaders, the result directory and its
``config.json``. ``train_one_epoch(epoch)`` sets the epoch's learning rate
and runs one train step per batch:

- the host stages each batch on a prefetch thread: the loader's NHWC numpy
  arrays become NCHW tensors in pinned memory, copied to the card with
  ``non_blocking`` on a side stream that the step's stream waits on;
- the epoch loss is the batch-weighted mean of every step's losses,
  summed on the device and read back once at the end of the epoch.

It runs on the card unless ``device='cpu'`` is given, with TF32 off (the
config is fp32). ``fit``, ``evaluate`` and ``finish`` need the eval loop
and meters and are not yet ported; nor are the options in
``NOT_PORTED``, which raise instead of being ignored.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from jspsr_torch.data.dfc30 import DFC30
from jspsr_torch.data.loader import DataLoader, build_batch_inputs, \
    device_prefetch
from jspsr_torch.data.transforms import build_transforms
from jspsr_torch.losses import build_criterion
from jspsr_torch.models.factory import build_model
from jspsr_torch.train.optim import build_lr_schedule, build_optimizer, \
    set_learning_rate
from jspsr_torch.train.step import make_train_step
from jspsr_torch.utils.device import resolve_device, set_strict_fp32
from jspsr_torch.utils.logging import serialize_config
from jspsr_torch.utils.summary import count_parameters

_MONITOR_PREFIXES = ("grad_", "input_", "pred_")

# config keys of the JAX Trainer whose port has not landed
NOT_PORTED = ("device_normalize", "pack_mask", "device_cache",
              "save_every_steps", "profile_steps", "remat")


def _is_monitor_key(k: str) -> bool:
    """Value-range monitor entries (``monitor_value``) are per-step
    diagnostics, not loss terms: excluded from the epoch loss average."""
    return any(k.startswith(pre) for pre in _MONITOR_PREFIXES)


def _nchw(a: np.ndarray, pin: bool) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))
    return t.pin_memory() if pin else t


class Trainer:
    def __init__(self, p, result_dir=None, device=None, verbose=None):
        for key in NOT_PORTED:
            if p.get(key):
                raise NotImplementedError(f"{key} is not yet ported")
        if (p.get("checkpoint_backend") or "npz") == "orbax":
            raise NotImplementedError("checkpoint_backend: orbax is not yet "
                                      "ported")
        mk = p.model_kwargs
        for key in ("pretrained", "pvt_pretrained", "resnet_pretrained"):
            if mk.get(key):
                raise NotImplementedError(f"model_kwargs.{key} is not yet "
                                          "ported")
        self.p = p
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_strict_fp32()
        self.verbose = p.get("verbose", True) if verbose is None else verbose
        self.result_dir = Path(
            result_dir or Path(p.get("work_root", ".")) / "results" / p.name)
        self.result_dir.mkdir(parents=True, exist_ok=True)
        self.seed = p.get("seed", 0)

        self.model = build_model(p).to(self.device)
        if self.verbose:
            print(f"Model {p.model_name}: {count_parameters(self.model):,} "
                  f"parameters")
        self.criterion = build_criterion(dict(p.loss))
        self.optimizer = build_optimizer(p, self.model)
        self.lr_schedule = build_lr_schedule(p)
        self.train_step = make_train_step(
            self.model, self.criterion, self.optimizer,
            accum_steps=int(p.get("accum_steps") or 1),
            monitor=bool(p.get("monitor_value")))

        # stage batches on prefetch threads (default on): numpy assembly
        # in one, the copy to the device in another (the JAX package's
        # ``prefetch_split``, here always on)
        self.prefetch_to_device = bool(p.get("device_prefetch", True))
        train_tf, eval_tf = build_transforms(p)
        data_kwargs = {k: v for k, v in p.items() if k != "seed"}
        self.train_set = DFC30(split="train", transform=train_tf,
                               seed=self.seed, **data_kwargs)
        self.valid_set = DFC30(split="valid", transform=eval_tf,
                               seed=self.seed, **data_kwargs)
        self.train_loader = DataLoader(
            self.train_set, p.train_batch_size, shuffle=True, drop_last=True,
            num_workers=p.get("workers", 4), seed=self.seed)
        self.valid_loader = DataLoader(
            self.valid_set, p.get("valid_batch_size", 1), shuffle=False,
            num_workers=1)

        # the reference records the dataset sizes into the config before
        # dumping it (main.py:97-98)
        p["num_train_sample"] = len(self.train_set)
        p["num_val_sample"] = len(self.valid_set)
        serialize_config(dict(p), self.result_dir / "config.json")

    # ------------------------------------------------------------------
    def _batches(self):
        """(inputs, gt, batch size, copy-done event or None) per batch."""
        p, dev = self.p, self.device
        cuda = dev.type == "cuda"
        copy_stream = torch.cuda.Stream(dev) if cuda else None

        def stage_host(batch):
            inputs_np, gt_np, _, _ = build_batch_inputs(
                batch, p.model_name, p.input_data)
            return [_nchw(x, cuda) for x in inputs_np], _nchw(gt_np, cuda)

        def stage_transfer(staged):
            inputs, gt = staged
            if not cuda:
                return inputs, gt, gt.shape[0], None
            with torch.cuda.stream(copy_stream):
                inputs = [x.to(dev, non_blocking=True) for x in inputs]
                gt = gt.to(dev, non_blocking=True)
                done = torch.cuda.Event()
                done.record(copy_stream)
            return inputs, gt, gt.shape[0], done

        if not self.prefetch_to_device:
            return (stage_transfer(stage_host(b)) for b in self.train_loader)
        return device_prefetch(iter(self.train_loader), stage_transfer,
                               host_stage=stage_host)

    def train_one_epoch(self, epoch: int):
        p = self.p
        lr = self.lr_schedule(epoch)
        set_learning_rate(self.optimizer, lr, base_lr=p.optimizer_kwargs.lr)
        self.train_loader.set_epoch(epoch)
        n_samples = 0
        losses = None
        # Epoch loss = batch-size-weighted mean over every step (reference
        # train_utils.py:216-240); the sums stay on the device, so there is
        # no per-step host sync.
        loss_sums = None
        t0 = time.perf_counter()
        for inputs, gt, bs, done in self._batches():
            if done is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(done)
                # the copies were made on the side stream: keep their
                # memory from being reused before this stream is done
                for t in (*inputs, gt):
                    t.record_stream(stream)
            losses = self.train_step(inputs, gt)
            step_losses = {k: v for k, v in losses.items()
                           if not _is_monitor_key(k)}
            if loss_sums is None:
                loss_sums = {k: v * bs for k, v in step_losses.items()}
            else:
                loss_sums = {k: loss_sums[k] + v * bs
                             for k, v in step_losses.items()}
            n_samples += bs
        if loss_sums:
            keys = list(loss_sums)
            sums = torch.stack([loss_sums[k] for k in keys]).cpu().tolist()
            self.last_epoch_losses = {k: v / n_samples
                                      for k, v in zip(keys, sums)}
        else:
            self.last_epoch_losses = {}
        epoch_loss = self.last_epoch_losses.get("Total", float("nan"))
        dt = time.perf_counter() - t0
        self.last_throughput = n_samples / max(dt, 1e-9)  # tiles/s
        if self.verbose:
            extra = ""
            if losses is not None and "grad_max" in losses:
                extra = (f" grad[{float(losses['grad_min']):.4f},"
                         f"{float(losses['grad_max']):.4f}]"
                         f" pred[{float(losses['pred_min']):.4f},"
                         f"{float(losses['pred_max']):.4f}]")
            print(f"E{epoch:03d} loss {epoch_loss:.4e} lr {lr:.2e} "
                  f"({self.last_throughput:.1f} samples/s){extra}")
        return epoch_loss, lr

    # ------------------------------------------------------------------
    def evaluate(self, *args, **kwargs):
        raise NotImplementedError("Trainer.evaluate is not yet ported (it "
                                  "needs the eval loop and meters)")

    def fit(self, *args, **kwargs):
        raise NotImplementedError("Trainer.fit is not yet ported (it needs "
                                  "the eval loop and meters)")

    def finish(self, *args, **kwargs):
        raise NotImplementedError("Trainer.finish is not yet ported (it "
                                  "needs the eval loop and meters)")
