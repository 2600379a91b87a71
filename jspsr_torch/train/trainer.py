"""Training orchestration (counterpart of ``jspsr_tpu/train/trainer.py``;
reference main.py:47-315).

``Trainer(p, device=...)`` builds the model from the factory (seeded from
``p.seed``), the criterion, the optimizer and its per-epoch schedule, the
train and valid datasets and loaders, the result directory and its
``config.json``. ``train_one_epoch(epoch)`` sets the epoch's learning rate
and runs one train step per batch, handing the model a generator
reseeded before every step from ``p.seed`` and the global step
``global_step`` (CompletionFormer's drop path; ``step.seed_step_generator``),
so that a step's draws do not depend on the steps before it:

- the host stages each batch on a prefetch thread: the loader's NHWC numpy
  arrays become NCHW tensors in pinned memory, copied to the card with
  ``non_blocking`` on a side stream that the step's stream waits on;
- the epoch loss is the batch-weighted mean of every step's losses,
  summed on the device and read back once at the end of the epoch.

``fit`` runs the run: an optional initial eval with the bicubic-input
baseline, then per epoch ``train_one_epoch``, an eval at the cadence of
``do_eval``, the best checkpoint (``best_metric``) saved with the
optimizer and ``global_step``, the early stop (after epoch 200, as the
reference), one ``metrics.jsonl`` line; then ``finish``: the best
checkpoint renamed with its scores, reloaded, a final eval that saves the
predictions, and the whole-split summary (``eval/summarise.py``).
``load(path, resume=True)`` restores what a resumed run needs to draw and
compute what an uninterrupted one does: the weights and BatchNorm state,
the optimizer, ``start_epoch``, ``best_result`` and ``global_step``.

It runs on the card unless ``device='cpu'`` is given, with TF32 off (the
config is fp32) and cuDNN's deterministic algorithms
(``set_deterministic_cudnn``): a step is the same, bit for bit, from the
same state. The options in ``NOT_PORTED``, and turning off those in
``NOT_PORTED_OFF`` (the port always does them), raise instead of being
ignored.
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
from jspsr_torch.eval.loop import eval_model
from jspsr_torch.losses import build_criterion
from jspsr_torch.models.factory import build_model
from jspsr_torch.train.checkpoint import (
    has_optimizer_state,
    load_model_state,
    load_optimizer_state,
    save_checkpoint,
)
from jspsr_torch.train.early_stop import EarlyStopper, do_eval, \
    validate_results
from jspsr_torch.train.optim import build_lr_schedule, build_optimizer, \
    set_learning_rate
from jspsr_torch.train.step import make_eval_step, make_train_step, \
    seed_step_generator
from jspsr_torch.utils.device import (
    resolve_device,
    set_deterministic_cudnn,
    set_strict_fp32,
)
from jspsr_torch.utils.logging import MetricLogger, serialize_config
from jspsr_torch.utils.pretrained import apply_pretrained
from jspsr_torch.utils.summary import count_parameters

_MONITOR_PREFIXES = ("grad_", "input_", "pred_")

# config keys of the JAX Trainer whose port has not landed
NOT_PORTED = ("device_normalize", "pack_mask", "device_cache",
              "save_every_steps", "profile_steps", "remat")
# config keys of the JAX Trainer (default on) that the port always does:
# turning one off is not yet ported (``prefetch_split``: the numpy
# assembly and the copy to the device on threads of their own)
NOT_PORTED_OFF = ("prefetch_split",)


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
        for key in NOT_PORTED_OFF:
            if not p.get(key, True):
                raise NotImplementedError(f"{key}: false is not yet ported")
        if (p.get("checkpoint_backend") or "npz") == "orbax":
            raise NotImplementedError("checkpoint_backend: orbax is not yet "
                                      "ported")
        self.p = p
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_strict_fp32()
            set_deterministic_cudnn()
        self.verbose = p.get("verbose", True) if verbose is None else verbose
        self.result_dir = Path(
            result_dir or Path(p.get("work_root", ".")) / "results" / p.name)
        self.result_dir.mkdir(parents=True, exist_ok=True)
        self.seed = p.get("seed", 0)

        # the configured pretrained weights, on the CPU, before the
        # optimizer sees the parameters
        self.model = apply_pretrained(p, build_model(p),
                                      verbose=self.verbose).to(self.device)
        if self.verbose:
            print(f"Model {p.model_name}: {count_parameters(self.model):,} "
                  f"parameters")
        self.criterion = build_criterion(dict(p.loss))
        self.optimizer = build_optimizer(p, self.model)
        self.lr_schedule = build_lr_schedule(p)
        # the model's random draws in training (drop path), reseeded from
        # (seed, global_step) before every step, as the JAX Trainer folds
        # the step into its key
        self.generator = torch.Generator(self.device)
        # optimizer steps taken since the run began: the counter that a
        # resumed run restores
        self.global_step = 0
        self.train_step = make_train_step(
            self.model, self.criterion, self.optimizer,
            accum_steps=int(p.get("accum_steps") or 1),
            monitor=bool(p.get("monitor_value")), generator=self.generator)
        self.eval_step = make_eval_step(self.model, self.criterion)

        # stage batches on prefetch threads (default on): numpy assembly
        # in one, the copy to the device in another (the JAX package's
        # ``prefetch_split``, here always on: see NOT_PORTED_OFF)
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

        self.start_epoch = 0
        self.best_result = None
        self.metrics = MetricLogger(self.result_dir,
                                    p.get("monitor_app") == "tensorboard")
        es = p.get("early_stop") or {}
        self.early_stopper = EarlyStopper(es.get("patience"),
                                          es.get("monitor") or "val_loss")

    # ------------------------------------------------------------------
    def load(self, path, resume: bool = False):
        """Load a ``.npz`` (the JAX package's or the port's; shape-filtered)
        or a reference ``.pt`` / ``.pth`` (strict) checkpoint. With
        ``resume`` it also restores ``start_epoch`` and ``best_result``
        and, from a port checkpoint, the optimizer and ``global_step``;
        other checkpoints carry no optimizer state of the port, so the
        optimizer starts fresh (optimizer state is not portable)."""
        flat, meta = load_model_state(self.model, path)
        if resume:
            if meta.get("epoch") is not None:
                self.start_epoch = meta["epoch"] + 1
                self.best_result = meta.get("best_result")
            if has_optimizer_state(flat):
                load_optimizer_state(self.model, self.optimizer, flat, meta)
                self.global_step = int(meta.get("global_step", 0))
            else:
                print(f"[checkpoint] {path} holds no optimizer state of the "
                      f"port (optimizer state is not portable): the "
                      f"optimizer starts fresh at global step "
                      f"{self.global_step}")
        if self.verbose:
            print(f"Loaded checkpoint {path} (epoch {meta.get('epoch')}, "
                  f"resume={resume})")

    def _ckpt_path(self) -> Path:
        return self.result_dir / f"_tmp_{self.p.model_name}.npz"

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
            seed_step_generator(self.generator, self.seed, self.global_step)
            losses = self.train_step(inputs, gt)
            self.global_step += 1
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
    def evaluate(self, compare_input: bool = False, save_dir=None,
                 visual_dir=None):
        if visual_dir is None and self.p.get("val_save_visual"):
            visual_dir = self.result_dir / "visuals"
        return eval_model(self.p, self.valid_loader, self.eval_step,
                          self.device, compare_input=compare_input,
                          save_dir=save_dir, visual_dir=visual_dir,
                          verbose=self.verbose)

    def fit(self, initial_eval: bool = True):
        p = self.p
        if initial_eval:
            result = self.evaluate(compare_input=True)
            if self.verbose:
                print(f"Initial eval: "
                      f"{ {k: v for k, v in result.items() if k != 'input'} }")
        warmup = (p.get("scheduler_kwargs") or {}).get("warmup_epoch", 0)
        for epoch in range(self.start_epoch, p.epochs):
            train_loss, lr = self.train_one_epoch(epoch)
            scalars = {"lr": lr, "train_loss": train_loss,
                       "train_tiles_per_sec": self.last_throughput}
            if do_eval(epoch, p.epochs, p.get("val_interval", 1),
                       p.get("val_start_epoch", 1), warmup):
                result = self.evaluate()
                scalars.update({f"val_{k.lower()}": v
                                for k, v in result.items() if k != "input"})
                cur = {k: v for k, v in result.items()
                       if k not in ("loss", "input")}
                if validate_results(self.best_result, cur,
                                    p.get("best_metric", "RMSE")):
                    self.best_result = cur
                    save_checkpoint(self._ckpt_path(), self.model,
                                    self.optimizer, epoch=epoch,
                                    best_result=self.best_result,
                                    extra={"global_step": self.global_step})
                # early stop only late in training (reference main.py:256)
                if epoch > 200:
                    metric = self.early_stopper.metric_from(
                        result["loss"], cur, train_loss)
                    if self.early_stopper(metric):
                        print(f"Early stop at epoch {epoch}")
                        break
            self.metrics.log(epoch, **scalars)
        return self.finish()

    def summarise(self, pred_dir: Path):
        """The whole-split summary of the predictions in ``pred_dir``
        against every public product found beside the ground truth
        (``eval.summarise.summarise_run``), or None, reported, when it
        fails: the scores are in, and the run keeps them."""
        try:
            from jspsr_torch.eval.summarise import summarise_run

            lr_files = dict(zip(self.valid_set.id,
                                self.valid_set.files["lr_dem"]))
            summary = summarise_run(self.p, self.valid_set, pred_dir,
                                    self.result_dir, plots=True,
                                    lr_files=lr_files)
        except Exception as e:  # the scores are in: report, do not lose them
            print(f"[summarise] skipped: {e}")
            return None
        if self.verbose:
            print(f"Offline summary: {summary['offline']}")
        return summary

    def finish(self):
        """The run's end (reference main.py:275-311): the best checkpoint
        renamed with its scores in the name and reloaded, a final eval that
        saves the predictions (without the input baseline, as the
        reference), then the whole-split summary against every public
        product found beside the ground truth."""
        p = self.p
        tmp = self._ckpt_path()
        final_path = tmp
        if tmp.exists() and self.best_result:
            inputs_s = "_".join(
                k for k in ("image", "mask", "canopy", "coord")
                if p.input_data.get(k)) or "dem"
            parts = [p.model_name, f"r{p.resolution}", inputs_s]
            for k in ("RMSE", "PSNR"):
                if k in self.best_result:
                    parts.append(f"{k}{self.best_result[k]:.4f}")
            final_path = self.result_dir / ("_".join(parts) + tmp.suffix)
            tmp.replace(final_path)
            self.load(final_path, resume=False)
        pred_dir = self.result_dir / "predictions"
        result = self.evaluate(compare_input=False, save_dir=pred_dir)
        if self.verbose:
            print(f"Final eval: "
                  f"{ {k: v for k, v in result.items() if k != 'input'} }")
        summary = self.summarise(pred_dir)
        self.metrics.close()
        return {"checkpoint": str(final_path), "result": result,
                "best_result": self.best_result, "summary": summary}
