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
- with ``device_normalize`` the loader ships raw crops (uint8 stays uint8;
  with ``pack_mask`` the one-hot mask bit-packed), copied channels-last
  and normalised on the device (``data.normalize.make_device_normalize``)
  on that stream; with ``device_cache`` the train split is uploaded once
  and each step's batch is cropped, augmented and normalised on the
  device (``data.device_cache.DeviceSceneCache``), or, where the split
  exceeds ``device_cache_budget_gb`` or its scenes differ in shape, the
  Trainer prints ``[device_cache] falling back to the host feed`` and
  trains on the raw host feed;
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

``save_every_steps: N`` writes a preemption checkpoint,
``_preempt_<model>.npz`` in the result dir, every N steps of an epoch: the
checkpoint's layout (the optimizer under ``torch_opt/``) with
``step_in_epoch``, ``n_samples``, ``loss_sums`` (the epoch's partial loss
sums, fp32 through a Python float and back: exact) and ``global_step`` in
its meta. A Trainer made in a result dir that holds one resumes the
interrupted epoch at that step (the JAX Trainer's preemption resume,
``jspsr_tpu/train/trainer.py:228-242,295-334``): the loader fast-forwards
with ``set_epoch(epoch, start_batch)`` (the device cache draws through the
same ``loader._batches()``), the drop-path seed follows the restored
global step, ``load(..., resume=True)`` is skipped as older, ``fit``
skips the initial eval, and ``finish`` removes the file. The resumed run
is the uninterrupted one, bit for bit. ``profile_steps: N`` writes a
``torch.profiler`` trace (host and, on the card, device) of the first N
train steps to ``<result_dir>/profile/trace_e<epoch>.json``.

It runs on the card unless ``device='cpu'`` is given, with TF32 off (the
config is fp32) and cuDNN's deterministic algorithms
(``set_deterministic_cudnn``): a step is the same, bit for bit, from the
same state.

``remat: true`` recomputes the model's activations in the backward
(``train/step.py``); ``prefetch_split: false`` stages a batch's numpy
assembly and its copy to the device on one thread, not two;
``checkpoint_backend: orbax`` writes the best-epoch and preemption
checkpoints from a background thread (``train/orbax_ckpt.py``: the same
``.npz`` files, under the same names).

Data parallelism (``parallel/mesh.py``): ``distributed: true`` (or the
``JSPSR_DISTRIBUTED`` environment variable) joins the process group
(``init_distributed``; the CLI does so before any device use) and each
process trains on its own device (``cuda:<local rank>``) with
``train_batch_size`` rows of the loader's shard ``rank::world``, the step
all-reducing its gradients and BatchNorm taking global-batch statistics.
Rank 0's state is broadcast after the init, after the pretrained
bootstrap and after every load. Rank 0 alone writes checkpoints,
``config.json``, ``metrics.jsonl``, predictions and the summary (rank n
logs its metrics to ``metrics.proc<n>.jsonl``), and a barrier follows
each save; every branch that could differ between ranks (the preemption
resume, the device cache's fallback, the eval scores behind the best
checkpoint and the early stop) takes rank 0's value, so that no rank
waits in a collective that another skipped. ``mesh`` splits the valid
batches of ``evaluate`` over local devices (``eval/loop.py``).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from jspsr_torch.data.dfc30 import DFC30
from jspsr_torch.data.loader import DataLoader, build_batch_inputs, \
    device_prefetch, input_kinds, pack_mask_np
from jspsr_torch.data.normalize import make_device_normalize
from jspsr_torch.data.transforms import build_transforms
from jspsr_torch.eval.loop import eval_model
from jspsr_torch.losses import build_criterion
from jspsr_torch.models.factory import build_model
from jspsr_torch.parallel.mesh import (
    all_ranks_agree,
    as_mesh,
    barrier,
    broadcast_value,
    init_distributed,
    is_writer,
    process_device,
    rank_world,
    replicate_state,
)
from jspsr_torch.train.checkpoint import (
    has_optimizer_state,
    load_model_state,
    load_optimizer_state,
    save_checkpoint,
)
from jspsr_torch.train.orbax_ckpt import save_checkpoint_orbax, \
    wait_for_checkpoint
from jspsr_torch.train.early_stop import EarlyStopper, do_eval, \
    validate_results
from jspsr_torch.train.optim import build_lr_schedule, build_optimizer, \
    set_learning_rate
from jspsr_torch.train.step import make_eval_step, make_train_step, \
    seed_step_generator
from jspsr_torch.utils import tracing
from jspsr_torch.utils.device import (
    resolve_device,
    set_deterministic_cudnn,
    set_strict_fp32,
)
from jspsr_torch.utils.logging import MetricLogger, serialize_config
from jspsr_torch.utils.pretrained import apply_pretrained
from jspsr_torch.utils.summary import count_parameters, start_profile, \
    stop_profile

_MONITOR_PREFIXES = ("grad_", "input_", "pred_")
CHECKPOINT_BACKENDS = ("npz", "orbax")


def _is_monitor_key(k: str) -> bool:
    """Value-range monitor entries (``monitor_value``) are per-step
    diagnostics, not loss terms: excluded from the epoch loss average."""
    return any(k.startswith(pre) for pre in _MONITOR_PREFIXES)


def _nchw(a: np.ndarray, pin: bool) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))
    return t.pin_memory() if pin else t


def _raw(a: np.ndarray, pin: bool) -> torch.Tensor:
    """A raw-feed array as it is (NHWC, its own dtype)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if pin else t


def check_device_normalize(p) -> None:
    """The JAX Trainer's asserts on the raw feed's options."""
    if p.get("pack_mask"):
        assert p.get("device_normalize"), (
            "pack_mask rides the raw device_normalize feed")
        assert "mask" in input_kinds(p.input_data), (
            "pack_mask set but no mask input")
    if p.get("device_normalize"):
        assert p.model_name.lower() in ("jspsr", "lrru"), (
            "device_normalize supports the per-modality input models "
            "(JSPSR/LRRU); channel-stacked models mix scalings in one "
            "tensor")
        assert not p.get("normalize"), (
            "device_normalize does not cover the stats Normalize list")
        tk = p.tensor_kwargs or {}
        assert not tk.get("image_range") and not tk.get("label_range"), (
            "device_normalize covers the default [0,1] ranges only")
    if p.get("device_cache"):
        assert p.get("device_normalize"), (
            "device_cache requires device_normalize (it reuses the "
            "on-device normaliser)")


class Trainer:
    def __init__(self, p, result_dir=None, device=None, verbose=None,
                 mesh=None):
        self.ckpt_backend = p.get("checkpoint_backend") or "npz"
        if self.ckpt_backend not in CHECKPOINT_BACKENDS:
            raise ValueError(f"checkpoint_backend must be one of "
                             f"{CHECKPOINT_BACKENDS}, got "
                             f"{self.ckpt_backend!r}")
        self.p = p
        device = resolve_device(device)
        init_distributed(p, device)
        self.device = process_device(device)
        self.rank, self.world = rank_world()
        self.mesh = as_mesh(mesh)
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
        replicate_state(self.model, self.optimizer)
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
            monitor=bool(p.get("monitor_value")),
            remat=bool(p.get("remat")), generator=self.generator)
        self.eval_step = make_eval_step(self.model, self.criterion)

        # stage batches on prefetch threads (default on): with
        # ``prefetch_split`` (default on) the numpy assembly in one, the
        # copy to the device in another; without, both on one
        self.prefetch_to_device = bool(p.get("device_prefetch", True))
        self.prefetch_split = bool(p.get("prefetch_split", True))
        # the raw feed: crops as they are read, normalised on the device
        check_device_normalize(p)
        self.device_normalize = bool(p.get("device_normalize"))
        self.normalize_batch = (make_device_normalize(p)
                                if self.device_normalize else None)
        self._mask_idx = (input_kinds(p.input_data).index("mask")
                          if p.get("pack_mask") else None)
        train_tf, eval_tf = build_transforms(p)
        data_kwargs = {k: v for k, v in p.items() if k != "seed"}
        self.train_set = DFC30(split="train", transform=train_tf,
                               seed=self.seed, **data_kwargs)
        self.valid_set = DFC30(split="valid", transform=eval_tf,
                               seed=self.seed, **data_kwargs)
        self.train_loader = DataLoader(
            self.train_set, p.train_batch_size, shuffle=True, drop_last=True,
            num_workers=p.get("workers", 4), seed=self.seed,
            shard_index=self.rank, num_shards=self.world)
        self.valid_loader = DataLoader(
            self.valid_set, p.get("valid_batch_size", 1), shuffle=False,
            num_workers=1)

        # device_cache: the train split on the device as raw scene stacks;
        # a split over the budget, or of scenes of several shapes, trains
        # on the raw host feed instead, as the JAX Trainer does
        self.scene_cache = None
        if p.get("device_cache"):
            from jspsr_torch.data.device_cache import DeviceSceneCache

            reason = None
            try:
                self.scene_cache = DeviceSceneCache(self.train_set, p,
                                                    self.device)
            except (ValueError, AssertionError) as e:
                reason = e
            if not all_ranks_agree(reason is None):  # every rank, one feed
                self.scene_cache = None
                print(f"[device_cache] falling back to the host feed: "
                      f"{reason or 'another rank could not build its cache'}")
            if self.scene_cache is not None and self.verbose:
                print(f"Device scene cache: {self.train_set.base_len} scenes"
                      f" ({self.scene_cache.nbytes / 2**20:.0f} MiB raw) "
                      f"resident on {self.device}")

        # the reference records the dataset sizes into the config before
        # dumping it (main.py:97-98)
        p["num_train_sample"] = len(self.train_set)
        p["num_val_sample"] = len(self.valid_set)
        if is_writer():
            serialize_config(dict(p), self.result_dir / "config.json")

        self.start_epoch = 0
        self.best_result = None
        self.metrics = MetricLogger(
            self.result_dir,
            is_writer() and p.get("monitor_app") == "tensorboard",
            "metrics.jsonl" if is_writer()
            else f"metrics.proc{self.rank}.jsonl")
        es = p.get("early_stop") or {}
        self.early_stopper = EarlyStopper(es.get("patience"),
                                          es.get("monitor") or "val_loss")

        self._profile_steps = int(p.get("profile_steps") or 0)
        self._profiled = False
        # preemption-safe mid-epoch resume: (epoch, step_in_epoch, loss
        # sums, n_samples) of a preemption checkpoint found at start
        self.save_every_steps = int(p.get("save_every_steps") or 0)
        self.last_save_ms = None
        self._mid_resume = None
        # a relaunch in this process waits for an asynchronous save in
        # flight (a no-op with the .npz backend)
        wait_for_checkpoint()
        if self.save_every_steps and broadcast_value(
                self._preempt_path().exists()):
            self._resume_preempt()

    # ------------------------------------------------------------------
    def load(self, path, resume: bool = False):
        """Load a ``.npz`` (the JAX package's or the port's; shape-filtered)
        or a reference ``.pt`` / ``.pth`` (strict) checkpoint. With
        ``resume`` it also restores ``start_epoch`` and ``best_result``
        and, from a port checkpoint, the optimizer and ``global_step``;
        other checkpoints carry no optimizer state of the port, so the
        optimizer starts fresh (optimizer state is not portable). A resume
        is skipped where a preemption checkpoint was restored: it is
        newer."""
        if resume and self._mid_resume:
            print(f"Skipping load({path}): the preemption checkpoint "
                  f"resumes epoch {self._mid_resume[0]} step "
                  f"{self._mid_resume[1]}")
            return
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
        replicate_state(self.model, self.optimizer)
        if self.verbose:
            print(f"Loaded checkpoint {path} (epoch {meta.get('epoch')}, "
                  f"resume={resume})")

    def _ckpt_path(self) -> Path:
        return self.result_dir / f"_tmp_{self.p.model_name}.npz"

    def _preempt_path(self) -> Path:
        return self.result_dir / f"_preempt_{self.p.model_name}.npz"

    def _resume_preempt(self):
        """Restore the preemption checkpoint: the weights, BatchNorm state,
        optimizer and global step, and the interrupted epoch's cursor and
        partial loss sums; ``start_epoch`` is that epoch."""
        path = self._preempt_path()
        flat, meta = load_model_state(self.model, path)
        load_optimizer_state(self.model, self.optimizer, flat, meta)
        self.global_step = int(meta["global_step"])
        self.start_epoch = int(meta["epoch"])
        self.best_result = meta.get("best_result")
        self._mid_resume = (self.start_epoch, int(meta["step_in_epoch"]),
                            meta.get("loss_sums") or {},
                            int(meta.get("n_samples", 0)))
        replicate_state(self.model, self.optimizer)
        if self.verbose:
            print(f"Preemption resume: epoch {self.start_epoch} step "
                  f"{meta['step_in_epoch']} from {path}")

    def _save_preempt(self, epoch: int, steps_done: int, loss_sums,
                      n_samples: int):
        """The preemption checkpoint after ``steps_done`` steps of
        ``epoch`` (reading the loss sums waits for the device)."""
        sums = {k: float(v) for k, v in (loss_sums or {}).items()}
        self._save(self._preempt_path(), epoch,
                   {"step_in_epoch": steps_done, "n_samples": n_samples,
                    "loss_sums": sums, "global_step": self.global_step})

    def _save(self, path: Path, epoch: int, extra: dict) -> None:
        """A checkpoint of the model and optimizer through the configured
        backend (rank 0 writes; every rank then waits at a barrier);
        ``last_save_ms``: how long the step loop waited for it."""
        save = (save_checkpoint_orbax if self.ckpt_backend == "orbax"
                else save_checkpoint)
        t0 = time.perf_counter()
        save(path, self.model, self.optimizer, epoch=epoch,
             best_result=self.best_result, extra=extra)
        barrier()
        self.last_save_ms = (time.perf_counter() - t0) * 1e3

    def _start_profile(self):
        """A ``torch.profiler`` trace of the next ``profile_steps`` train
        steps, once per run: the profiler, or None."""
        if not self._profile_steps or self._profiled:
            return None
        self._profiled = True
        return start_profile(self.device.type == "cuda")

    def _stop_profile(self, prof, epoch: int) -> None:
        proc = f".proc{self.rank}" if self.rank else ""
        out = stop_profile(prof, self.result_dir / "profile"
                           / f"trace_e{epoch:03d}{proc}.json", self.device)
        if self.verbose:
            print(f"Profiler trace ({self._profile_steps} steps) -> {out}")

    # ------------------------------------------------------------------
    def _batches(self, epoch: int):
        """(inputs, gt, batch size, copy-done event or None) per batch."""
        p, dev = self.p, self.device
        if self.scene_cache is not None:
            return ((inputs, gt, bs, None) for inputs, gt, bs in
                    self.scene_cache.epoch_batches(self.train_loader, epoch))
        cuda = dev.type == "cuda"
        copy_stream = torch.cuda.Stream(dev) if cuda else None
        normalize = self.normalize_batch

        def stage_host(batch):
            inputs_np, gt_np, base, _ = build_batch_inputs(
                batch, p.model_name, p.input_data)
            if normalize is None:
                return ([_nchw(x, cuda) for x in inputs_np],
                        _nchw(gt_np, cuda), None)
            inputs_np = list(inputs_np)
            if self._mask_idx is not None:
                inputs_np[self._mask_idx] = pack_mask_np(
                    inputs_np[self._mask_idx])
            return ([_raw(x, cuda) for x in inputs_np], _raw(gt_np, cuda),
                    _raw(base, cuda))

        def stage_transfer(staged):
            inputs, gt, base = staged
            if not cuda:
                if normalize is not None:
                    inputs, gt = normalize(inputs, gt, base)
                return inputs, gt, gt.shape[0], None
            with torch.cuda.stream(copy_stream):
                inputs = [x.to(dev, non_blocking=True) for x in inputs]
                gt = gt.to(dev, non_blocking=True)
                if normalize is not None:
                    # the raw crops in, [0, 1] NCHW batches out, on the
                    # copy stream
                    inputs, gt = normalize(
                        inputs, gt, base.to(dev, non_blocking=True))
                done = torch.cuda.Event()
                done.record(copy_stream)
            return inputs, gt, gt.shape[0], done

        if not self.prefetch_to_device:
            return (stage_transfer(stage_host(b)) for b in self.train_loader)
        if not self.prefetch_split:
            return device_prefetch(iter(self.train_loader),
                                   lambda b: stage_transfer(stage_host(b)))
        return device_prefetch(iter(self.train_loader), stage_transfer,
                               host_stage=stage_host)

    def train_one_epoch(self, epoch: int):
        """One epoch, a unit of work of ``utils/tracing.py``
        (``train.epoch``, its ``steps`` counted): ``train.epoch_start``
        spans from the call to the first batch in hand,
        ``train.feed_wait`` each later wait for a batch."""
        with tracing.unit("train.epoch", epoch=epoch) as work:
            with tracing.span("train.epoch_start"):
                p = self.p
                lr = self.lr_schedule(epoch)
                set_learning_rate(self.optimizer, lr,
                                  base_lr=p.optimizer_kwargs.lr)
                n_samples = 0
                losses = None
                # Epoch loss = batch-size-weighted mean over every step
                # (reference train_utils.py:216-240); the sums stay on the
                # device, so there is no per-step host sync.
                loss_sums = None
                start_batch = 0
                if self._mid_resume and self._mid_resume[0] == epoch:
                    # finish the interrupted epoch from its cursor, with
                    # its partial sums (fp32 -> float -> fp32 is exact)
                    _, start_batch, sums, n_samples = self._mid_resume
                    loss_sums = {k: torch.tensor(v, dtype=torch.float32,
                                                 device=self.device)
                                 for k, v in sums.items()} or None
                    self._mid_resume = None
                    if self.verbose and start_batch:
                        print(f"E{epoch:03d} resuming at step "
                              f"{start_batch}")
                self.train_loader.set_epoch(epoch, start_batch=start_batch)
                steps_done = start_batch
                n_run = 0  # samples stepped in this run, for the throughput
                prof = self._start_profile()
                profiling = self._profile_steps if prof is not None else 0
                t0 = time.perf_counter()
                batches = iter(self._batches(epoch))
                batch = next(batches, None)
            while batch is not None:
                inputs, gt, bs, done = batch
                if done is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(done)
                    # the copies were made on the side stream: keep their
                    # memory from being reused before this stream is done
                    for t in (*inputs, gt):
                        t.record_stream(stream)
                seed_step_generator(self.generator, self.seed,
                                    self.global_step)
                losses = self.train_step(inputs, gt)
                self.global_step += 1
                work.count("steps")
                step_losses = {k: v for k, v in losses.items()
                               if not _is_monitor_key(k)}
                if loss_sums is None:
                    loss_sums = {k: v * bs for k, v in step_losses.items()}
                else:
                    loss_sums = {k: loss_sums[k] + v * bs
                                 for k, v in step_losses.items()}
                n_samples += bs
                n_run += bs
                steps_done += 1
                if profiling:
                    profiling -= 1
                    if profiling == 0:
                        self._stop_profile(prof, epoch)
                if (self.save_every_steps
                        and steps_done % self.save_every_steps == 0):
                    self._save_preempt(epoch, steps_done, loss_sums,
                                       n_samples)
                with tracing.span("train.feed_wait"):
                    batch = next(batches, None)
            if profiling:  # an epoch shorter than profile_steps
                self._stop_profile(prof, epoch)
            if loss_sums:
                keys = list(loss_sums)
                sums = torch.stack([loss_sums[k] for k in keys]).cpu().tolist()
                self.last_epoch_losses = {k: v / n_samples
                                          for k, v in zip(keys, sums)}
            else:
                self.last_epoch_losses = {}
            epoch_loss = self.last_epoch_losses.get("Total", float("nan"))
            dt = time.perf_counter() - t0
            self.last_throughput = n_run / max(dt, 1e-9)  # tiles/s
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
        """The valid split's scores (``eval_model``; its batches split
        over ``mesh`` where the Trainer has one). Under a process group
        every rank evaluates the whole split on its own device, rank 0
        alone writes predictions and visuals, and every rank returns rank
        0's scores, on which the best checkpoint and the early stop
        decide."""
        if visual_dir is None and self.p.get("val_save_visual"):
            visual_dir = self.result_dir / "visuals"
        if not is_writer():
            save_dir = visual_dir = None
        return broadcast_value(eval_model(
            self.p, self.valid_loader, self.eval_step, self.device,
            compare_input=compare_input, save_dir=save_dir,
            visual_dir=visual_dir, verbose=self.verbose, mesh=self.mesh,
            normalize=self.normalize_batch))

    def fit(self, initial_eval: bool = True):
        p = self.p
        if self._mid_resume:
            initial_eval = False  # the preempted run made it
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
                    self._save(self._ckpt_path(), epoch,
                               {"global_step": self.global_step})
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
        # an asynchronous save must land before its file is renamed or
        # removed (a no-op with the .npz backend)
        wait_for_checkpoint()
        barrier()
        if self.save_every_steps and is_writer():
            # the run is complete: a preemption checkpoint left behind
            # would resume the next run in this result dir
            self._preempt_path().unlink(missing_ok=True)
        tmp = self._ckpt_path()
        final_path = tmp
        if broadcast_value(tmp.exists()) and self.best_result:
            inputs_s = "_".join(
                k for k in ("image", "mask", "canopy", "coord")
                if p.input_data.get(k)) or "dem"
            parts = [p.model_name, f"r{p.resolution}", inputs_s]
            for k in ("RMSE", "PSNR"):
                if k in self.best_result:
                    parts.append(f"{k}{self.best_result[k]:.4f}")
            final_path = self.result_dir / ("_".join(parts) + tmp.suffix)
            if is_writer():
                tmp.replace(final_path)
            barrier()
            self.load(final_path, resume=False)
        pred_dir = self.result_dir / "predictions"
        result = self.evaluate(compare_input=False, save_dir=pred_dir)
        if self.verbose:
            print(f"Final eval: "
                  f"{ {k: v for k, v in result.items() if k != 'input'} }")
        summary = self.summarise(pred_dir) if is_writer() else None
        self.metrics.close()
        return {"checkpoint": str(final_path), "result": result,
                "best_result": self.best_result, "summary": summary}
