"""The multi-process dry run (counterpart of ``dryrun_multichip`` in the JAX
package's ``__graft_entry__.py:57-271``):

    python -m jspsr_torch.parallel.dryrun [N] [--device cpu|cuda]

``dryrun_multichip(n, device)`` starts a world of ``n`` ranks
(``spawn.run_ranks``: NCCL over ``n`` cards where the host has them, else
gloo, all ranks on ``cpu`` or sharing ``cuda:0``) and checks on it:

1. one full train step of the flagship JSPSR at tiny shapes
   (``num_feature=8``, ``layers=(1,1,1,1)``, lr_dem + RGB + 15-class
   mask, SPN head, AdamW, L1 + L2 + 0.1 Grad), one 32^2 row per rank:
   the ranks' losses and parameters bit-equal, and both within the JAX
   suite's bounds of one process stepping on the whole batch (loss rtol
   1e-4, the sum of every |parameter| rtol 1e-5);
2. on each rank, the eval loop over a mesh naming the rank's device
   ``n`` times against the same eval on one device, every score within
   3e-4 relative (``__graft_entry__.py:185-187``);
3. the device scene cache over the group: each rank samples its loader
   shard, and the gathered global batch is bit-equal to one cache sampling
   the global batch's indices, whole and split over an ``n``-entry mesh;
4. for an even ``n``, the 2-D leg (``__graft_entry__.py:132-154``): the
   same world as a ``(n // 2) x 2`` (data x space) mesh
   (``mesh.make_2d_mesh``, ``spatial_sharding``), the tiny flagship's eval
   forward on the batch's first ``n // 2`` rows spatially sharded, its
   gathered output within rtol 1e-4 / atol 1e-5 of the same forward on
   each rank alone (``tests/test_train.py:308``'s bounds). The JAX leg
   takes the first ``2 (n // 2)`` devices of an odd count; a mesh of the
   port's spans its whole process group, so an odd ``n`` skips the leg and
   says so.
"""

from __future__ import annotations

import argparse
import hashlib
import tempfile

import numpy as np
import torch

from jspsr_torch.entry import IN_CHANNELS, example_arrays, flagship

LOSS = {"L1": 1, "L2": 1, "Grad": 0.1}
OPT = {"optimizer": "AdamW",
       "optimizer_kwargs": {"lr": 1e-3, "weight_decay": 1e-6,
                            "momentum": 0.9}}
SIDE = 32


def _flagship():
    return flagship(num_feature=8, layers=(1, 1, 1, 1))


def _example(batch: int, seed: int = 1):
    """(dem, img, msk, gt) NHWC numpy, as the JAX dry run draws them."""
    dem, img, msk = example_arrays(batch, SIDE, SIDE, seed)
    return dem, img, msk, np.clip(dem + 0.01, 0, 1)


def _nchw(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 3, 1, 2))).to(dev)


def train_once(dev, rows: slice, batch: int) -> dict:
    """One train step of the tiny flagship on ``rows`` of the dry run's
    batch: the loss, the float64 sum of every |parameter| after the step,
    and a hash of the parameters' bytes."""
    from jspsr_torch.config.loader import AttrDict
    from jspsr_torch.losses import build_criterion
    from jspsr_torch.parallel.mesh import replicate_state
    from jspsr_torch.train.optim import build_optimizer
    from jspsr_torch.train.step import make_train_step
    from jspsr_torch.utils.device import (
        set_deterministic_cudnn,
        set_strict_fp32,
    )

    if dev.type == "cuda":  # as the Trainer: fp32 convs, one algorithm
        set_strict_fp32()
        set_deterministic_cudnn()
    model = _flagship().to(dev)
    opt = build_optimizer(AttrDict(OPT), model)
    replicate_state(model, opt)
    step = make_train_step(model, build_criterion(LOSS), opt)
    *inputs, gt = (_nchw(a[rows], dev) for a in _example(batch))
    loss = float(step(inputs, gt)["Total"])
    params = [q.detach().cpu() for q in model.parameters()]
    digest = hashlib.sha256()
    for q in params:
        digest.update(q.numpy().tobytes())
    return {"loss": loss,
            "checksum": float(sum(q.double().abs().sum() for q in params)),
            "params_sha256": digest.hexdigest()}


def eval_on_mesh(dev, n: int) -> dict:
    """The eval loop over a mesh of ``n`` entries naming ``dev`` against
    the same eval on ``dev`` alone: {score: (mesh, one device)}."""
    from jspsr_torch.config.loader import AttrDict
    from jspsr_torch.eval.loop import eval_model
    from jspsr_torch.losses import build_criterion
    from jspsr_torch.parallel.mesh import make_mesh
    from jspsr_torch.train.step import make_eval_step

    dem, img, msk, gt = _example(n)
    p = AttrDict({
        "model_name": "JSPSR", "input_data": dict(IN_CHANNELS),
        "valid_batch_size": n,
        "tensor_kwargs": {"log": True, "min": -80, "max": 929},
        "metric": {"PSNR": {"package": "piq", "min": -80, "max": 929},
                   "RMSE": {"package": "local", "min": -80, "max": 929}}})
    batch = {"lr_dem": dem, "image": img, "mask": msk, "hr_dem": gt,
             "meta": [{"id": f"s{i}", "base": 0.0} for i in range(n)]}
    step = make_eval_step(_flagship().to(dev), build_criterion({"L1": 1}))
    r_mesh = eval_model(p, [batch], step, dev,
                        mesh=make_mesh([dev] * n))
    r_one = eval_model(p, [batch], step, dev, mesh=None)
    for k in ("loss", "PSNR", "RMSE"):
        if abs(r_mesh[k] - r_one[k]) > 3e-4 * max(abs(r_one[k]), 1):
            raise AssertionError(f"mesh eval {k}: {r_mesh[k]} vs one "
                                 f"device {r_one[k]}")
    return {k: (r_mesh[k], r_one[k]) for k in ("loss", "PSNR", "RMSE")}


def cache_config(root: str):
    from jspsr_torch.config.loader import AttrDict

    return AttrDict({
        "dataset": "DFC30", "dataset_path": root, "resolution": 8,
        "train_set": ["Brest"], "valid_set": ["Vannes"],
        "input_data": {"lr_dem": 1, "COP30": 1, "image": 3, "mask": 15},
        "relative": True, "augment": True, "patch_size": 16,
        "crop_mode": "random", "patches_per_image": 1,
        "device_normalize": True,
        "tensor_kwargs": {"log": True, "min": -80, "max": 929,
                          "scale_mask": True},
        "seed": 0})


def cache_over_group(dev, root: str, rank: int, world: int) -> dict:
    """Each rank's device cache samples its loader shard's first batch;
    the ranks' batches gathered in rank order must equal, bit for bit,
    one cache sampling the global batch's indices, whole and split over a
    ``world``-entry mesh."""
    from jspsr_torch.data.device_cache import DeviceSceneCache
    from jspsr_torch.data.dfc30 import DFC30
    from jspsr_torch.data.loader import DataLoader
    from jspsr_torch.data.transforms import build_transforms
    from jspsr_torch.parallel.mesh import all_gather_rows, make_mesh

    p = cache_config(root)
    train_tf, _ = build_transforms(p)
    ds = DFC30(split="train", transform=train_tf, seed=0,
               **{k: v for k, v in p.items() if k != "seed"})
    loader = DataLoader(ds, 1, shuffle=True, drop_last=True, seed=0,
                        shard_index=rank, num_shards=world)
    loader.set_epoch(0)
    cache = DeviceSceneCache(ds, p, dev)
    inputs, gt, _ = next(cache.epoch_batches(loader, 0))
    got = [all_gather_rows(x) for x in (*inputs, gt)]
    whole = DataLoader(ds, 1, shuffle=True, seed=0)
    whole.set_epoch(0)
    idx = whole._epoch_indices()[:world]  # row r: rank r's first index
    want_in, want_gt = cache.sample_batch(idx, 0)
    split = DeviceSceneCache(ds, p, dev, mesh=make_mesh([dev] * world))
    piece_in, piece_gt = split.sample_batch(idx, 0)
    for i, want in enumerate((*want_in, want_gt)):
        split_i = torch.cat([x[i] for x in piece_in] if i < len(want_in)
                            else piece_gt)
        if not (torch.equal(got[i], want) and torch.equal(split_i, want)):
            raise AssertionError(f"device cache over {world} ranks: "
                                 f"tensor {i} differs from the global "
                                 f"batch's")
    return {"modalities": len(inputs), "gt": list(gt.shape),
            "global_rows": int(got[-1].shape[0])}


def eval_forward(dev, batch: int, sharding=None) -> np.ndarray:
    """The tiny flagship's eval forward on the dry run's first ``batch``
    rows: on one process, or spatially sharded over ``sharding`` and
    gathered; NCHW numpy."""
    from jspsr_torch.parallel.spatial import sharded_forward
    from jspsr_torch.utils.device import set_strict_fp32

    if dev.type == "cuda":
        set_strict_fp32()
    model = _flagship().to(dev).eval()
    inputs = [_nchw(a, dev) for a in _example(batch)[:3]]
    with torch.no_grad():
        y = (model(inputs) if sharding is None
             else sharded_forward(model, inputs, sharding))
    return y.cpu().numpy()


def spatial_leg(dev, world: int) -> dict:
    """The 2-D leg on this rank: the world as a ``(world // 2) x 2`` mesh,
    the eval forward on ``world // 2`` rows sharded over it and gathered,
    the rank's deform launches in it, and the same forward on this
    process alone (the one-process reference)."""
    from jspsr_torch.ops import deform_cuda
    from jspsr_torch.parallel.mesh import make_2d_mesh, spatial_sharding

    sharding = spatial_sharding(make_2d_mesh(world // 2, 2))
    deform_cuda.reset_launches()
    y = eval_forward(dev, world // 2, sharding)
    launches = dict(deform_cuda.LAUNCHES)
    return {"sharded": y, "launches": launches,
            "one_process": eval_forward(dev, world // 2)}


def _rank_checks(rank: int, world: int, root: str, device: str) -> dict:
    """The checks on one rank, with the rank's deform kernel launches
    (``ops.deform_cuda.LAUNCHES``; none on the CPU), those of the 2-D leg
    apart."""
    from jspsr_torch.ops import deform_cuda
    from jspsr_torch.parallel.mesh import process_device

    dev = process_device(device)
    out = train_once(dev, slice(rank, rank + 1), world)
    out["eval"] = eval_on_mesh(dev, world)
    out["cache"] = cache_over_group(dev, root, rank, world)
    out["device"] = str(dev)
    out["launches"] = dict(deform_cuda.LAUNCHES)
    if world % 2 == 0:
        out["spatial"] = spatial_leg(dev, world)
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """The three checks on a world of ``n_devices`` ranks on ``device``
    (``cuda`` or ``cpu``); raises on a failure, returns rank 0's results
    with the one-process reference."""
    from jspsr_torch.data.synthetic import generate_mini_dfc30
    from jspsr_torch.parallel.spawn import run_ranks

    n = int(n_devices)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip on CUDA needs a card")
        spread = n <= torch.cuda.device_count()  # a card per rank: NCCL
        backend, rank_dev = ("nccl", "cuda") if spread else ("gloo", "cuda:0")
    else:
        backend, rank_dev = "gloo", "cpu"
    ref = train_once(dev if dev.type == "cpu" else torch.device("cuda", 0),
                     slice(0, n), n)
    with tempfile.TemporaryDirectory(prefix="jspsr_dryrun_") as td:
        generate_mini_dfc30(td, train_cities=("Brest",),
                            valid_cities=("Vannes",),
                            n_per_city=max(2, n), size=32)
        ranks = run_ranks(_rank_checks, n, td, rank_dev, device=rank_dev,
                          backend=backend, timeout_s=900)
    first = ranks[0]
    for r in ranks[1:]:
        if (r["loss"], r["params_sha256"]) != (first["loss"],
                                               first["params_sha256"]):
            raise AssertionError(f"ranks differ after the step: {ranks}")
    np.testing.assert_allclose(first["loss"], ref["loss"], rtol=1e-4)
    np.testing.assert_allclose(first["checksum"], ref["checksum"], rtol=1e-5)
    print(f"dryrun_multichip({n}, {device}): {backend} group, train step "
          f"loss {first['loss']:.6f} (one process {ref['loss']:.6f}), "
          f"checksum {first['checksum']:.6f} (one process "
          f"{ref['checksum']:.6f}), ranks bit-equal; mesh eval "
          f"{first['eval']}; device cache {first['cache']}", flush=True)
    out = {"backend": backend, "ranks": ranks, "one_process": ref}
    if n % 2:
        print(f"dryrun_multichip: no 2D leg on an odd world of {n} ranks",
              flush=True)
    else:
        for r in ranks:
            leg = r.pop("spatial")
            y, one = leg.pop("sharded"), leg.pop("one_process")
            np.testing.assert_allclose(y, one, rtol=1e-4, atol=1e-5)
            r["spatial"] = {"max_abs": float(np.abs(y - one).max()), **leg}
        print(f"dryrun_multichip: 2D mesh (data={n // 2}, space=2) "
              f"spatially-sharded forward OK {tuple(one.shape)} (max |diff| "
              f"from one process {first['spatial']['max_abs']:.3g})",
              flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("dryrun_multichip")
    ap.add_argument("n", nargs="?", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
