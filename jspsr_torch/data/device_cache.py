"""Device-resident scene cache: crop, augment and normalise on the card
(counterpart of ``jspsr_tpu/data/device_cache.py``).

With ``device_cache: true`` and a preloaded train split that fits the
budget, each modality is uploaded once as a raw (N, H, W, C) scene stack
(images, masks and canopy stay uint8). Each step then gathers the
per-sample crops, applies the dihedral augmentation per sample and runs
the raw feed's normaliser (``data.normalize.make_device_normalize``), all
on the device; the host draws only a few integers per sample and
launches. The stacks stay channels-last until the normaliser, so the
dihedral transforms act on dims (1, 2) as ``np.rot90`` / ``fliplr`` /
``flipud`` act on a sample's axes (0, 1).

Exactness: the draws replay the host pipeline's random stream, the same
``(seed, epoch, index)`` SeedSequence and the same per-transform draw order
(the transforms' ``draw`` methods), so the batches are the host feed's in
content and order (``tests/test_torch_device_cache.py``).

Data parallelism: each rank of a process group builds its own cache on
its device and samples its loader shard (the Trainer's loader takes
``rank::world``), so the ranks' batches are the host feed's shards, as
the JAX cache's per-process sampler gives them
(``jspsr_tpu/data/device_cache.py:78-105,240-256``). With ``mesh`` (a
``parallel.mesh.Mesh`` or a list of local devices) the stacks are held on
every device of the mesh and each batch comes split over it, as the JAX
sampler's batch-sharded output: ``inputs`` and ``gt`` are then lists with
one entry per mesh device, entry i that device's share of the batch,
sampled there.
"""

from __future__ import annotations

import numpy as np
import torch

from jspsr_torch.config.loader import AttrDict
from jspsr_torch.data.loader import input_kinds
from jspsr_torch.data.normalize import make_device_normalize
from jspsr_torch.parallel.mesh import as_mesh
from jspsr_torch.data.transforms import (
    Compose,
    RandomCrop,
    RandomFlipRotate90,
    TileCrop,
    TransformCtx,
)


def dihedral_batch(x: torch.Tensor, angle: torch.Tensor,
                   flip_lr: torch.Tensor,
                   flip_ud: torch.Tensor) -> torch.Tensor:
    """Per-sample rot90 then left-right flip then up-down flip of an NHWC
    batch of square tiles, as the host's ``RandomFlipRotate90`` applies
    them to each HWC sample: the three rotations are computed for the
    whole batch and selected per sample."""
    a = angle.view(-1, 1, 1, 1)
    out = x
    for k in (1, 2, 3):
        out = torch.where(a == k, torch.rot90(x, k, dims=(1, 2)), out)
    out = torch.where(flip_lr.view(-1, 1, 1, 1), out.flip(2), out)
    return torch.where(flip_ud.view(-1, 1, 1, 1), out.flip(1), out)


class DeviceSceneCache:
    """Raw scene stacks on ``device`` and the crop/augment/normalise
    sampler for one DFC30 split.

    Requires uniform square scene shapes, square crops and the
    ``device_normalize`` surface (per-modality inputs, no stats Normalize
    list, the default ranges); the train transform must be a crop and
    optionally ``RandomFlipRotate90`` (what ``build_transforms`` builds
    under ``device_normalize``). Raises ValueError or AssertionError
    otherwise, and ValueError when the stacks exceed ``budget_gb``
    (default ``p.device_cache_budget_gb``, else 8 GiB)."""

    def __init__(self, dataset, p, device, transform=None, budget_gb=None,
                 mesh=None):
        self.mesh = as_mesh(mesh)
        self.device = torch.device(device)
        self.seed = dataset.seed
        self.ppi = dataset.patches_per_image
        self.crop, self.aug = self._split_transform(
            transform if transform is not None else dataset.transform)
        self.kinds = input_kinds(p.input_data)
        local_coord = (dataset.coord_mode or "local").lower() == "local"

        stacks = {k: [] for k in (*self.kinds, "hr_dem")}
        base, shape = [], None
        for i in range(dataset.base_len):
            s = dataset.raw_scene(i)
            shape = shape or s["lr_dem"].shape[:2]
            for k in stacks:
                assert s[k].shape[:2] == shape, (
                    f"device_cache needs uniform scene shapes: scene {i} "
                    f"{k} is {s[k].shape[:2]}, expected {shape}")
                if k == "coord" and local_coord and i > 0:
                    continue  # the same for every scene: stored once
                stacks[k].append(s[k])
            base.append(s["meta"]["base"])
        self.H, self.W = shape
        assert self.H == self.W, "device_cache assumes square scenes"

        host = {k: np.stack(v) for k, v in stacks.items()}
        self.nbytes = sum(a.nbytes for a in host.values())
        budget = float(budget_gb if budget_gb is not None
                       else p.get("device_cache_budget_gb") or 8.0)
        if self.nbytes > budget * 2**30:
            raise ValueError(
                f"device_cache: scene stacks need "
                f"{self.nbytes / 2**30:.2f} GiB > budget {budget} GiB; use "
                f"the host feed (device_cache: false) or raise "
                f"device_cache_budget_gb")
        # the stacks on the cache's device and on each device of the mesh
        self._stacks = {}
        for dev in (self.device, *(self.mesh.devices if self.mesh else ())):
            if str(dev) not in self._stacks:
                self._stacks[str(dev)] = (
                    {k: torch.from_numpy(v).to(dev) for k, v in host.items()},
                    torch.tensor(base, dtype=torch.float32, device=dev))
        self.scenes, self.base_all = self._stacks[str(self.device)]
        # the crop's side: the whole scene where the crop does not apply
        cs = getattr(self.crop, "crop_size", None) if self.crop else None
        self.S = cs if (cs and cs < self.H) else self.H
        p_norm = AttrDict(dict(p))
        p_norm["pack_mask"] = False  # the mask never crosses the wire here
        self._normalize = make_device_normalize(p_norm)

    @staticmethod
    def _split_transform(transform):
        """(crop, augmentation) of the train Compose; anything the device
        path does not replicate raises."""
        crop, aug = None, None
        tfs = transform.transforms if isinstance(transform, Compose) \
            else [transform] if transform is not None else []
        for t in tfs:
            if isinstance(t, (RandomCrop, TileCrop)):
                crop = t
            elif isinstance(t, RandomFlipRotate90):
                aug = t
            else:
                raise ValueError(
                    f"device_cache cannot replicate transform {t} on "
                    f"device; use the host feed")
        return crop, aug

    def draw_batch(self, indices, epoch: int):
        """The host pipeline's draws for a batch of dataset indices (the
        loader's shuffled order): scene, crop row and column, rotation and
        the two flips, as numpy arrays."""
        n = len(indices)
        img = np.empty(n, np.int64)
        r0, c0, ang = (np.zeros(n, np.int64) for _ in range(3))
        flr, fud = np.zeros(n, bool), np.zeros(n, bool)
        for j, index in enumerate(indices):
            index = int(index)
            img[j] = index // self.ppi
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch, index]))
            ctx = TransformCtx(rng, index % self.ppi)
            if self.crop is not None:
                drawn = self.crop.draw(ctx, self.H, self.W)
                if drawn is not None:
                    r0[j], c0[j] = drawn
            if self.aug is not None:
                drawn = self.aug.draw(ctx)
                if drawn is not None:
                    ang[j], flr[j], fud[j] = drawn
        return img, r0, c0, ang, flr, fud

    def raw_batch(self, indices, epoch: int, device=None):
        """The raw crops of a batch of dataset indices, on the cache's
        device (or ``device``, one of its mesh's), as the raw host feed
        ships them: ({modality: NHWC tensor in its own dtype}, the (B,)
        bases)."""
        device = torch.device(device or self.device)
        scenes, base_all = self._stacks[str(device)]
        img, r0, c0, ang, flr, fud = (
            torch.from_numpy(a).to(device)
            for a in self.draw_batch(indices, epoch))
        span = torch.arange(self.S, device=device)
        rows = (r0[:, None] + span)[:, :, None]  # (B, S, 1)
        cols = (c0[:, None] + span)[:, None, :]  # (B, 1, S)

        def crop(stack):
            # the local coordinates are stored once: every sample reads 0
            idx = img if stack.shape[0] > 1 else torch.zeros_like(img)
            out = stack[idx[:, None, None], rows, cols]  # (B, S, S, C)
            if self.aug is not None:
                out = dihedral_batch(out, ang, flr, fud)
            return out

        return ({k: crop(v) for k, v in scenes.items()}, base_all[img])

    def sample_batch(self, indices, epoch: int):
        """(inputs, gt) for a batch of dataset indices: normalised NCHW
        fp32 tensors on the device, the host feed's batch. With a mesh,
        ``inputs`` and ``gt`` are lists with one entry per mesh device:
        its slice of the batch (which must divide by the mesh size),
        sampled on that device."""
        if self.mesh is None:
            return self._sample(indices, epoch, self.device)
        indices = np.asarray(indices)
        n = self.mesh.size
        if len(indices) % n:
            raise ValueError(f"batch {len(indices)} does not divide over "
                             f"{n} devices")
        rows = len(indices) // n
        pieces = [self._sample(indices[i * rows:(i + 1) * rows], epoch, dev)
                  for i, dev in enumerate(self.mesh.devices)]
        return [x for x, _ in pieces], [g for _, g in pieces]

    def _sample(self, indices, epoch: int, device):
        crops, base = self.raw_batch(indices, epoch, device)
        return self._normalize([crops[k] for k in self.kinds],
                               crops["hr_dem"], base)

    def epoch_batches(self, loader, epoch: int):
        """(inputs, gt, batch size) per batch in the loader's order for
        ``epoch``, as ``sample_batch`` gives them (split over the mesh
        where there is one); the loader must have been set to that epoch
        (else the shuffle and the replayed draws would come from two
        epochs)."""
        assert getattr(loader, "epoch", epoch) == epoch, (
            f"epoch_batches(epoch={epoch}) but loader.set_epoch set "
            f"{loader.epoch}: the shuffle order and the replayed draws "
            f"would desync")
        for batch_idx in loader._batches():
            inputs, gt = self.sample_batch(batch_idx, epoch)
            yield inputs, gt, len(batch_idx)
