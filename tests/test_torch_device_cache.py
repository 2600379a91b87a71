"""The port's raw device feed against its host feed and the JAX package.

``DeviceSceneCache`` (crop, dihedral augmentation and normalisation on the
device from raw scene stacks) must give the port's host feed's batches, in
content and order, and the JAX package's ``DeviceSceneCache`` on a
one-device mesh, within 2e-6 (tests/test_device_cache.py's
``_assert_equal``: the host scales in float64 where the device scales in
fp32). ``make_device_normalize`` and ``pack_mask_np`` are held to the JAX
functions, and a Trainer epoch and an eval pass on the raw feed to the
host feed's.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from jspsr_tpu.config.loader import AttrDict as JaxAttrDict
from jspsr_tpu.data.dfc30 import DFC30 as JaxDFC30
from jspsr_tpu.data.device_cache import DeviceSceneCache as JaxCache
from jspsr_tpu.data.loader import DataLoader as JaxDataLoader
from jspsr_tpu.data.loader import pack_mask_np as jax_pack_mask_np
from jspsr_tpu.data.normalize import make_device_normalize as jax_normalize
from jspsr_tpu.data.transforms import build_transforms as jax_build_transforms
from jspsr_tpu.parallel.mesh import make_mesh
from jspsr_torch.config.loader import AttrDict
from jspsr_torch.data.device_cache import DeviceSceneCache, dihedral_batch
from jspsr_torch.data.dfc30 import DFC30
from jspsr_torch.data.loader import DataLoader, build_batch_inputs, \
    pack_mask_np
from jspsr_torch.data.normalize import make_device_normalize
from jspsr_torch.data.synthetic import generate_mini_dfc30
from jspsr_torch.data.transforms import Compose, RandomCrop, \
    build_transforms
from jspsr_torch.train.trainer import Trainer

torch.set_num_threads(2)

ATOL = 2e-6


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("DFC30_8m")
    return generate_mini_dfc30(r, train_cities=("Brest",),
                               valid_cities=("Vannes",), n_per_city=3,
                               size=64)


def _config(root, train, valid, **over):
    p = {
        "name": "cache_test",
        "dataset": "DFC30", "dataset_path": str(root), "resolution": 8,
        "train_set": train, "valid_set": valid,
        "input_data": {"lr_dem": 1, "COP30": 1, "image": 3, "mask": 15,
                       "canopy": 1, "coord": 1},
        "coord_mode": "local",
        "relative": True, "augment": True, "patch_size": 32,
        "crop_mode": "random", "patches_per_image": 1,
        "tensor_kwargs": {"log": True, "min": -80, "max": 929,
                          "scale_mask": True},
        "seed": 0, "verbose": False,
    }
    p.update(over)
    return p


def _dataset(p, raw: bool):
    p = AttrDict(dict(p, device_normalize=raw))
    train_tf, _ = build_transforms(p)
    return p, DFC30(split="train", transform=train_tf, seed=p.seed,
                    **{k: v for k, v in p.items() if k != "seed"})


def _loader(ds, batch_size, epoch):
    loader = DataLoader(ds, batch_size, shuffle=True, drop_last=True,
                        num_workers=1, seed=ds.seed)
    loader.set_epoch(epoch)
    return loader


def _nchw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def _host_batches(p, batch_size, epoch):
    """The port's host feed (ToArray on the host), NCHW."""
    _, ds = _dataset(p, raw=False)
    out = []
    for batch in _loader(ds, batch_size, epoch):
        inputs, gt, _, _ = build_batch_inputs(batch, "JSPSR", p["input_data"])
        out.append(([_nchw(x) for x in inputs], _nchw(gt)))
    return out


def _cache_batches(p, batch_size, epoch):
    p, ds = _dataset(p, raw=True)
    cache = DeviceSceneCache(ds, p, "cpu")
    return [([x.numpy() for x in inputs], gt.numpy(), bs) for inputs, gt, bs
            in cache.epoch_batches(_loader(ds, batch_size, epoch), epoch)]


def _jax_cache_batches(p, batch_size, epoch):
    """The JAX package's cache on a one-device mesh, NCHW."""
    p = JaxAttrDict(dict(p, device_normalize=True))
    train_tf, _ = jax_build_transforms(p)
    ds = JaxDFC30(split="train", transform=train_tf, seed=p.seed,
                  **{k: v for k, v in p.items() if k != "seed"})
    cache = JaxCache(ds, p, make_mesh(jax.devices()[:1]))
    loader = JaxDataLoader(ds, batch_size, shuffle=True, drop_last=True,
                           num_workers=1, seed=p.seed)
    loader.set_epoch(epoch)
    return [([_nchw(x) for x in inputs], _nchw(gt), bs)
            for inputs, gt, bs in cache.epoch_batches(loader, epoch)]


def _assert_equal(want, got):
    assert len(got) == len(want) > 0
    for (wi, wg), (gi, gg, bs) in zip(want, got):
        assert bs == wg.shape[0]
        assert len(gi) == len(wi)
        for k, (a, b) in enumerate(zip(wi, gi)):
            assert b.shape == a.shape and b.dtype == np.float32
            np.testing.assert_allclose(b, a, atol=ATOL, err_msg=f"input {k}")
        np.testing.assert_allclose(gg, wg, atol=ATOL, err_msg="gt")


@pytest.mark.parametrize("case,batch,epochs", [
    # RandomCrop + RandomFlipRotate90 + relative log scaling, every
    # modality, two shuffled epochs
    ({}, 2, (0, 1)),
    # the deterministic TileCrop (9 tiles per 64 px scene), no augmentation
    ({"crop_mode": "tile", "patches_per_image": 9, "augment": False}, 3,
     (0,)),
    # patch_size == the scene's side: whole scenes on both paths
    ({"patch_size": 64}, 2, (0,)),
], ids=["random_crop_augment", "tile_crop", "whole_scene"])
def test_cache_matches_host_and_jax(root, case, batch, epochs):
    p = _config(*root, **case)
    for epoch in epochs:
        got = _cache_batches(p, batch, epoch)
        _assert_equal(_host_batches(p, batch, epoch), got)
        _assert_equal([(i, g) for i, g, _ in
                       _jax_cache_batches(p, batch, epoch)], got)


def test_dihedral_batch_matches_numpy():
    """Each rotation and flip pair against np.rot90, fliplr, flipud on the
    HWC sample, in that order."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 255, (16, 5, 5, 3), dtype=np.uint8)
    angle = np.arange(16) % 4
    lr, ud = (np.arange(16) // 4) % 2 == 1, np.arange(16) // 8 == 1
    got = dihedral_batch(torch.from_numpy(x), torch.from_numpy(angle),
                         torch.from_numpy(lr), torch.from_numpy(ud)).numpy()
    for i in range(16):
        want = np.rot90(x[i], angle[i])
        want = np.fliplr(want) if lr[i] else want
        want = np.flipud(want) if ud[i] else want
        np.testing.assert_array_equal(got[i], want, err_msg=str(i))


def test_rejects_unsupported_transform(root):
    """A transform the device path cannot replicate is refused."""
    from jspsr_torch.data.transforms import Normalize

    p, ds = _dataset(_config(*root), raw=True)
    with pytest.raises(ValueError, match="cannot replicate"):
        DeviceSceneCache(ds, p, "cpu",
                         transform=Compose([RandomCrop(32), Normalize()]))


def test_budget_guard_and_mesh(root):
    """Stacks over the budget fail with the budget named; over a mesh of
    two entries (``parallel.mesh``) the cache samples each entry's half of
    a batch, the whole batch's rows bit for bit
    (tests/test_torch_parallel.py holds it to the JAX cache's mesh)."""
    p, ds = _dataset(_config(*root), raw=True)
    with pytest.raises(ValueError, match="budget"):
        DeviceSceneCache(ds, p, "cpu", budget_gb=1e-6)
    whole_in, whole_gt = DeviceSceneCache(ds, p, "cpu").sample_batch(
        [2, 0], 1)
    halves_in, halves_gt = DeviceSceneCache(
        ds, p, "cpu", mesh=["cpu", "cpu"]).sample_batch([2, 0], 1)
    assert len(halves_in) == len(halves_gt) == 2
    for i, (inputs, gt) in enumerate(zip(halves_in, halves_gt)):
        assert torch.equal(gt, whole_gt[i:i + 1])
        for a, b in zip(inputs, whole_in):
            assert torch.equal(a, b[i:i + 1])


def test_epoch_batches_over_a_mesh(root):
    """Over a mesh of two entries ``epoch_batches`` yields each batch
    split as ``sample_batch`` splits it: per entry, its half of the batch
    the whole cache yields, bit for bit, with the whole batch's size."""
    p, ds = _dataset(_config(*root), raw=True)
    whole = DeviceSceneCache(ds, p, "cpu")
    split = DeviceSceneCache(ds, p, "cpu", mesh=["cpu", "cpu"])
    loader = _loader(ds, 2, 1)
    n_batches = 0
    for (w_in, w_gt, w_n), (s_in, s_gt, s_n) in zip(
            whole.epoch_batches(loader, 1), split.epoch_batches(loader, 1)):
        assert s_n == w_n == 2 and len(s_in) == len(s_gt) == 2
        for i in range(2):
            assert torch.equal(s_gt[i], w_gt[i:i + 1])
            for a, b in zip(s_in[i], w_in):
                assert torch.equal(a, b[i:i + 1])
        n_batches += 1
    assert n_batches == len(ds) // 2


def test_epoch_desync_rejected(root):
    """epoch_batches(loader, e) without loader.set_epoch(e) raises."""
    p, ds = _dataset(_config(*root), raw=True)
    cache = DeviceSceneCache(ds, p, "cpu")
    loader = _loader(ds, 2, 1)
    with pytest.raises(AssertionError, match="desync"):
        next(cache.epoch_batches(loader, epoch=2))
    loader.set_epoch(2)
    next(cache.epoch_batches(loader, epoch=2))


@pytest.mark.parametrize("pack", [False, True], ids=["unpacked", "packed"])
def test_device_normalize_matches_jax(root, pack):
    """The normaliser on a raw batch (uint8 image and mask, packed or not,
    fp32 DEMs, canopy) against the JAX package's, at 1e-6, in NCHW with
    canonical strides; the pack against the JAX package's, bit for
    bit."""
    p = _config(*root, pack_mask=pack, device_normalize=True)
    _, ds = _dataset(p, raw=True)
    batch = next(iter(_loader(ds, 3, 0)))
    inputs, gt, base, _ = build_batch_inputs(batch, "JSPSR", p["input_data"])
    inputs = list(inputs)
    if pack:
        packed = pack_mask_np(inputs[2])
        np.testing.assert_array_equal(packed, jax_pack_mask_np(inputs[2]))
        assert packed.shape[-1] == 2 and packed.dtype == np.uint8
        inputs[2] = packed
    got_in, got_gt = make_device_normalize(AttrDict(p))(
        [torch.from_numpy(np.ascontiguousarray(x)) for x in inputs],
        torch.from_numpy(gt), torch.from_numpy(base))
    ref_in, ref_gt = jax_normalize(JaxAttrDict(p))(
        [jnp.asarray(x) for x in inputs], jnp.asarray(gt), jnp.asarray(base))
    assert len(got_in) == len(ref_in) == 5
    for k, (a, b) in enumerate(zip(ref_in + [ref_gt], got_in + [got_gt])):
        # canonical strides, one-channel DEMs included (cuDNN takes a
        # (H*W, 1, W, 1) tensor for channels-last)
        assert b.stride() == torch.empty(b.shape).stride(), k
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), _nchw(a), rtol=0, atol=1e-6,
                                   err_msg=f"input {k}")


def _train_config(root, train, valid, **over):
    p = _config(root, train, valid)
    p.update({
        "input_data": {"lr_dem": 1, "COP30": 1, "image": 3, "mask": 15},
        "model_name": "JSPSR",
        "model_kwargs": {"num_block": 1, "num_feature": 8, "spn": True,
                         "pretrained": False, "checkpoint": None},
        "loss": {"L1": 1, "Grad": 0.1},
        "optimizer": "AdamW",
        "optimizer_kwargs": {"lr": 1e-3, "weight_decay": 1e-6,
                             "momentum": 0.9, "diff_lr": False},
        "scheduler": "StepLR",
        "scheduler_kwargs": {"step_size": 100, "gamma": 0.5},
        "train_batch_size": 2, "epochs": 1, "valid_batch_size": 1,
        "val_interval": 1, "val_start_epoch": 1, "workers": 1,
        "metric": {"RMSE": {"package": "local", "border": 0.05,
                            "min": -80, "max": 929}},
        "best_metric": "RMSE", "val_border": 0.05,
    })
    p.update(over)
    return AttrDict(p)


def test_trainer_epoch_from_cache_matches_host_feed(root, tmp_path):
    """One Trainer epoch from the device cache against one from the host
    feed: the epoch losses at the JAX test's rtol 2e-4."""
    t_host = Trainer(_train_config(*root), result_dir=tmp_path / "host",
                     device="cpu")
    t_host.train_one_epoch(0)
    t_cache = Trainer(_train_config(*root, device_normalize=True,
                                    pack_mask=True, device_cache=True),
                      result_dir=tmp_path / "cache", device="cpu")
    assert t_cache.scene_cache is not None
    t_cache.train_one_epoch(0)
    assert t_cache.last_epoch_losses.keys() == t_host.last_epoch_losses.keys()
    for k, v in t_host.last_epoch_losses.items():
        np.testing.assert_allclose(t_cache.last_epoch_losses[k], v,
                                   rtol=2e-4, err_msg=k)


def test_trainer_budget_fallback(root, tmp_path, capsys):
    """Over the budget the Trainer prints its fallback and trains on the
    raw host feed; that epoch equals the host feed's (the same
    arithmetic as the cache's, at rtol 2e-4)."""
    t = Trainer(_train_config(*root, device_normalize=True, pack_mask=True,
                              device_cache=True,
                              device_cache_budget_gb=1e-6),
                result_dir=tmp_path / "fallback", device="cpu")
    assert t.scene_cache is None
    assert "[device_cache] falling back to the host feed" in \
        capsys.readouterr().out
    t.train_one_epoch(0)
    t_host = Trainer(_train_config(*root), result_dir=tmp_path / "host",
                     device="cpu")
    t_host.train_one_epoch(0)
    for k, v in t_host.last_epoch_losses.items():
        np.testing.assert_allclose(t.last_epoch_losses[k], v, rtol=2e-4,
                                   err_msg=k)


def test_eval_on_the_raw_feed_matches_host_feed(root, tmp_path):
    """An eval pass with device_normalize and pack_mask scores what the
    host feed's does (the bicubic-input baseline included)."""
    host = Trainer(_train_config(*root), result_dir=tmp_path / "h",
                   device="cpu")
    raw = Trainer(_train_config(*root, device_normalize=True,
                                pack_mask=True),
                  result_dir=tmp_path / "r", device="cpu")
    raw.model.load_state_dict(host.model.state_dict())
    want = host.evaluate(compare_input=True)
    got = raw.evaluate(compare_input=True)
    assert set(got) == set(want) == {"loss", "RMSE", "input"}
    for k in ("loss", "RMSE"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["input"]["RMSE"], want["input"]["RMSE"],
                               rtol=1e-5)


def test_raw_feed_visual_panels_match_host_feed(root, tmp_path,
                                                monkeypatch):
    """The visual panels of an eval pass on the raw feed are drawn from
    what ToArray gives the host feed (within 1e-6): each raw sample is
    scaled on the host by ``modality_scale``."""
    import jspsr_torch.eval.visualize as visualize

    drawn = {}

    def capture(sample, pred, tensor_kwargs, base_elev, save_path):
        drawn.setdefault(save_path.parent.name, []).append(
            (sample, pred, base_elev))

    monkeypatch.setattr(visualize, "display_predictions", capture)
    host = Trainer(_train_config(*root, val_num_visual=-1),
                   result_dir=tmp_path / "h", device="cpu")
    raw = Trainer(_train_config(*root, val_num_visual=-1,
                                device_normalize=True, pack_mask=True),
                  result_dir=tmp_path / "r", device="cpu")
    raw.model.load_state_dict(host.model.state_dict())
    host.evaluate(visual_dir=tmp_path / "host")
    raw.evaluate(visual_dir=tmp_path / "raw")
    assert len(drawn["raw"]) == len(drawn["host"]) > 0
    for (got, pred, base), (want, want_pred, want_base) in zip(
            drawn["raw"], drawn["host"]):
        assert set(got) == set(want) and base == want_base
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                       err_msg=k)
        np.testing.assert_allclose(pred, want_pred, rtol=1e-5, atol=1e-6)
