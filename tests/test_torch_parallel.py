"""The port's mesh of local devices (``jspsr_torch/parallel/mesh.py``)
against the JAX package's device mesh, in one process on the CPU.

A port mesh is a list of local devices; here it names the CPU twice, as
the JAX suite's virtual CPU devices stand for chips. Every ``mesh=``
argument of the port runs and is held to the JAX package on a 2-device
mesh:

- ``shard_batch`` and ``pad_batch_to`` give the JAX shards and padding on
  the same numpy arrays, exactly;
- ``eval_model`` over a 2-entry mesh against the JAX eval over a 2-device
  mesh (``tests/test_eval_batched.py:81``'s tolerance: rtol 3e-4, and an
  atol of 1e-4 m for the order statistics Median and LE95), each batch
  split in two (the model sees halves); a batch that does not divide runs
  whole on one device, as in the JAX package;
- the scene runner and ``serve_scenes`` over a 2-entry mesh against the
  JAX runner and server over a 2-device mesh, with the same chunk count
  (``tests/test_scene_device.py:203`` and ``tests/test_serve.py:200``:
  rtol 2e-4 / atol 5e-3 m between tile batch sizes; the port against
  JAX at the whole-model rtol 1e-4 of ``test_torch_scene.py``);
- the device cache over a 2-entry mesh: each entry's slice the whole
  batch's rows, bit for bit, and the JAX cache's batch-sharded output on
  a 2-device mesh within 2e-6 (``test_torch_device_cache.py``'s ATOL);
- without a process group the collectives are no-ops and
  ``init_distributed`` joins nothing.

The multi-process checks are in ``test_torch_ddp.py``.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from jspsr_tpu.config.loader import AttrDict as JaxAttrDict
from jspsr_tpu.data.device_cache import DeviceSceneCache as JaxCache
from jspsr_tpu.data.dfc30 import DFC30 as JaxDFC30
from jspsr_tpu.data.transforms import build_transforms as jax_build_transforms
from jspsr_tpu.eval import scene as jax_scene
from jspsr_tpu.eval import serve as jax_serve
from jspsr_tpu.eval.loop import eval_model as jax_eval_model
from jspsr_tpu.losses import build_criterion as jax_build_criterion
from jspsr_tpu.models.jspsr import JSPSR as JaxJSPSR
from jspsr_tpu.parallel import mesh as jax_mesh
from jspsr_tpu.train.step import make_eval_step as jax_make_eval_step
from jspsr_tpu.utils.torch_import import import_torch_state_dict
from jspsr_torch.config.loader import AttrDict
from jspsr_torch.data.device_cache import DeviceSceneCache
from jspsr_torch.data.dfc30 import DFC30
from jspsr_torch.data.raster_io import read_raster, write_raster
from jspsr_torch.data.synthetic import generate_mini_dfc30
from jspsr_torch.data.transforms import build_transforms
from jspsr_torch.eval import scene, serve
from jspsr_torch.eval.loop import eval_model
from jspsr_torch.losses import build_criterion
from jspsr_torch.models.jspsr import JSPSR
from jspsr_torch.parallel import mesh
from jspsr_torch.train.step import make_eval_step

torch.set_num_threads(2)

CPU2 = ["cpu", "cpu"]
METRES = dict(rtol=1e-4, atol=5e-3)
BATCHES = dict(rtol=2e-4, atol=5e-3)
SCENE_P = {
    "model_name": "JSPSR", "relative": True, "normalize": False,
    "mask_channel": None, "input_data": {"lr_dem": 1, "image": 3},
    "tensor_kwargs": {"log": True, "min": -80, "max": 929,
                      "scale_mask": True},
}


def _jax_mesh(n):
    return jax_mesh.make_mesh(jax.devices()[:n])


def _tiny(inputs, seed):
    port = JSPSR(dict(inputs), num_feature=8, layers=(1, 1, 1, 1),
                 generator=torch.Generator().manual_seed(seed)).eval()
    jm = JaxJSPSR(dict(inputs), num_feature=8, layers=(1, 1, 1, 1))
    params, bn = import_torch_state_dict(jm, port.state_dict())
    return port, jm, params, bn


class _Recorder:
    """Records the batch size of every forward of ``model``."""

    def __init__(self, model):
        self.sizes = []
        self.handle = model.register_forward_pre_hook(
            lambda m, args: self.sizes.append(int(args[0][0].shape[0])))


# ---------------------------------------------------------------------------
# shard_batch / pad_batch_to
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_shard_batch_and_pad_batch_to_match_jax(n):
    rng = np.random.default_rng(n)
    tree = [rng.uniform(0, 1, (8, 5, 6, 3)).astype(np.float32),
            rng.integers(0, 255, (8, 4), dtype=np.uint8)]
    got = mesh.shard_batch(mesh.make_mesh(["cpu"] * n), tree)
    want = jax_mesh.shard_batch(_jax_mesh(n), tree)
    assert len(got) == n
    for leaf, arr in enumerate(want):
        shards = sorted(arr.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        for i, shard in enumerate(shards):
            np.testing.assert_array_equal(got[i][leaf].numpy(),
                                          np.asarray(shard.data))
            assert got[i][leaf].dtype == torch.from_numpy(tree[leaf]).dtype
    short = [x[:5] for x in tree]
    padded, real = mesh.pad_batch_to(short, 8)
    jpadded, jreal = jax_mesh.pad_batch_to(short, 8)
    assert real == jreal == 5
    for a, b in zip(padded, jpadded):
        np.testing.assert_array_equal(a, np.asarray(b))
    tpadded, _ = mesh.pad_batch_to([torch.from_numpy(x) for x in short], 8)
    for a, b in zip(tpadded, jpadded):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_batch(mesh.make_mesh(["cpu"] * 3), tree)


def test_loader_shards_are_equal_and_disjoint():
    """Five samples over two shards: each shard takes the same count (the
    epoch's order cut to a multiple of the shard count), so every rank
    steps as often as the others; together they hold distinct samples of
    the epoch's order, in it."""
    from jspsr_torch.data.loader import DataLoader

    class _Five:
        seed = 0

        def __len__(self):
            return 5

        def collate(self, items):
            return items

    whole = DataLoader(_Five(), 1, shuffle=True, seed=3)
    whole.set_epoch(2)
    order = list(whole._epoch_indices())
    shards = []
    for r in range(2):
        dl = DataLoader(_Five(), 1, shuffle=True, drop_last=True, seed=3,
                        shard_index=r, num_shards=2)
        dl.set_epoch(2)
        shards.append(list(dl._epoch_indices()))
        assert len(dl) == 2
    assert shards == [order[0:4:2], order[1:4:2]]


def test_without_a_group_the_collectives_do_nothing():
    """No process group: (rank, world) is (0, 1), ``init_distributed``
    joins nothing when the config does not ask, the gradient all-reduce,
    the state broadcast and the loss reduction leave their tensors as
    they are, and a mesh carries rank 0 of 1."""
    assert mesh.process_group() is None and mesh.rank_world() == (0, 1)
    assert mesh.init_distributed(AttrDict({}), "cpu") == 0
    assert mesh.process_group() is None
    model = torch.nn.Linear(3, 2)
    model.weight.grad = torch.ones_like(model.weight)
    model.bias.grad = torch.full_like(model.bias, 2.0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    mesh.all_reduce_grads(list(model.parameters()))
    mesh.replicate_state(model)
    assert torch.equal(model.weight.grad, torch.ones_like(model.weight))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    out = {"Total": torch.tensor(1.5)}
    assert mesh.reduce_step_outputs(out) is out
    assert mesh.broadcast_value({"a": 1}) == {"a": 1}
    assert mesh.all_ranks_agree(False) is False
    m = mesh.make_mesh(CPU2)
    assert (m.size, m.rank, m.world) == (2, 0, 1)
    assert mesh.as_mesh(CPU2).key() == ("cpu", "cpu")
    assert mesh.as_mesh(None) is None and mesh.as_mesh(m) is m
    with pytest.raises(ValueError, match="at least one device"):
        mesh.make_mesh([])


def test_replicas_follow_the_model():
    """Where the model lives on a mesh entry's device the entry runs the
    model itself; elsewhere a copy on that device, made once and
    refreshed once the model's tensors change."""
    model = torch.nn.Linear(3, 2)
    m = mesh.make_mesh(CPU2)
    assert m.replicas(model) == [model, model]
    x = torch.randn(4, 3)
    outs = m.split_forward(model, [x], call=lambda mod, xs: mod(xs[0]))
    torch.testing.assert_close(torch.cat(outs), model(x), rtol=0, atol=0)
    # another device (the meta device stands for another card): a copy,
    # made once and refreshed after the model's tensors change
    other = mesh.Mesh(["meta"])
    rep = other.replicas(model)[0]
    assert rep is not model and rep.weight.device.type == "meta"
    stamp = other._replicas[model]["meta"][0]
    with torch.no_grad():
        model.weight.add_(1.0)
    assert other.replicas(model)[0] is rep
    assert other._replicas[model]["meta"][0] != stamp


# ---------------------------------------------------------------------------
# eval_model
# ---------------------------------------------------------------------------

ELEV = {"min": -80, "max": 929}
METRIC = {"PSNR": {"package": "piq", **ELEV},
          "RMSE": {"package": "local", **ELEV},
          "Median": {"package": "local", **ELEV},
          "LE95": {"package": "local", **ELEV}}


@pytest.fixture(scope="module")
def eval_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_eval")
    root, train, valid = generate_mini_dfc30(
        tmp / "DFC30_8m", train_cities=("Brest",), valid_cities=("Vannes",),
        n_per_city=4, size=48)
    cfg = {
        "name": "mesh_eval", "dataset": "DFC30", "dataset_path": str(root),
        "resolution": 8, "train_set": train, "valid_set": valid,
        "input_data": {"lr_dem": 1, "COP30": 1, "image": 3, "mask": 15},
        "relative": True, "patch_size": 32, "crop_mode": "random",
        "patches_per_image": 1,
        "tensor_kwargs": {"log": True, "min": -80, "max": 929,
                          "scale_mask": True},
        "model_name": "JSPSR", "loss": {"L1": 1, "L2": 1, "Grad": 0.1},
        "metric": METRIC, "seed": 0,
    }
    port, jm, params, bn = _tiny({"lr_dem": 1, "image": 3, "mask": 15}, 5)
    return cfg, port, jm, params, bn


def _valid_loader(p, batch, pkg="torch"):
    from jspsr_tpu.data.loader import DataLoader as JaxDataLoader
    from jspsr_torch.data.loader import DataLoader

    dfc, tf, dl = ((DFC30, build_transforms, DataLoader) if pkg == "torch"
                   else (JaxDFC30, jax_build_transforms, JaxDataLoader))
    ds = dfc(split="valid", transform=tf(p)[1], seed=p["seed"],
             **{k: v for k, v in p.items() if k != "seed"})
    return dl(ds, batch, shuffle=False, num_workers=1)


def _assert_eval(got, want):
    keys = set(want) - {"input"}
    assert keys <= set(got)
    for k in keys:
        atol = 1e-4 if k in ("Median", "LE95") else 0
        np.testing.assert_allclose(got[k], want[k], rtol=3e-4, atol=atol,
                                   err_msg=k)


def test_eval_model_over_a_mesh_matches_jax(eval_env):
    """valid_batch_size 2 over 4 samples on a 2-entry mesh: the model sees
    halves of each batch; the scores are JAX's on a 2-device mesh, with
    the bicubic-input baseline."""
    cfg, port, jm, params, bn = eval_env
    p = AttrDict(dict(cfg, valid_batch_size=2))
    step = make_eval_step(port, build_criterion(dict(p.loss)))
    rec = _Recorder(port)
    try:
        got = eval_model(p, _valid_loader(p, 2), step, "cpu",
                         compare_input=True, mesh=CPU2)
    finally:
        rec.handle.remove()
    assert rec.sizes == [1, 1, 1, 1]  # two batches, each split in two
    jp = JaxAttrDict(dict(cfg, valid_batch_size=2))
    crit = jax_build_criterion(dict(jp.loss))
    want = jax_eval_model(jp, _valid_loader(jp, 2, "jax"),
                          jax_make_eval_step(jm, crit), params, bn, crit,
                          compare_input=True, mesh=_jax_mesh(2))
    _assert_eval(got, want)
    _assert_eval(got["input"], want["input"])
    one = eval_model(p, _valid_loader(p, 2), step, "cpu", mesh=None)
    _assert_eval(got, one)


def test_eval_model_falls_back_where_the_batch_does_not_divide(eval_env):
    """valid_batch_size 3 does not divide over 2 entries: every batch runs
    whole on the eval device, as the JAX package falls back, and the
    scores are those without a mesh, bit for bit."""
    cfg, port, _, _, _ = eval_env
    p = AttrDict(dict(cfg, valid_batch_size=3))
    step = make_eval_step(port, build_criterion(dict(p.loss)))
    rec = _Recorder(port)
    try:
        got = eval_model(p, _valid_loader(p, 3), step, "cpu", mesh=CPU2)
    finally:
        rec.handle.remove()
    assert rec.sizes == [3, 3]
    assert got == eval_model(p, _valid_loader(p, 3), step, "cpu")
    with pytest.raises(TypeError, match="make_eval_step"):
        eval_model(AttrDict(dict(cfg, valid_batch_size=2)),
                   _valid_loader(p, 2), lambda inputs, gt: None, "cpu",
                   mesh=CPU2)


# ---------------------------------------------------------------------------
# the scene runner and the server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_scene_model():
    return _tiny({"lr_dem": 1, "image": 3}, 6)


def _scene(h, w, seed):
    rng = np.random.default_rng(seed)
    return {"lr_dem": rng.uniform(10, 200, (h, w, 1)).astype(np.float32),
            "image": rng.integers(0, 255, (h, w, 3)).astype(np.float32)}


@pytest.mark.parametrize("cap", [None, 4])
def test_scene_runner_over_a_mesh_matches_jax(tiny_scene_model, cap):
    """A 160^2 scene (9 tiles of 64^2) on a 2-entry mesh: one chunk of 10
    (9 tiles and a filler) or, at cap 4, three chunks of 4 (9 tiles and 3
    fillers), each split in two, as the JAX runner rounds its chunks; the
    mosaic against the JAX runner's on a 2-device mesh, and against the
    port without a mesh; the runner cache keeps the mesh in its key."""
    port, jm, params, bn = tiny_scene_model
    p = AttrDict(copy.deepcopy(SCENE_P))
    jp = JaxAttrDict(copy.deepcopy(SCENE_P))
    s = _scene(160, 160, seed=6)
    rec = _Recorder(port)
    try:
        got, _ = scene.tile_inference_device(port, dict(s), p, tile=64,
                                             cap=cap, mesh=CPU2,
                                             device="cpu")
    finally:
        rec.handle.remove()
    assert rec.sizes == ([5, 5] if cap is None else [2] * 6)
    want, _ = jax_scene.tile_inference_device(jm, params, bn, dict(s), jp,
                                              tile=64, cap=cap,
                                              mesh=_jax_mesh(2))
    np.testing.assert_allclose(got, np.asarray(want), **METRES)
    single, _ = scene.tile_inference_device(port, dict(s), p, tile=64,
                                            cap=cap, device="cpu")
    np.testing.assert_allclose(got, single, **BATCHES)
    keys = [k for k in scene._RUNNER_CACHE if k[0] == id(port)
            and k[5] == cap]
    assert {k[-1] for k in keys} >= {None, ("cpu", "cpu")}


def test_serve_scenes_over_a_mesh_matches_jax(tiny_scene_model, tmp_path):
    """Three 96^2 scenes in groups of 2 through the server with a 2-entry
    mesh: the rasters against the JAX server's on a 2-device mesh and the
    port's without a mesh."""
    port, jm, params, bn = tiny_scene_model
    rng = np.random.default_rng(21)
    for i in range(3):
        d = tmp_path / "scenes" / f"scene{i}"
        write_raster(d / "lr_dem.npy",
                     rng.uniform(10, 200, (96, 96, 1)).astype(np.float32))
        write_raster(d / "image.npy",
                     rng.integers(0, 255, (96, 96, 3)).astype(np.uint8))
    scenes = serve.discover_scenes(tmp_path / "scenes")
    p = AttrDict(copy.deepcopy(SCENE_P))
    jp = JaxAttrDict(copy.deepcopy(SCENE_P))
    rec = _Recorder(port)
    try:
        got, _, _ = serve.serve_scenes(port, p, scenes, tmp_path / "mesh",
                                       tile=64, scene_batch=2, mesh=CPU2,
                                       device="cpu")
    finally:
        rec.handle.remove()
    assert rec.sizes == [4, 4, 4, 4]  # two groups of 2 x 4 tiles, halved
    want, _, _ = jax_serve.serve_scenes(jm, params, bn, jp, scenes,
                                        tmp_path / "jax", tile=64,
                                        scene_batch=2, mesh=_jax_mesh(2))
    plain, _, _ = serve.serve_scenes(port, p, scenes, tmp_path / "plain",
                                     tile=64, scene_batch=2, device="cpu")
    for g, w, q in zip(got, want, plain):
        np.testing.assert_allclose(read_raster(g), read_raster(w), **METRES)
        np.testing.assert_allclose(read_raster(g), read_raster(q), **BATCHES)


# ---------------------------------------------------------------------------
# the device cache
# ---------------------------------------------------------------------------

def _cache_cfg(root, train, valid):
    return {
        "name": "mesh_cache", "dataset": "DFC30", "dataset_path": str(root),
        "resolution": 8, "train_set": train, "valid_set": valid,
        "input_data": {"lr_dem": 1, "COP30": 1, "image": 3, "mask": 15},
        "relative": True, "augment": True, "patch_size": 32,
        "crop_mode": "random", "patches_per_image": 1,
        "device_normalize": True,
        "tensor_kwargs": {"log": True, "min": -80, "max": 929,
                          "scale_mask": True},
        "seed": 0, "verbose": False,
    }


def test_device_cache_over_a_mesh_matches_jax(tmp_path):
    """Four indices on a 2-entry mesh: entry i samples rows 2i, 2i+1 of
    the whole batch, bit for bit; the JAX cache's batch-sharded output on
    a 2-device mesh agrees within 2e-6."""
    root, train, valid = generate_mini_dfc30(
        tmp_path / "DFC30_8m", train_cities=("Brest",),
        valid_cities=("Vannes",), n_per_city=4, size=64)
    cfg = _cache_cfg(root, train, valid)
    p = AttrDict(cfg)
    ds = DFC30(split="train", transform=build_transforms(p)[0], seed=0,
               **{k: v for k, v in p.items() if k != "seed"})
    idx = [3, 0, 2, 1]
    whole_in, whole_gt = DeviceSceneCache(ds, p, "cpu").sample_batch(idx, 1)
    piece_in, piece_gt = DeviceSceneCache(ds, p, "cpu", mesh=CPU2) \
        .sample_batch(idx, 1)
    assert len(piece_in) == len(piece_gt) == 2
    got = [torch.cat([pc[k] for pc in piece_in])
           for k in range(len(whole_in))] + [torch.cat(piece_gt)]
    for a, b in zip(got, [*whole_in, whole_gt]):
        assert torch.equal(a, b)
    jp = JaxAttrDict(cfg)
    jds = JaxDFC30(split="train", transform=jax_build_transforms(jp)[0],
                   seed=0, **{k: v for k, v in jp.items() if k != "seed"})
    j_in, j_gt = JaxCache(jds, jp, _jax_mesh(2)).sample_batch(idx, 1)
    for a, b in zip(got, [*j_in, j_gt]):
        np.testing.assert_allclose(
            a.numpy(), np.asarray(b).transpose(0, 3, 1, 2), atol=2e-6)
    with pytest.raises(ValueError, match="does not divide"):
        DeviceSceneCache(ds, p, "cpu", mesh=["cpu"] * 3).sample_batch(idx, 1)
