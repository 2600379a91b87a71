"""Data parallelism of the port over processes (``jspsr_torch/parallel``)
against the JAX package, on the CPU, in 2-rank gloo groups.

Each group is started by ``parallel.spawn.run_ranks``: two fresh Python
processes, one intra-op thread each, a 60 s init timeout and one deadline
for the whole group. The checks that can share a group share one
(``ranks``, module-scoped); the JAX references are computed here, in the
test process, on the whole (global) batch:

- the cross-process BatchNorm (``nn.layers.BatchNorm2d``: each rank half
  the batch) against JAX ``BatchNorm2d`` on the whole batch with its
  two-pass statistics (``set_bn_single_pass(False)``), at rtol 1e-5 /
  atol 1e-6: the output, the running mean and variance, and the
  gradients of the input, scale and bias, inside a data-parallel step
  (``parallel.mesh.data_parallel``); outside one the same layer keeps to
  its rank's rows, group or not;
- the data-parallel train step of the tiny flagship (``num_feature=8``,
  ``layers=(1,1,1,1)``, 32^2, global batch 4) on the whole batch: its
  loss within rtol 1e-4 of JAX's ``value_and_grad``; its gradient within
  ``tests/test_train.py:275-281``'s bounds of the port's one-process step
  (at least 99 % within rtol 1e-3 / atol 1e-5 and none further than 1e-3:
  the bounds of JAX's own one-device against 4-device gradient; a deform
  offset's floor can flip), and each tensor within 5e-2 (relative L2) of
  JAX's (the cross-package bound of ``test_torch_train.py``: on such small
  batches either package's fp32 gradient is up to 2 % from float64,
  train-mode BatchNorm over few samples); then two AdamW steps against the port in one
  process at ``tests/test_multihost.py:148-155``'s bounds (losses rtol
  1e-4, the sum of every |parameter| rtol 1e-5), the ranks bit-equal;
- ``accum_steps=2`` over the ranks (global batch 8: microbatch i is
  global rows [4i, 4i+4), two on each rank) against JAX's accumulated step
  on the global batch: loss rtol 1e-4, BatchNorm running statistics
  rtol 1e-4 / atol 1e-6 (``test_torch_train.py``'s), and the gradient
  against the port's one-process accumulated step within the bounds
  above;
- CompletionFormer's drop path (its PVT backbone): each rank's keep masks
  are its rows of one process's masks for the global batch, exactly;
- the device cache: each rank's raw crops are its loader shard's raw host
  feed, bit for bit, and its normalised batches the host feed's within
  2e-6 (``test_torch_device_cache.py``'s ATOL).

Then a 2-rank preemption (``save_every_steps`` with the device cache: a
crash after a save, a relaunch in the same result dir) bit-equal to an
uninterrupted 2-rank run, as ``tests/test_multihost.py:162``; and
``dryrun_multichip(2, "cpu")``.
"""

import copy
import hashlib

import numpy as np
import pytest
import torch

from jspsr_torch.parallel.spawn import run_ranks

IN_CHANNELS = {"lr_dem": 1, "image": 3, "mask": 15}
LOSS = {"L1": 1, "L2": 1, "Grad": 0.1}
OPT = {"optimizer": "AdamW", "optimizer_kwargs": {
    "lr": 1e-3, "weight_decay": 1e-6, "momentum": 0.9, "diff_lr": False}}
WORLD = 2


def _model():
    from jspsr_torch.models.jspsr import JSPSR

    return JSPSR(dict(IN_CHANNELS), num_feature=8, layers=(1, 1, 1, 1),
                 generator=torch.Generator().manual_seed(3))


def _batch(b, seed, side=32):
    rng = np.random.default_rng(seed)
    return ([rng.uniform(0.05, 0.95, (b, c, side, side)).astype(np.float32)
             for c in IN_CHANNELS.values()],
            rng.uniform(0.05, 0.95, (b, 1, side, side)).astype(np.float32))


def _rows(arrays, rows):
    return [torch.from_numpy(np.ascontiguousarray(a[rows])) for a in arrays]


def _steps(batches, rows, accum_steps=1):
    """Train steps of the tiny flagship on ``rows`` of each batch (all
    rows in one process, a rank's in a group): each step's losses and
    gradients, the float64 sum of every |parameter| and a hash of the
    parameters' bytes after the last, and the BatchNorm statistics."""
    from jspsr_torch.config.loader import AttrDict
    from jspsr_torch.losses import build_criterion
    from jspsr_torch.train.optim import build_optimizer
    from jspsr_torch.train.step import make_train_step

    model = _model()
    opt = build_optimizer(AttrDict(OPT), model)
    step = make_train_step(model, build_criterion(LOSS), opt,
                           accum_steps=accum_steps)
    out = {"losses": [], "grads": []}
    for inputs, gt in batches:
        losses = step(_rows(inputs, rows), _rows([gt], rows)[0])
        out["losses"].append({k: float(v) for k, v in losses.items()})
        out["grads"].append({n: q.grad.numpy().copy()
                             for n, q in model.named_parameters()})
    digest = hashlib.sha256()
    for q in model.parameters():
        digest.update(q.detach().numpy().tobytes())
    out["checksum"] = float(sum(q.detach().double().abs().sum()
                                for q in model.parameters()))
    out["sha256"] = digest.hexdigest()
    out["bn"] = {n: b.numpy().copy() for n, b in model.named_buffers()
                 if "running" in n}
    return out


def _bn_half(rank, world, x, g, w, b):
    """The port's BatchNorm2d in training on this rank's rows, inside a
    data-parallel step (``data_parallel``) and, a fresh layer, outside
    one."""
    from jspsr_torch.nn.layers import BatchNorm2d
    from jspsr_torch.parallel.mesh import data_parallel, process_group

    def build():
        bn = BatchNorm2d(x.shape[1]).train()
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(w))
            bn.bias.copy_(torch.from_numpy(b))
        return bn

    bn = build()
    n = x.shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    xt = torch.from_numpy(x[rows]).requires_grad_()
    with data_parallel(process_group()):
        y = bn(xt)
        (y * torch.from_numpy(g[rows])).sum().backward()
    alone = build()
    with torch.no_grad():
        y_alone = alone(torch.from_numpy(x[rows]))
    return {"y": y.detach().numpy(), "dx": xt.grad.numpy(),
            "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
            "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy(),
            "y_alone": y_alone.numpy(),
            "mean_alone": alone.running_mean.numpy(),
            "var_alone": alone.running_var.numpy()}


def _drop_path_masks(rows, x):
    """CompletionFormer's PVT backbone (one block per stage, drop-path
    rates 0, 1/30, 2/30, 0.1) in training on ``rows`` of ``x``, its
    generator seeded for global step 8 (which drops a row of each rank):
    the keep masks it draws."""
    from jspsr_torch.models.pvt import PVT
    from jspsr_torch.parallel.mesh import data_parallel, process_group
    from jspsr_torch.train.step import seed_step_generator

    torch.manual_seed(0)
    pvt = PVT(in_chans=128, patch_size=2, depths=(1, 1, 1, 1)).train()
    drawn, keep = [], pvt.drop_path_keep

    def recording(*args):
        mask = keep(*args)
        if mask is not None:
            drawn.append(mask.flatten().numpy().copy())
        return mask

    pvt.drop_path_keep = recording
    gen = torch.Generator()
    seed_step_generator(gen, 0, 8)
    with torch.no_grad(), data_parallel(process_group()):
        pvt(torch.from_numpy(x[rows]), generator=gen)
    return drawn


def _feed_shard(rank, world, cfg):
    """This rank's shard of one epoch: the raw crops of the cache against
    the raw host feed, and the normalised batches against the host feed."""
    from jspsr_torch.config.loader import AttrDict
    from jspsr_torch.data.device_cache import DeviceSceneCache
    from jspsr_torch.data.dfc30 import DFC30
    from jspsr_torch.data.loader import DataLoader, build_batch_inputs
    from jspsr_torch.data.transforms import build_transforms

    def dataset(raw):
        p = AttrDict(dict(cfg, device_normalize=raw))
        return p, DFC30(split="train", transform=build_transforms(p)[0],
                        seed=0, **{k: v for k, v in p.items() if k != "seed"})

    def loader(ds):
        dl = DataLoader(ds, 2, shuffle=True, drop_last=True, num_workers=1,
                        seed=0, shard_index=rank, num_shards=world)
        dl.set_epoch(1)
        return dl

    p, raw_ds = dataset(True)
    cache = DeviceSceneCache(raw_ds, p, "cpu")
    raw_equal, norm_err, n = True, 0.0, 0
    host = [build_batch_inputs(b, "JSPSR", p.input_data)
            for b in loader(dataset(False)[1])]
    raw_host = [build_batch_inputs(b, "JSPSR", p.input_data)
                for b in loader(raw_ds)]
    cached = list(cache.epoch_batches(loader(raw_ds), 1))
    for idx, (h_in, h_gt, _, _), (r_in, r_gt, _, _), (c_in, c_gt, _) in zip(
            loader(raw_ds)._batches(), host, raw_host, cached):
        crops, _ = cache.raw_batch(idx, 1)
        for k, want in zip((*cache.kinds, "hr_dem"), (*r_in, r_gt)):
            raw_equal &= np.array_equal(crops[k].numpy(), want)
        for got, want in zip((*c_in, c_gt), (*h_in, h_gt)):
            norm_err = max(norm_err, float(np.abs(
                got.numpy() - want.transpose(0, 3, 1, 2)).max()))
        n += 1
    return {"batches": n, "raw_equal": bool(raw_equal),
            "norm_max_abs": norm_err}


def _group_checks(rank, world, data):
    """Every in-group check of this file on one rank."""
    half = slice(rank * 2, rank * 2 + 2)
    return {
        "bn": _bn_half(rank, world, *data["bn"]),
        "dp": _steps(data["dp"], half),
        # the global batch is the ranks' rows in rank order; the step
        # gathers it and takes this rank's share of each microbatch
        "accum": _steps(data["accum"], slice(rank * 4, rank * 4 + 4),
                        accum_steps=2),
        "drop_path": _drop_path_masks(half, data["pvt_x"]),
        "feed": _feed_shard(rank, world, data["feed_cfg"]),
    }


def _feed_cfg(root):
    return {
        "name": "ddp_feed", "dataset": "DFC30", "dataset_path": str(root),
        "resolution": 8, "train_set": ["Brest"], "valid_set": ["Vannes"],
        "input_data": {"lr_dem": 1, "COP30": 1, "image": 3, "mask": 15},
        "relative": True, "augment": True, "patch_size": 32,
        "crop_mode": "random", "patches_per_image": 1,
        "tensor_kwargs": {"log": True, "min": -80, "max": 929,
                          "scale_mask": True},
        "seed": 0,
    }


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The inputs of every in-group check and the two ranks' results."""
    from jspsr_torch.data.synthetic import generate_mini_dfc30

    rng = np.random.default_rng(0)
    root, _, _ = generate_mini_dfc30(
        tmp_path_factory.mktemp("ddp") / "DFC30_8m",
        train_cities=("Brest",), valid_cities=("Vannes",), n_per_city=8,
        size=64)
    data = {
        "bn": (rng.normal(0.3, 2.0, (4, 3, 5, 6)).astype(np.float32),
               rng.normal(0, 1, (4, 3, 5, 6)).astype(np.float32),
               rng.uniform(0.5, 1.5, 3).astype(np.float32),
               rng.normal(0, 0.5, 3).astype(np.float32)),
        "dp": [_batch(4, 8), _batch(4, 9)],
        "accum": [_batch(8, 10)],
        "pvt_x": rng.normal(0, 1, (4, 64, 32, 32)).astype(np.float32),
        "feed_cfg": _feed_cfg(root),
    }
    ranks = run_ranks(_group_checks, WORLD, data, device="cpu",
                      timeout_s=300)
    return data, ranks


@pytest.fixture
def bn_two_pass():
    from jspsr_tpu.nn import layers

    layers.set_bn_single_pass(False)
    yield
    layers.set_bn_single_pass(True)


def _grads_close(got: dict, want: dict):
    """``tests/test_train.py:275-281``'s bounds on two gradient sets."""
    a = np.concatenate([got[k].ravel() for k in sorted(want)])
    b = np.concatenate([want[k].ravel() for k in sorted(want)])
    close = np.isclose(a, b, rtol=1e-3, atol=1e-5)
    assert close.mean() > 0.99, f"only {close.mean():.2%} of grads close"
    assert np.abs(a - b).max() < 1e-3


def _rel_err(got, ref):
    return float(np.linalg.norm(got.astype(np.float64) - ref)
                 / max(np.linalg.norm(ref), 1e-12))


@pytest.mark.timeout(400)
def test_cross_process_batchnorm_matches_jax_whole_batch(group, bn_two_pass):
    import jax
    import jax.numpy as jnp

    from jspsr_tpu.nn.layers import BatchNorm2d as JaxBatchNorm2d

    (x, g, w, b), ranks = group[0]["bn"], group[1]
    bn = JaxBatchNorm2d(3)
    state = {"mean": jnp.zeros(3), "var": jnp.ones(3)}
    nhwc = (lambda a: jnp.asarray(a.transpose(0, 2, 3, 1)))

    def f(params, xx):
        y, new = bn(params, state, xx, train=True)
        return jnp.sum(y * nhwc(g)), (y, new)

    (_, (y, new)), (d_params, dx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(
        {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}, nhwc(x))
    tol = dict(rtol=1e-5, atol=1e-6)
    to_nchw = (lambda a: np.asarray(a).transpose(0, 3, 1, 2))
    got = {k: [r["bn"][k] for r in ranks] for k in ranks[0]["bn"]}
    np.testing.assert_allclose(np.concatenate(got["y"]), to_nchw(y), **tol)
    np.testing.assert_allclose(np.concatenate(got["dx"]), to_nchw(dx), **tol)
    # each rank holds its rows' share of the parameter gradients: the
    # train step's all-reduce sums them
    np.testing.assert_allclose(sum(got["dw"]), d_params["scale"], **tol)
    np.testing.assert_allclose(sum(got["db"]), d_params["bias"], **tol)
    for r in range(WORLD):
        np.testing.assert_allclose(got["mean"][r], new["mean"], **tol)
        np.testing.assert_allclose(got["var"][r], new["var"], **tol)


@pytest.mark.timeout(400)
def test_batchnorm_outside_the_step_stays_per_process(group):
    """In a process group but outside a data-parallel step (an eval, any
    other module's forward) BatchNorm takes its own rank's statistics:
    torch's BatchNorm2d on the rank's rows, and not the global batch's."""
    (x, _, w, b), ranks = group[0]["bn"], group[1]
    tol = dict(rtol=1e-5, atol=1e-6)
    for r, rank in enumerate(ranks):
        ref = torch.nn.BatchNorm2d(3).train()
        with torch.no_grad():
            ref.weight.copy_(torch.from_numpy(w))
            ref.bias.copy_(torch.from_numpy(b))
            y = ref(torch.from_numpy(x[2 * r:2 * r + 2])).numpy()
        got = rank["bn"]
        np.testing.assert_allclose(got["y_alone"], y, **tol)
        np.testing.assert_allclose(got["mean_alone"], ref.running_mean, **tol)
        np.testing.assert_allclose(got["var_alone"], ref.running_var, **tol)
        assert np.abs(got["y"] - y).max() > 1e-2  # the global statistics


@pytest.mark.timeout(400)
def test_data_parallel_step_matches_jax_global_batch(group, bn_two_pass):
    """Two ranks of 2 rows against JAX's loss and gradient on the 4 rows,
    then two AdamW steps against the port in one process."""
    import jax
    import jax.numpy as jnp

    from jspsr_tpu.losses import build_criterion as jax_build_criterion
    from jspsr_tpu.models.jspsr import JSPSR as JaxJSPSR
    from jspsr_tpu.utils.torch_import import import_torch_state_dict
    from jspsr_torch.utils.weights import state_dict_from_jax_tree

    data, ranks = group
    r0, r1 = ranks[0]["dp"], ranks[1]["dp"]
    # the ranks apply the same step: equal losses and parameters
    assert r0["losses"] == r1["losses"] and r0["sha256"] == r1["sha256"]
    port = _model()
    jm = JaxJSPSR(dict(IN_CHANNELS), num_feature=8, layers=(1, 1, 1, 1))
    params, bn = import_torch_state_dict(
        jm, {k: v.detach().numpy().copy()
             for k, v in port.state_dict().items()})
    crit = jax_build_criterion(LOSS)
    inputs, gt = data["dp"][0]
    nhwc = (lambda a: jnp.asarray(a.transpose(0, 2, 3, 1)))

    def loss_fn(prm):
        pred, _ = jm(prm, bn, [nhwc(x) for x in inputs], train=True)
        return crit(pred, nhwc(gt))["Total"]

    loss, grads = jax.value_and_grad(loss_fn)(params)
    np.testing.assert_allclose(r0["losses"][0]["Total"], float(loss),
                               rtol=1e-4)
    want = {k: v.numpy() for k, v in
            state_dict_from_jax_tree(grads, port).items()}
    for name, w in want.items():
        assert _rel_err(r0["grads"][0][name], w) < 5e-2, name
    one = _steps(data["dp"], slice(0, 4))
    _grads_close(r0["grads"][0], one["grads"][0])
    np.testing.assert_allclose([s["Total"] for s in r0["losses"]],
                               [s["Total"] for s in one["losses"]],
                               rtol=1e-4)
    np.testing.assert_allclose(r0["checksum"], one["checksum"], rtol=1e-5)


@pytest.mark.timeout(400)
def test_accum_steps_2_over_ranks_matches_jax(group, bn_two_pass):
    import jax.numpy as jnp

    from jspsr_tpu.config.loader import AttrDict as JaxAttrDict
    from jspsr_tpu.losses import build_criterion as jax_build_criterion
    from jspsr_tpu.models.jspsr import JSPSR as JaxJSPSR
    from jspsr_tpu.train import optim as jax_optim
    from jspsr_tpu.train.state import TrainState
    from jspsr_tpu.train.step import make_train_step as jax_make_train_step
    from jspsr_tpu.utils.torch_import import import_torch_state_dict
    from jspsr_torch.utils.weights import state_dict_from_jax_tree

    data, ranks = group
    r0, r1 = ranks[0]["accum"], ranks[1]["accum"]
    assert r0["losses"] == r1["losses"] and r0["sha256"] == r1["sha256"]
    port = _model()
    jm = JaxJSPSR(dict(IN_CHANNELS), num_feature=8, layers=(1, 1, 1, 1))
    params, bn = import_torch_state_dict(
        jm, {k: v.detach().numpy().copy()
             for k, v in port.state_dict().items()})
    jopt = jax_optim.build_optimizer(JaxAttrDict(OPT), params)
    jstep = jax_make_train_step(jm, jax_build_criterion(LOSS), jopt,
                                donate=False, accum_steps=2)
    (inputs, gt), = data["accum"]
    state = TrainState(params, bn, jopt.init(params), jnp.zeros((), jnp.int32))
    nhwc = (lambda a: jnp.asarray(a.transpose(0, 2, 3, 1)))
    state, jlosses = jstep(state, [nhwc(x) for x in inputs], nhwc(gt))
    for k, v in jlosses.items():
        np.testing.assert_allclose(r0["losses"][0][k], float(v), rtol=1e-4,
                                   err_msg=k)
    for name, want in state_dict_from_jax_tree(state.bn_state, port,
                                                "bn").items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(r0["bn"][name], want.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)
    one = _steps(data["accum"], slice(0, 8), accum_steps=2)
    _grads_close(r0["grads"][0], one["grads"][0])


@pytest.mark.timeout(400)
def test_drop_path_masks_are_rows_of_the_global_draws(group):
    data, ranks = group
    whole = _drop_path_masks(slice(0, 4), data["pvt_x"])
    assert len(whole) == 3  # the blocks with a rate > 0
    for r, rank in enumerate(ranks):
        got = rank["drop_path"]
        assert len(got) == len(whole)
        for g, w in zip(got, whole):
            np.testing.assert_array_equal(g, w[2 * r:2 * r + 2])
    assert all((np.concatenate(whole).reshape(3, 2, 2) == 0).any(axis=(0, 2)))


@pytest.mark.timeout(400)
def test_device_cache_shards_equal_the_host_feed(group):
    for rank in group[1]:
        feed = rank["feed"]
        assert feed["batches"] == 2  # 8 samples, 4 per rank, batch 2
        assert feed["raw_equal"]
        assert feed["norm_max_abs"] <= 2e-6


# ---------------------------------------------------------------------------
# preemption under two ranks
# ---------------------------------------------------------------------------

class _Preempted(Exception):
    """A simulated preemption."""


def _state_digest(trainer) -> str:
    digest = hashlib.sha256()
    for v in trainer.model.state_dict().values():
        digest.update(v.detach().numpy().tobytes())
    for st in trainer.optimizer.state.values():
        for k in sorted(st):
            digest.update(torch.as_tensor(st[k]).numpy().tobytes())
    return digest.hexdigest()


def _preempt_rank(rank, world, cfg, runs):
    """``runs``: [(phase, result dir)], run in order on this rank."""
    from jspsr_torch.config.loader import AttrDict
    from jspsr_torch.train.trainer import Trainer

    out = {}
    for phase, result_dir in runs:
        t = Trainer(AttrDict(copy.deepcopy(cfg)), result_dir=result_dir,
                    device="cpu")
        if phase == "crash":
            save = t._save_preempt

            def crash_after_save(epoch, steps_done, loss_sums, n_samples):
                save(epoch, steps_done, loss_sums, n_samples)
                if epoch == 1 and steps_done == 1:
                    raise _Preempted

            t._save_preempt = crash_after_save
            try:
                t.fit(initial_eval=False)
            except _Preempted:
                out[phase] = {"preempt_file": t._preempt_path().exists()}
            continue
        resumed = t._mid_resume
        result = t.fit(initial_eval=False)
        out[phase] = {"resumed": resumed and resumed[:2],
                      "loss": t.last_epoch_losses["Total"],
                      "rmse": result["result"]["RMSE"],
                      "state": _state_digest(t),
                      "preempt_file": t._preempt_path().exists()}
    return out


@pytest.mark.timeout(600)
def test_two_rank_preemption_resume_matches_control(tmp_path):
    """Two ranks of batch 1 on the device cache with ``save_every_steps:
    1``: a run that crashes after the save at epoch 1 step 1 and is
    relaunched in its result dir ends with the uninterrupted run's
    parameters, buffers, optimizer state, epoch loss and RMSE, bit for
    bit, on both ranks."""
    from jspsr_torch.data.synthetic import generate_mini_dfc30

    root, train, valid = generate_mini_dfc30(
        tmp_path / "DFC30_8m", train_cities=("Brest",),
        valid_cities=("Vannes",), n_per_city=4, size=64)
    cfg = dict(_feed_cfg(root), **{
        "name": "ddp_preempt", "workers": 1, "device_normalize": True,
        "device_cache": True, "model_name": "JSPSR",
        "model_kwargs": {"num_block": 1, "num_feature": 8, "spn": True,
                         "pretrained": False, "checkpoint": None},
        "loss": LOSS, **copy.deepcopy(OPT),
        "scheduler": "WarmupStepLR",
        "scheduler_kwargs": {"max_lr": 1e-3, "step_size": 100,
                             "gamma": 0.5, "warmup_epoch": 1},
        "train_batch_size": 1, "epochs": 2, "save_every_steps": 1,
        "valid_batch_size": 1, "val_interval": 1, "val_start_epoch": 1,
        "metric": {"RMSE": {"package": "local", "min": -80, "max": 929}},
        "best_metric": "RMSE", "verbose": False})
    ctl, run = str(tmp_path / "control"), str(tmp_path / "run")
    first = run_ranks(_preempt_rank, WORLD, cfg,
                      [("control", ctl), ("crash", run)], device="cpu",
                      timeout_s=400)
    second = run_ranks(_preempt_rank, WORLD, cfg, [("resume", run)],
                       device="cpu", timeout_s=400)
    for r in range(WORLD):
        assert first[r]["crash"] == {"preempt_file": True}
        control, resume = first[r]["control"], second[r]["resume"]
        assert control["resumed"] is None and resume["resumed"] == (1, 1)
        assert not control["preempt_file"] and not resume["preempt_file"]
        for k in ("loss", "rmse", "state"):
            assert resume[k] == control[k], k
    assert first[0]["control"] == first[1]["control"]
    assert second[0]["resume"] == second[1]["resume"]


@pytest.mark.timeout(400)
def test_dryrun_multichip_two_ranks_on_the_cpu():
    from jspsr_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(2, "cpu")
    assert out["backend"] == "gloo" and len(out["ranks"]) == 2
    assert out["ranks"][0]["cache"]["global_rows"] == 2
