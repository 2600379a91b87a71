"""The port's spatially sharded forward and gradients
(``parallel.spatial.sharded_forward``, ``sharded_grads``) of every model
and loss beyond the fp32 flagship against the JAX package's
``spatial_sharding``, on the CPU: the bf16 flagship in both sampling
modes, the flagship's ``fuse_stems``, ``eval_grouped`` and
``remat_stages``, EDSR with and without its SPN head, LRRU, and each loss
of the registry.

Every multi-rank check runs in one world of four gloo ranks
(``parallel.spawn.run_ranks(..., device="cpu")``, ``world``,
module-scoped, with its own deadline) laid out as a 2 x 2 mesh: each rank
holds 2 rows of the batch and half of each image's rows. The JAX
references run here, in the test process, as
``tests/test_torch_spatial.py`` runs them: ``make_2d_mesh(2, 2,
jax.devices()[:4])`` on the conftest's forced CPU devices, inputs put to
``spatial_sharding``, the weights from the JAX ``model.init`` carried into
the port by ``utils/weights.py``. The weights are the port's seeded
init with its BatchNorm and conv biases perturbed (``_perturbed``), carried
into JAX by its importer, and JAX's BatchNorm runs in its two-pass form,
as ``tests/test_torch_train.py`` compares the packages' gradients.

- The bf16 flagship (``{"lr_dem": 1, "image": 3, "mask": 15}``,
  ``num_feature=8``, ``layers=(1,1,1,1)``, 4 x 32^2), with fp32 and with
  bf16 sampling: with bf16 sampling the JAX model runs under
  ``force_deform_impl("pallas")``, as ``tests/test_torch_bf16.py`` runs
  it (its CPU default, the gather form, ignores ``sample_dtype``), the
  interpret-mode kernel partitioned under ``spatial_sharding`` like any
  other op. The port's sharded eval forward is held to ``FACTOR`` times
  JAX's sharded bf16-to-fp32 distance (the outputs' largest and mean
  distance) of JAX's sharded bf16 forward, and to ``FACTOR`` times the
  port's own of its one-process bf16 forward; its MSE gradients the same
  way (each's relative L2), but against JAX at ``FACTOR`` times the larger
  of the two packages' own distances (the test's docstring says why).
- The options: the forward with ``fuse_stems`` and with ``eval_grouped``
  against JAX's sharded model with the same option at rtol 1e-4 / atol
  1e-5 (``test_train.py:308``), the L1 + L2 + 0.1 Grad gradients with
  ``remat_stages`` at ``test_train.py:446-447``'s bound; each also in
  float64 against the port's one process at ``F64_REL``. Under
  ``remat_stages`` every rank issues the same collectives in the same
  order (the recompute replays them), and the replayed BatchNorm updates
  no statistics.
- EDSR (4 blocks, 16 features, with and without ``spn``) and LRRU
  (``bc=4``, 4 x 64^2, so that its /16 slabs keep 2 rows; a smooth DEM
  with 30 % voids, as ``tests/test_torch_lrru.py``'s): the same bounds,
  with LRRU's forward at its rtol 1e-4 / atol 3e-5
  (``tests/test_torch_lrru.py:54``). LRRU's heads of rounds 1-3 get no
  gradient in the port, a zero one in JAX.
- Each loss of the registry that was not sharded before, on NCHW slabs
  alone with no model: BerHu, TV, Norm (3 channels), SSIM, BCE, softmax
  CE (with ignore labels) and balanced BCE. In float64 the ranks' summed
  losses and summed input gradients are within ``LOSS_REL`` (1e-12) of
  one process's; in fp32 the summed loss is within rtol 1e-5 of the JAX
  package's ``get_loss(name)`` on the whole batch.

Each model's row multiple (CompletionFormer's 32 among them) is refused by
name when H does not divide by it times the space axis, and SSIM refuses a
slab shorter than its window's reach. The sharded CompletionFormer is held
to JAX in ``tests/test_torch_spatial_completionformer.py``.
"""

import contextlib

import numpy as np
import pytest
import torch

from jspsr_torch.models.edsr import EDSR
from jspsr_torch.models.jspsr import JSPSR
from jspsr_torch.models.lrru import LRRU
from jspsr_torch.parallel.mesh import Mesh2D, SpatialSharding
from jspsr_torch.parallel.spawn import run_ranks
from jspsr_torch.utils.weights import state_dict_from_jax_tree

N_DATA, N_SPACE = 2, 2
WORLD = N_DATA * N_SPACE
# float64, sharded against one process: every tensor within this share of
# its largest magnitude (only the order of the sums differs)
F64_REL = 1e-9
LOSS_REL = 1e-12
# tests/test_torch_bf16.py's rule: a bf16 result's distance from its
# reference over the reference model's own bf16-to-fp32 distance
FACTOR = 2.0

FLAGSHIP = {"lr_dem": 1, "image": 3, "mask": 15}
TINY = {"num_feature": 8, "layers": (1, 1, 1, 1)}
EDSR_KW = {"in_channels": 4, "out_channels": 1, "n_resblocks": 4,
           "n_features": 16}
LRRU_IN = {"lr_dem": 1, "image": 3}
LRRU_KW = {"bc": 4, "layers": (2, 1, 1, 1, 1), "prob": 0.8}
FLAGSHIP_LOSS = {"L1": 1, "L2": 1, "Grad": 0.1}
# the bf16 gradients' loss (tests/test_torch_bf16.py::_jax_grads: an L1
# term's +-1/N sums would measure sign flips, not arithmetic)
MSE = {"L2": 1}

# case -> (family, model kwargs, the gradients' loss or None, whether the
# eval forward is checked, whether float64 is checked)
CASES = {
    "bf16": ("jspsr", {"compute_dtype": "bfloat16"}, MSE, True, False),
    "bf16_sampling": ("jspsr", {"compute_dtype": "bfloat16",
                                "spn_sample_dtype": "bfloat16"}, MSE, True,
                      False),
    "fuse_stems": ("jspsr", {"fuse_stems": True}, None, True, True),
    "eval_grouped": ("jspsr", {"eval_grouped": True}, None, True, True),
    "remat_stages": ("jspsr", {"remat_stages": True}, FLAGSHIP_LOSS, False,
                     True),
    "edsr": ("edsr", {"spn": False}, FLAGSHIP_LOSS, True, True),
    "edsr_spn": ("edsr", {"spn": True}, FLAGSHIP_LOSS, True, True),
    "lrru": ("lrru", {}, FLAGSHIP_LOSS, True, True),
}
BF16_CASES = ("bf16", "bf16_sampling")
# the bf16 cases' fp32 partner (the FACTOR rule's distance), and the plain
# flagship that ``remat_stages`` is held against: references only
REFERENCE_MODELS = {"fp32": ("jspsr", {}, MSE, True, False),
                    "plain": ("jspsr", {}, FLAGSHIP_LOSS, False, False)}
MODELS = {**CASES, **REFERENCE_MODELS}
FWD_TOL = {"lrru": (1e-4, 3e-5)}  # else (1e-4, 1e-5)
LOSSES = ("berhu", "tv", "norm", "ssim", "bce", "softmax", "balanced_bce")
# the float64 one-process references, shared out over the ranks
REFERENCES = [(case, what) for case, (_, _, loss, fwd, f64) in CASES.items()
              if f64 for what, on in (("forward", fwd),
                                      ("grads", loss is not None)) if on]


def _model(case, state=None, dtype=torch.float32):
    family, kw, *_ = MODELS[case]
    gen = torch.Generator().manual_seed(14)
    if family == "jspsr":
        model = JSPSR(dict(FLAGSHIP), **TINY, **kw, generator=gen)
    elif family == "edsr":
        model = EDSR(**EDSR_KW, **kw, generator=gen)
    else:
        model = LRRU(dict(LRRU_IN), **LRRU_KW, **kw, generator=gen)
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()})
    return model if case in BF16_CASES else model.to(dtype)


def _perturbed(model):
    """``model`` with its BatchNorm statistics and affine parameters away
    from 0/1 (``utils.perturb``) and every conv bias away from its zero
    init: at a zero bias a conv over an all-zero window (LRRU's voids) puts
    its ReLU exactly at the kink, where torch's gradient is 0 and
    ``jnp.maximum``'s 0.5, a convention and not the arithmetic under
    test."""
    from jspsr_torch.utils.perturb import perturb_weights

    perturb_weights(model, seed=2, affine=True)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.conv._ConvNd) and \
                    m.bias is not None:
                m.bias.normal_(0, 0.05, generator=gen)
    return model


def _tensors(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _forward(case, d, dtype=torch.float32):
    """The port's eval forward on the whole batch in this process."""
    with torch.no_grad():
        return _model(case, d["state"], dtype).eval()(
            _tensors(d["inputs"], dtype)).numpy()


def _grads(case, d, dtype=torch.float32):
    """The port's train-mode parameter gradients on the whole batch in
    this process."""
    from jspsr_torch.losses import build_criterion

    model = _model(case, d["state"], dtype).train()
    build_criterion(dict(MODELS[case][2]))(
        model(_tensors(d["inputs"], dtype)),
        torch.from_numpy(d["gt"]).to(dtype))["Total"].backward()
    return {k: q.grad.numpy().copy() for k, q in model.named_parameters()
            if q.grad is not None}


def _record_collectives(trace):
    """Wrap ``torch.distributed``'s ``all_gather`` and ``all_reduce`` so
    that each call appends (name, shape, dtype) to ``trace``; returns the
    undo."""
    import torch.distributed as dist

    saved = dist.all_gather, dist.all_reduce

    def gather(parts, x, *a, **k):
        trace.append(("all_gather", tuple(x.shape), str(x.dtype)))
        return saved[0](parts, x, *a, **k)

    def reduce(x, *a, **k):
        trace.append(("all_reduce", tuple(x.shape), str(x.dtype)))
        return saved[1](x, *a, **k)

    dist.all_gather, dist.all_reduce = gather, reduce

    def undo():
        dist.all_gather, dist.all_reduce = saved
    return undo


def _traced_grads(case, d, sharding):
    """``sharded_grads`` of ``case`` in fp32 with its collectives
    recorded: (gradients, trace, BatchNorm statistics after the step)."""
    from jspsr_torch.losses import build_criterion
    from jspsr_torch.parallel.spatial import sharded_grads

    model = _model(case, d["state"]).train()
    trace = []
    undo = _record_collectives(trace)
    try:
        _, grads = sharded_grads(model, build_criterion(dict(
            MODELS[case][2])), _tensors(d["inputs"]),
            torch.from_numpy(d["gt"]), sharding)
    finally:
        undo()
    stats = {k: v.numpy().copy() for k, v in model.state_dict().items()
             if "running_" in k or "num_batches" in k}
    return {k: v.numpy().copy() for k, v in grads.items()}, trace, stats


def _rank_checks(rank, world, data):
    """Every in-world check of this file on one rank of the 2 x 2 mesh,
    then its share of the one-process float64 references."""
    from jspsr_torch.losses import build_criterion, get_loss
    from jspsr_torch.parallel.mesh import (
        all_gather_list,
        make_2d_mesh,
        spatial_sharding,
    )
    from jspsr_torch.parallel.spatial import sharded_forward, sharded_grads

    sharding = spatial_sharding(make_2d_mesh(N_DATA, N_SPACE))
    out = {"models": {}, "losses": {}, "one_process": {}}
    # a bf16 tensor's bits through the exchange
    bits = (torch.arange(-7, 9) * (1 + rank) / 3).to(torch.bfloat16)
    out["bf16_gather"] = [p.float().numpy() for p in all_gather_list(
        bits, sharding.mesh.group)]
    for case, (_, _, loss, fwd, f64) in CASES.items():
        d = data["cases"][case]
        res = out["models"][case] = {}
        for dtype in (torch.float32, torch.float64)[:1 + f64]:
            key = str(dtype)
            if fwd:
                with torch.no_grad():
                    res[f"forward_{key}"] = sharded_forward(
                        _model(case, d["state"], dtype).eval(),
                        _tensors(d["inputs"], dtype),
                        sharding).numpy()
            if loss is not None:
                losses, grads = sharded_grads(
                    _model(case, d["state"], dtype).train(),
                    build_criterion(dict(loss)),
                    _tensors(d["inputs"], dtype),
                    torch.from_numpy(d["gt"]).to(dtype), sharding)
                res[f"grads_{key}"] = {k: v.numpy().copy()
                                       for k, v in grads.items()}
                res[f"losses_{key}"] = losses
    # remat_stages against the plain flagship, collectives recorded
    out["remat"] = {case: _traced_grads(case, data["cases"][case], sharding)
                    for case in ("remat_stages", "plain")}
    for name in LOSSES:
        out["losses"][name] = {}
        for dtype in (torch.float32, torch.float64):
            pred, gt = (sharding.shard(t) for t in
                        _tensors(data["losses"][name], dtype))
            pred.requires_grad_(True)
            with sharding.active():
                share = get_loss(name)(pred, gt)
            share.backward()
            total = share.detach().clone()
            torch.distributed.all_reduce(total, group=sharding.mesh.group)
            out["losses"][name][str(dtype)] = {
                "loss": float(total),
                "grad": sharding.gather(pred.grad).numpy()}
    for i, (case, what) in enumerate(REFERENCES):
        if i % world == rank:
            out["one_process"][(case, what)] = (
                _forward if what == "forward" else _grads)(
                case, data["cases"][case], torch.float64)
    return out


def _smooth_dem(rng, b, h, w, holes=0.3):
    """(B, 1, H, W) smooth terrain in [0.1, 0.9] with the share ``holes``
    of its pixels, in blobs, set to 0 (``tests/test_torch_lrru.py``'s)."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    out = []
    for _ in range(b):
        f = rng.uniform(1, 3, 4)
        ph = rng.uniform(0, 6, 2)
        dem = (0.5 + 0.3 * np.sin(f[0] * np.pi * xx + ph[0])
               * np.cos(f[1] * np.pi * yy + ph[1]) + 0.1 * xx)
        blobs = np.sin(f[2] * np.pi * xx + ph[1]) * np.sin(f[3] * np.pi * yy)
        dem[blobs > np.quantile(blobs, 1.0 - holes)] = 0.0
        out.append(dem)
    return np.asarray(out, np.float32)[:, None]


def _nhwc(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 2, 3, 1))


def _nchw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def _family_data(rng) -> dict:
    """Each family's whole-batch NCHW inputs and target."""
    def u(shape, lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    dem = u((4, 1, 32, 32), 0.3, 0.7)
    lrru_dem = _smooth_dem(rng, 4, 64, 64)
    return {
        "jspsr": ([dem, u((4, 3, 32, 32)), u((4, 15, 32, 32))],
                  np.clip(dem + rng.normal(0, 0.02, dem.shape), 0, 1)
                  .astype(np.float32)),
        "edsr": ([u((4, 1, 32, 32), 0.05, 0.95), u((4, 3, 32, 32))],
                 u((4, 1, 32, 32), 0.05, 0.95)),
        "lrru": ([lrru_dem, u((4, 3, 64, 64))],
                 np.clip(lrru_dem + 0.05, 0, 1).astype(np.float32))}


def _loss_data(rng) -> dict:
    """Each loss's whole-batch NCHW (pred, target), float64."""
    def u(c, lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, (4, c, 32, 32))

    labels = rng.integers(0, 5, (4, 1, 32, 32)).astype(np.float64)
    labels[rng.uniform(size=labels.shape) < 0.1] = 255
    return {"berhu": (u(1), u(1)), "tv": (u(1), u(1)),
            "norm": (u(3, -1, 1), u(3, -1, 1)),
            "ssim": (u(1, -0.1, 1.1), u(1)), "bce": (u(1, -3, 3), u(1)),
            "softmax": (u(5, -3, 3), labels),
            "balanced_bce": (u(1, -3, 3), u(1))}


def _jax_model(case):
    from jspsr_tpu.models.edsr import EDSR as JaxEDSR
    from jspsr_tpu.models.jspsr import JSPSR as JaxJSPSR
    from jspsr_tpu.models.lrru import LRRU as JaxLRRU

    family, kw, *_ = MODELS[case]
    if family == "jspsr":
        return JaxJSPSR(dict(FLAGSHIP), **TINY, **kw)
    if family == "edsr":
        return JaxEDSR(**EDSR_KW, **kw)
    return JaxLRRU(dict(LRRU_IN), **LRRU_KW, **kw)


def _jax_loss(name, pred, gt) -> float:
    """The JAX package's ``get_loss(name)`` on the whole batch, fp32."""
    import jax.numpy as jnp

    from jspsr_tpu.losses import get_loss

    return float(get_loss(name)(*(jnp.asarray(_nhwc(a).astype(np.float32))
                                  for a in (pred, gt))))


@pytest.fixture(scope="module")
def world():
    """The inputs of every in-world check, the JAX references (computed
    here while the four ranks run) and the four ranks' results."""
    from concurrent.futures import ThreadPoolExecutor

    import jax

    from jspsr_tpu.losses import build_criterion as jax_criterion
    from jspsr_tpu.nn.layers import set_bn_single_pass
    from jspsr_tpu.ops.deform_conv import force_deform_impl
    from jspsr_tpu.parallel.mesh import make_2d_mesh, spatial_sharding
    from jspsr_tpu.utils.torch_import import import_torch_state_dict

    rng = np.random.default_rng(14)
    made = _family_data(rng)
    data = {"losses": _loss_data(rng), "cases": {}}
    for case, (family, *_) in MODELS.items():
        # the port's seeded init, perturbed, the same for every flagship
        # case (the options and dtypes leave the parameters as they are)
        inputs, gt = made[family]
        data["cases"][case] = {
            "state": {k: v.numpy().copy() for k, v in
                      _perturbed(_model(case)).state_dict().items()},
            "inputs": inputs, "gt": gt}
    with ThreadPoolExecutor(1) as pool:
        running = pool.submit(run_ranks, _rank_checks, WORLD, data,
                              device="cpu", timeout_s=420)
        sh = spatial_sharding(make_2d_mesh(2, 2, jax.devices()[:4]))
        ref = {}
        # JAX's BatchNorm in its two-pass form, the arithmetic torch uses
        # (``tests/test_torch_train.py::bn_two_pass``)
        set_bn_single_pass(False)
        for case, (family, kw, loss, fwd, _) in MODELS.items():
            if case == "plain":
                continue
            d, jmodel, port = data["cases"][case], _jax_model(case), \
                _model(case)
            # the weights into JAX by its importer (faster here than
            # JAX's own init), its gradients back by utils/weights.py
            params, bn = import_torch_state_dict(jmodel, d["state"])
            x = [jax.device_put(_nhwc(a), sh) for a in d["inputs"]]
            if family == "edsr":  # EDSR takes its inputs stacked
                x = jax.device_put(_nhwc(np.concatenate(d["inputs"], 1)),
                                   sh)
            ref[case] = {}
            # the Pallas kernel (interpret mode) where the sampling is
            # bf16: the CPU's default gather form ignores sample_dtype
            with (force_deform_impl("pallas") if kw.get("spn_sample_dtype")
                  else contextlib.nullcontext()):
                if fwd:
                    ref[case]["forward"] = _nchw(jax.jit(
                        lambda q, s, i: jmodel(q, s, i, train=False)[0])(
                            params, bn, x))
                if loss is not None:
                    crit = jax_criterion(dict(loss))
                    g = jax.device_put(_nhwc(d["gt"]), sh)

                    def total(q):
                        return crit(jmodel(q, bn, x, train=True)[0],
                                    g)["Total"]

                    ref[case]["grads"] = {
                        k: v.numpy() for k, v in state_dict_from_jax_tree(
                            jax.jit(jax.grad(total))(params),
                            port).items()}
        set_bn_single_pass(True)
        for name, (pred, gt) in data["losses"].items():
            ref[f"loss_{name}"] = _jax_loss(name, pred, gt)
        ranks = running.result()
    one = {}
    for r in ranks:
        one.update(r["one_process"])
    return data, ref, ranks, one


# ------------------------------------------------------------- the bounds

def _rel_l2(got, ref) -> float:
    got, ref = (np.asarray(a, np.float64) for a in (got, ref))
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _jax_bound(got: dict, want: dict):
    """``tests/test_train.py:446-447``'s bound on two gradient sets."""
    a = np.concatenate([got[k].ravel() for k in sorted(want)])
    b = np.concatenate([want[k].ravel() for k in sorted(want)])
    close = np.isclose(a, b, rtol=1e-3, atol=1e-5)
    assert close.mean() > 0.99, f"only {close.mean():.2%} of grads close"
    assert np.abs(a - b).max() < 1e-3


def _float64_close(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _float64_close(got[k], want[k])
        return
    err = np.abs(got - want).max()
    assert err <= F64_REL * np.abs(want).max(), err


def _same_on_every_rank(ranks, case, key):
    first = ranks[0]["models"][case][key]
    for r in ranks[1:]:
        got = r["models"][case][key]
        for k in (first if isinstance(first, dict) else [None]):
            np.testing.assert_array_equal(
                got if k is None else got[k],
                first if k is None else first[k], err_msg=f"{case} {k}")
    return first


def _reached(jax_grads: dict, port_grads: dict) -> dict:
    """JAX's gradients of the parameters the port's reach; the others
    (LRRU's heads of rounds 1-3, which the loss sees only detached) are 0
    in JAX."""
    for k in set(jax_grads) - set(port_grads):
        assert not np.any(jax_grads[k]), k
    return {k: jax_grads[k] for k in port_grads}


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_flagship_forward_within_factor(world, case):
    """The sharded bf16 forward against JAX's sharded bf16 forward and
    against the port's one process, each within FACTOR x the reference's
    own bf16-to-fp32 distance (largest and mean)."""
    data, ref, ranks, _ = world
    got = _same_on_every_rank(ranks, case, "forward_torch.float32")
    d = data["cases"][case]
    for want, want32 in (
            (ref[case]["forward"], ref["fp32"]["forward"]),
            (_forward(case, d), _forward("fp32", data["cases"]["fp32"]))):
        dist, own = np.abs(got - want), np.abs(want - want32)
        assert dist.max() <= FACTOR * own.max(), (dist.max(), own.max())
        assert dist.mean() <= FACTOR * own.mean(), (dist.mean(), own.mean())


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_flagship_gradients_within_factor(world, case):
    """The sharded bf16 model's summed MSE gradients: fp32, finite, the
    same on every rank; each (relative L2) within FACTOR x the port's own
    one-process bf16-to-fp32 distance of its one-process bf16 gradient,
    and within FACTOR x the larger of the two packages' own distances of
    JAX's sharded bf16 gradient.

    JAX's own distance alone does not bound the second: on this batch the
    port's one-process bf16 gradients are up to 3.2x JAX's distance from
    JAX's (``postprocessor.b``, a sum of signed residuals, and
    ``conv0.camb.fc.0.weight``), exactly as far as the sharded ones (which
    are within 1.2e-7 of one process), and JAX's sharded gradients equal
    its replicated ones there: the two packages round at different points,
    and two bf16 models are each within their own distance of fp32, so
    their distance is bounded by the sum of both (at most 1.9x the larger
    here)."""
    data, ref, ranks, _ = world
    got = _same_on_every_rank(ranks, case, "grads_torch.float32")
    d = data["cases"][case]
    one, one32 = _grads(case, d), _grads("fp32", data["cases"]["fp32"])
    jax_bf, jax_32 = ref[case]["grads"], ref["fp32"]["grads"]
    assert sorted(got) == sorted(jax_bf) == sorted(one)
    for k, g in got.items():
        assert g.dtype == np.float32 and np.isfinite(g).all(), k
        own = _rel_l2(one[k], one32[k])
        assert _rel_l2(g, one[k]) <= FACTOR * own + 1e-6, \
            (k, _rel_l2(g, one[k]), own)
        both = max(own, _rel_l2(jax_bf[k], jax_32[k]))
        assert _rel_l2(g, jax_bf[k]) <= FACTOR * both + 1e-6, \
            (k, _rel_l2(g, jax_bf[k]), both)


@pytest.mark.parametrize("case", ["fuse_stems", "eval_grouped", "edsr",
                                  "edsr_spn", "lrru"])
def test_sharded_forward_matches_jax_and_float64(world, case):
    _, ref, ranks, one = world
    got = _same_on_every_rank(ranks, case, "forward_torch.float32")
    rtol, atol = FWD_TOL.get(case, (1e-4, 1e-5))
    np.testing.assert_allclose(got, ref[case]["forward"], rtol=rtol,
                               atol=atol)
    _float64_close(ranks[0]["models"][case]["forward_torch.float64"],
                   one[(case, "forward")])


@pytest.mark.parametrize("case", ["remat_stages", "edsr", "edsr_spn",
                                  "lrru"])
def test_sharded_gradients_match_jax_and_float64(world, case):
    _, ref, ranks, one = world
    got = _same_on_every_rank(ranks, case, "grads_torch.float32")
    _jax_bound(got, _reached(ref[case]["grads"], got))
    _float64_close(ranks[0]["models"][case]["grads_torch.float64"],
                   one[(case, "grads")])


def test_remat_stages_replays_collectives_in_one_order(world):
    """Under ``remat_stages`` every rank issues the same collectives, in
    the same order, and more of them than without (the recompute replays
    the halos, pools and BatchNorm all-reduces); the gradients are the
    plain flagship's, and the replayed BatchNorm updated no statistics:
    they are the plain step's, bit for bit."""
    ranks = world[2]
    trace = ranks[0]["remat"]["remat_stages"][1]
    plain_grads, plain_trace, plain_stats = ranks[0]["remat"]["plain"]
    for r in ranks[1:]:
        assert r["remat"]["remat_stages"][1] == trace
        assert r["remat"]["plain"][1] == plain_trace
    assert len(trace) > len(plain_trace)
    grads, _, stats = ranks[0]["remat"]["remat_stages"]
    _jax_bound(grads, plain_grads)
    assert sorted(stats) == sorted(plain_stats)
    for k, v in plain_stats.items():
        np.testing.assert_array_equal(stats[k], v, err_msg=k)
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1, k


def test_bf16_exchange_is_exact(world):
    ranks = world[2]
    for r in ranks:
        for i, part in enumerate(r["bf16_gather"]):
            want = (torch.arange(-7, 9) * (1 + i) / 3).to(torch.bfloat16)
            np.testing.assert_array_equal(part, want.float().numpy())


def _one_process_loss(name, arrays, dtype):
    from jspsr_torch.losses import get_loss

    pred, gt = _tensors(arrays, dtype)
    pred.requires_grad_(True)
    loss = get_loss(name)(pred, gt)
    loss.backward()
    return float(loss.detach()), pred.grad.numpy()


@pytest.mark.parametrize("name", LOSSES)
def test_loss_shares_sum_to_one_process_in_float64(world, name):
    data, _, ranks, _ = world
    want, want_grad = _one_process_loss(name, data["losses"][name],
                                        torch.float64)
    for r in ranks:
        got = r["losses"][name][str(torch.float64)]
        assert abs(got["loss"] - want) <= LOSS_REL * abs(want), \
            (got["loss"], want)
        err = np.abs(got["grad"] - want_grad).max()
        assert err <= LOSS_REL * np.abs(want_grad).max(), err


@pytest.mark.parametrize("name", LOSSES)
def test_sharded_loss_matches_jax(world, name):
    _, ref, ranks, _ = world
    got = ranks[0]["losses"][name][str(torch.float32)]["loss"]
    np.testing.assert_allclose(got, ref[f"loss_{name}"], rtol=1e-5)


# ------------------------------------------------------------ the refusals

def _sharding() -> SpatialSharding:
    """A sharding of rank 0 of a 2 x 2 mesh with no process group: enough
    for the checks that raise before any collective."""
    return SpatialSharding(Mesh2D(N_DATA, N_SPACE, 0, None, None, None))


@pytest.mark.parametrize("case, h, mult", [("fuse_stems", 24, 8),
                                           ("lrru", 48, 16),
                                           ("edsr", 33, 1),
                                           ("completionformer", 96, 32)])
def test_row_multiple_is_each_models_own(case, h, mult):
    """H must divide by the model's row multiple x the space axis; the
    refusal names the model (CompletionFormer's before its layers are
    built: the check needs none)."""
    from jspsr_torch.models.completionformer import CompletionFormer
    from jspsr_torch.parallel.spatial import sharded_forward

    model = (object.__new__(CompletionFormer) if case == "completionformer"
             else _model(case))
    name = type(model).__name__
    assert model.ROW_MULTIPLE == mult
    inputs = [torch.zeros(2, 1, h, 8)]
    with pytest.raises(ValueError, match=rf"{name}: H = {h} does not "
                                         rf"divide by {mult} x 2"):
        sharded_forward(model, inputs, _sharding())


def test_completionformer_is_refused_before_its_rows_are_checked():
    """CompletionFormer runs under a sharding where H divides by its row
    multiple (32: five halvings, and stage 1's spatial-reduction conv of 8
    at H / 4) x the space axis; any other H, one that divides by every
    other model's multiple (16 x 2) or by 32 alone, is refused naming it,
    before any collective."""
    from jspsr_torch.models.completionformer import CompletionFormer
    from jspsr_torch.parallel.spatial import sharded_forward

    model = object.__new__(CompletionFormer)
    assert CompletionFormer.ROW_MULTIPLE == 32
    for h in (20, 32, 96):
        inputs = [torch.zeros(2, 1, h, 8), torch.zeros(2, 3, h, 8)]
        with pytest.raises(ValueError,
                           match=rf"CompletionFormer: H = {h} does not "
                                 rf"divide by 32 x 2"):
            sharded_forward(model, inputs, _sharding())


def test_ssim_refuses_a_slab_shorter_than_its_window():
    from jspsr_torch.losses import get_loss

    pred = torch.rand(2, 1, 8, 16)
    with _sharding().active(), pytest.raises(
            ValueError, match="SSIM's 11 x 11 window reaches 10 rows"):
        get_loss("ssim")(pred, pred)
