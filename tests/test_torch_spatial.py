"""The port's 2-D (data x space) spatially sharded forward and gradients
(``parallel.mesh.make_2d_mesh``, ``spatial_sharding``,
``parallel/spatial.py``) against the JAX package's ``spatial_sharding``,
on the CPU.

Every multi-rank check runs in one world of four gloo ranks
(``parallel.spawn.run_ranks``, ``world``, module-scoped, with its own
deadline) laid out as a 2 x 2 mesh: each rank holds 2 rows of the batch
and half of each image's rows, and then computes one of the port's
one-process references (``REFERENCES``). The JAX references run here, in
the test process, exactly as ``tests/test_train.py:132-142,296-309,
420-449`` run them: ``make_2d_mesh(2, 2, jax.devices()[:4])`` on the
conftest's forced CPU devices, the tiny JSPSR (``{"lr_dem": 1, "image": 3}``,
``num_feature=8``, ``layers=(1,1,1,1)``, 4 x 32^2) from ``model.init``,
its weights carried into the port by ``utils/weights.py``:

- the eval forward, gathered, against JAX's spatially sharded and its
  replicated forward at rtol 1e-4 / atol 1e-5 (``test_train.py:308``);
- the train-mode L1 + L2 parameter gradients against JAX's sharded ones
  at JAX's own bound (at least 99 % of entries within rtol 1e-3 / atol
  1e-5 and none further than 1e-3: ``test_train.py:446-447``, the deform
  floor-flip tolerance) and against the port's one process on the whole
  batch at the same bound; then the same in float64 against the port's
  one process in float64, every tensor within 1e-9 of its largest
  magnitude (``F64_REL``: only the order of the sums differs).
  ``tests/test_train.py::test_spatial_sharded_gradients_with_conv_vjp``
  forces a TPU lowering lever (the stride-1 conv's custom VJP) that the
  port leaves out by design; the gradient case here is its counterpart;
- the flagship loss (L1 + L2 + 0.1 Grad, the three-branch flagship with
  the 15-class mask) against the port's one process: the losses at rtol
  1e-5, the gradients in float64 at ``F64_REL`` and in fp32 each tensor
  within 5e-2 relative L2 (``test_torch_ddp.py``'s fp32 bound for this
  model at these sizes). fp32 cannot be held tighter: a pre-activation
  within rounding of a ReLU's kink (on this batch, one of the SPN
  generator's last ReLU) may land on the other side under the sharded
  forward's summation order, which moves every gradient upstream of that
  pixel; float64 leaves no such pre-activation within its rounding;
- a halo round trip of every conv kind of the flagship (5x5 and 3x3
  stride 1, 3x3 stride 2, 1x1 stride 2, the k3 s2 p1 op1 transposed conv)
  in float64: the output, the input gradient and the summed weight
  gradient against the unsharded conv at rtol 1e-12.

- the tiny flagship's sharded eval forward with each of its five
  options (``fuse_stems``, ``eval_grouped``, ``remat_stages``,
  ``compute_dtype`` and ``spn_sample_dtype`` bf16), and EDSR's and LRRU's,
  against one process (fp32 at rtol 1e-4 / atol 1e-5; bf16 within
  ``FACTOR`` x the one-process bf16 model's distance from its fp32 one,
  ``tests/test_torch_bf16.py``'s rule). ``tests/test_torch_spatial_models.py``
  holds these cases and every loss against the JAX package; the
  CompletionFormer (``{"lr_dem": 1, "image": 3}``, 2 x 64^2: its H divides
  by its row multiple of 32 x 2) is held against one process the same
  way, and against JAX in ``tests/test_torch_spatial_completionformer.py``.

In one process: K1's and K2's plain versions on a row slab (``y0``) are
bit-equal to the same rows of the whole image's, and their d_weight and
d_bias summed over the slabs match the whole image's at 1e-6 relative;
the ops pass ``torch.library.opcheck`` with a row origin; the kernels'
launch names on a slab in either mode, K3's among them, whose op takes a
slab where ``x`` needs its gradient.
"""

import numpy as np
import pytest
import torch

from jspsr_torch.models.jspsr import JSPSR
from jspsr_torch.ops.deform_conv import (
    deform_conv2d,
    deform_conv2d_backward_plain,
    deform_conv2d_op,
    deform_conv2d_plain,
)
from jspsr_torch.parallel.mesh import Mesh2D, SpatialSharding
from jspsr_torch.parallel.spawn import run_ranks
from jspsr_torch.utils.weights import state_dict_from_jax_tree

SMALL = {"lr_dem": 1, "image": 3}
FLAGSHIP = {"lr_dem": 1, "image": 3, "mask": 15}
FLAGSHIP_LOSS = {"L1": 1, "L2": 1, "Grad": 0.1}
N_DATA, N_SPACE = 2, 2
WORLD = N_DATA * N_SPACE
# float64 gradients, sharded against one process: every tensor within this
# share of its largest magnitude
F64_REL = 1e-9
# tests/test_torch_bf16.py's rule for a bf16 result
FACTOR = 2.0
# the flagship's options (with the ROADMAP.md queue 1 item that ported each
# to a row slab), and the other families, on the tiny SMALL batch
OPTIONS = [({"fuse_stems": True}, 8), ({"eval_grouped": True}, 8),
           ({"remat_stages": True}, 8), ({"compute_dtype": "bfloat16"}, 7),
           ({"spn_sample_dtype": "bfloat16"}, 7)]
FAMILIES = {"edsr.EDSR": {"in_channels": 4, "out_channels": 1,
                          "n_resblocks": 2, "n_features": 8},
            "lrru.LRRU": {"in_channels": dict(SMALL), "bc": 4},
            "completionformer.CompletionFormer": {
                "in_channels": dict(SMALL)}}
# the families whose inputs are ``data["cf_fwd"]``'s 2 x 64^2: H divides by
# CompletionFormer's row multiple (32) x the space axis
CF_INPUTS = ("completionformer.CompletionFormer",)


def _nchw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def _jax_tiny(seed):
    """``tests/test_train.py::_tiny_model_and_data``: the JAX model, its
    params and BatchNorm state, NHWC inputs and target."""
    import jax

    from jspsr_tpu.models.jspsr import JSPSR as JaxJSPSR

    model = JaxJSPSR(dict(SMALL), num_feature=8, layers=(1, 1, 1, 1))
    params, bn = model.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    dem = rng.uniform(0.3, 0.6, (4, 32, 32, 1)).astype(np.float32)
    img = rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    gt = np.clip(dem + 0.05 * rng.normal(size=dem.shape).astype(np.float32),
                 0, 1)
    return model, params, bn, [dem, img], gt


def _port_state(params, bn) -> dict:
    port = JSPSR(dict(SMALL), num_feature=8, layers=(1, 1, 1, 1))
    sd = state_dict_from_jax_tree(params, port)
    sd.update(state_dict_from_jax_tree(bn, port, "bn"))
    port.load_state_dict(sd)
    return {k: v.numpy().copy() for k, v in port.state_dict().items()}


def _port(channels, state) -> JSPSR:
    model = JSPSR(dict(channels), num_feature=8, layers=(1, 1, 1, 1))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def _option_model(state, kwargs) -> JSPSR:
    """The tiny flagship of ``state`` with ``kwargs``'s option, in eval."""
    model = JSPSR(dict(SMALL), num_feature=8, layers=(1, 1, 1, 1),
                  **kwargs)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model.eval()


def _family(family) -> torch.nn.Module:
    """``family``'s model at FAMILIES' tiny widths, seeded."""
    import importlib

    module, name = family.split(".")
    cls = getattr(importlib.import_module(f"jspsr_torch.models.{module}"),
                  name)
    return cls(**FAMILIES[family], generator=torch.Generator().manual_seed(4))


def _family_inputs(data, family) -> list:
    return data["cf_fwd" if family in CF_INPUTS else "fwd"]["inputs"]


def _tensors(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _one_process_grads(channels, state, loss, inputs, gt,
                       dtype=torch.float32):
    """The port's train-mode gradients on the whole batch in this
    process, in ``dtype``."""
    from jspsr_torch.losses import build_criterion

    model = _port(channels, state).to(dtype).train()
    build_criterion(dict(loss))(model(_tensors(inputs, dtype)),
                                torch.from_numpy(gt).to(dtype))[
        "Total"].backward()
    return {k: q.grad.numpy().copy() for k, q in model.named_parameters()
            if q.grad is not None}


CONV_KINDS = {
    "5x5_s1": dict(kernel_size=5, stride=1, padding=2),
    "3x3_s1": dict(kernel_size=3, stride=1, padding=1),
    "3x3_s2": dict(kernel_size=3, stride=2, padding=1),
    "1x1_s2": dict(kernel_size=1, stride=2, padding=0),
    "trans_k3_s2": dict(kernel_size=3, stride=2, padding=1,
                        output_padding=1, transposed=True),
}


def _conv_round_trip(sharding, rank):
    """Each conv kind in float64 on this rank's block against the
    unsharded conv on the whole batch: the largest relative error of the
    output, the input gradient and the weight gradient summed over the
    mesh."""
    import torch.distributed as dist

    from jspsr_torch import nn as jnn

    errs = {}
    for name, kw in CONV_KINDS.items():
        kw = dict(kw)
        cls = jnn.ConvTranspose2d if kw.pop("transposed", False) \
            else jnn.Conv2d
        gen = torch.Generator().manual_seed(len(name))
        conv = cls(3, 4, **kw).double()
        with torch.no_grad():
            for q in conv.parameters():
                q.copy_(torch.randn(q.shape, generator=gen,
                                    dtype=torch.float64))
        x = torch.randn(4, 3, 32, 8, generator=gen, dtype=torch.float64)
        want = conv(x.requires_grad_(True))
        g = torch.randn(want.shape, generator=gen, dtype=torch.float64)
        (want * g).sum().backward()
        want_dx, want_dw = x.grad.clone(), conv.weight.grad.clone()
        conv.zero_grad()
        xs = sharding.shard(x.detach()).requires_grad_(True)
        with sharding.active():
            y = conv(xs)
            (y * sharding.shard(g)).sum().backward()
        dw = conv.weight.grad.clone()
        dist.all_reduce(dw, group=sharding.mesh.group)

        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max())

        errs[name] = max(rel(sharding.gather(y), want.detach()),
                         rel(sharding.gather(xs.grad), want_dx),
                         rel(dw, want_dw))
    return errs


# the one-process references, one per rank, computed after the rank's
# share of the checks: (case, its channels, dtype)
REFERENCES = (("grads", SMALL, torch.float32), ("grads", SMALL, torch.float64),
              ("flagship", FLAGSHIP, torch.float32),
              ("flagship", FLAGSHIP, torch.float64))


def _rank_checks(rank, world, data):
    """Every in-world check of this file on one rank of the 2 x 2 mesh,
    then one of the one-process references (``REFERENCES[rank]``)."""
    from jspsr_torch.losses import build_criterion
    from jspsr_torch.parallel.mesh import make_2d_mesh, spatial_sharding
    from jspsr_torch.parallel.spatial import sharded_forward, sharded_grads

    sharding = spatial_sharding(make_2d_mesh(N_DATA, N_SPACE))
    out = {}
    model = _port(SMALL, data["fwd"]["state"]).eval()
    with torch.no_grad():
        out["forward"] = sharded_forward(
            model, _tensors(data["fwd"]["inputs"]), sharding).numpy()
    for case, channels in (("grads", SMALL), ("flagship", FLAGSHIP)):
        d = data[case]
        out[case] = {}
        for dtype in (torch.float32, torch.float64):
            losses, grads = sharded_grads(
                _port(channels, d["state"]).to(dtype).train(),
                build_criterion(dict(d["loss"])),
                _tensors(d["inputs"], dtype),
                torch.from_numpy(d["gt"]).to(dtype), sharding)
            out[case][str(dtype)] = {
                "losses": losses,
                "grads": {k: v.numpy().copy() for k, v in grads.items()}}
    out["convs"] = _conv_round_trip(sharding, rank)
    with torch.no_grad():
        out["options"] = [sharded_forward(
            _option_model(data["fwd"]["state"], kw),
            _tensors(data["fwd"]["inputs"]), sharding).numpy()
            for kw, _ in OPTIONS]
        out["families"] = {family: sharded_forward(
            _family(family).eval(), _tensors(_family_inputs(data, family)),
            sharding).numpy() for family in FAMILIES}
    case, channels, dtype = REFERENCES[rank]
    d = data[case]
    out["one_process"] = _one_process_grads(channels, d["state"], d["loss"],
                                            d["inputs"], d["gt"], dtype)
    return out


@pytest.fixture(scope="module")
def world():
    """The JAX references, the inputs of every in-world check, and the four
    ranks' results."""
    import jax

    from jspsr_tpu.losses import build_criterion as jax_criterion
    from jspsr_tpu.parallel.mesh import make_2d_mesh, spatial_sharding
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_2d_mesh(2, 2, jax.devices()[:4])
    sh, rep = spatial_sharding(mesh), NamedSharding(mesh, P())
    data, ref = {}, {}

    # the forward, as test_train.py::test_spatial_sharding_matches_replicated
    model, params, bn, inputs, _ = _jax_tiny(5)
    fn = jax.jit(lambda d, i: model(params, bn, [d, i], train=False)[0])
    ref["forward_sharded"] = np.asarray(fn(*(jax.device_put(a, sh)
                                             for a in inputs)))
    ref["forward_replicated"] = np.asarray(fn(*(jax.device_put(a, rep)
                                                for a in inputs)))
    data["fwd"] = {"state": _port_state(params, bn),
                   "inputs": [_nchw(a) for a in inputs]}

    # the gradients, as test_train.py::test_spatial_sharded_gradients_match
    model, params, bn, inputs, gt = _jax_tiny(8)
    criterion = jax_criterion({"L1": 1, "L2": 1})

    @jax.jit
    def grads(prm, d, i, g):
        def loss(q):
            pred, _ = model(q, bn, [d, i], train=True)
            return criterion(pred, g)["Total"]
        return jax.grad(loss)(prm)

    g_sh = grads(params, *(jax.device_put(a, sh) for a in (*inputs, gt)))
    state = _port_state(params, bn)
    ref["grads_sharded"] = {
        k: v.numpy() for k, v in state_dict_from_jax_tree(
            g_sh, _port(SMALL, state)).items()}
    data["grads"] = {"state": state, "loss": {"L1": 1, "L2": 1},
                     "inputs": [_nchw(a) for a in inputs], "gt": _nchw(gt)}

    # the flagship's three branches and loss, from the port's seeded init
    flagship = JSPSR(dict(FLAGSHIP), num_feature=8, layers=(1, 1, 1, 1),
                     generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(11)
    data["flagship"] = {
        "state": {k: v.numpy().copy()
                  for k, v in flagship.state_dict().items()},
        "loss": FLAGSHIP_LOSS,
        "inputs": [rng.uniform(0.05, 0.95, (4, c, 32, 32)).astype(np.float32)
                   for c in FLAGSHIP.values()],
        "gt": rng.uniform(0.05, 0.95, (4, 1, 32, 32)).astype(np.float32)}
    data["cf_fwd"] = {"inputs": [
        rng.uniform(0.05, 0.95, (2, c, 64, 64)).astype(np.float32)
        for c in SMALL.values()]}
    ranks = run_ranks(_rank_checks, WORLD, data, device="cpu",
                      timeout_s=240)
    return data, ref, ranks


def _jax_bound(got: dict, want: dict):
    """``tests/test_train.py:446-447``'s bound on two gradient sets."""
    a = np.concatenate([got[k].ravel() for k in sorted(want)])
    b = np.concatenate([want[k].ravel() for k in sorted(want)])
    close = np.isclose(a, b, rtol=1e-3, atol=1e-5)
    assert close.mean() > 0.99, f"only {close.mean():.2%} of grads close"
    assert np.abs(a - b).max() < 1e-3


def _float64_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        err = np.abs(got[k] - want[k]).max()
        assert err <= F64_REL * np.abs(want[k]).max(), (k, err)


def _rel_l2(got, ref) -> float:
    return float(np.linalg.norm(got.astype(np.float64) - ref)
                 / max(np.linalg.norm(ref), 1e-12))


FP32, FP64 = str(torch.float32), str(torch.float64)


def test_sharded_forward_matches_jax_sharded_and_replicated(world):
    _, ref, ranks = world
    for r in ranks:  # every rank gathers the whole output
        np.testing.assert_array_equal(r["forward"], ranks[0]["forward"])
    got = ranks[0]["forward"]
    for key in ("forward_sharded", "forward_replicated"):
        np.testing.assert_allclose(got, _nchw(ref[key]), rtol=1e-4,
                                   atol=1e-5, err_msg=key)


def test_sharded_gradients_match_jax_and_one_process(world):
    data, ref, ranks = world
    got = ranks[0]["grads"][FP32]["grads"]
    for r in ranks[1:]:  # the summed gradient is the same on every rank
        for k, v in r["grads"][FP32]["grads"].items():
            np.testing.assert_array_equal(v, got[k], err_msg=k)
    _jax_bound(got, ref["grads_sharded"])
    _jax_bound(got, ranks[0]["one_process"])
    _float64_close(ranks[0]["grads"][FP64]["grads"],
                   ranks[1]["one_process"])


def test_flagship_loss_and_gradients_match_one_process(world):
    from jspsr_torch.losses import build_criterion

    data, _, ranks = world
    d, got = data["flagship"], ranks[0]["flagship"][FP32]
    model = _port(FLAGSHIP, d["state"]).train()
    want = build_criterion(dict(FLAGSHIP_LOSS))(model(_tensors(d["inputs"])),
                                                torch.from_numpy(d["gt"]))
    for k, v in want.items():  # the ranks' shares sum to the whole loss
        np.testing.assert_allclose(got["losses"][k], float(v.detach()),
                                   rtol=1e-5, err_msg=k)
    one = ranks[2]["one_process"]
    assert sorted(got["grads"]) == sorted(one)
    for k, v in one.items():
        assert _rel_l2(got["grads"][k], v) < 5e-2, k
    _float64_close(ranks[0]["flagship"][FP64]["grads"],
                   ranks[3]["one_process"])


@pytest.mark.parametrize("kind", sorted(CONV_KINDS))
def test_halo_round_trip_of_each_conv_kind_is_exact(world, kind):
    for r in world[2]:
        assert r["convs"][kind] < 1e-12, (kind, r["convs"][kind])


# ----------------------------------------------------------------- the ops

def _deform_case(b, h, w, scale, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(b, 1, h, w, generator=gen)
    offset = torch.randn(b, 18, h, w, generator=gen) * scale
    aff = torch.rand(b, 9, h, w, generator=gen)
    return (x, offset, torch.randn(1, 1, 3, 3, generator=gen),
            torch.randn(1, generator=gen), aff - aff.mean(1, keepdim=True),
            torch.randn(b, 1, h, w, generator=gen))


@pytest.mark.parametrize("scale", [0.0, 1.5, 20.0])
def test_plain_row_slabs_are_the_whole_images_rows(scale):
    """K1's and K2's plain versions on the slabs of a partition of the
    image's rows (slabs that neither start nor end on K1's 4-row tile):
    output, d_offset and d_mask bit-equal to those rows of the whole
    image's; d_weight and d_bias summed over the slabs within 1e-6 of the
    whole image's, relative."""
    x, offset, weight, bias, mask, g = _deform_case(2, 24, 20, scale, 3)
    whole = deform_conv2d_plain(x, offset, weight, bias, mask)
    whole_b = deform_conv2d_backward_plain(x, offset, weight, mask, g)
    sums = [torch.zeros_like(whole_b[2]), torch.zeros_like(whole_b[3])]
    for y0, y1 in ((0, 5), (5, 16), (16, 24)):
        rows = slice(y0, y1)

        def cut(t):
            return t[:, :, rows].contiguous()

        out = deform_conv2d_plain(x, cut(offset), weight, bias, cut(mask),
                                  y0=y0)
        assert torch.equal(out, whole[:, :, rows])
        d_off, d_mask, d_w, d_b = deform_conv2d_backward_plain(
            x, cut(offset), weight, cut(mask), cut(g), y0=y0)
        assert torch.equal(d_off, whole_b[0][:, :, rows])
        assert torch.equal(d_mask, whole_b[1][:, :, rows])
        sums[0] += d_w
        sums[1] += d_b
    for got, want in zip(sums, whole_b[2:]):
        torch.testing.assert_close(got, want, rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()))


def test_op_autograd_on_a_row_slab_is_the_whole_images_rows():
    """The op ``jspsr::deform_conv2d`` with a row origin: its output and
    the gradients of the slab's offsets and mask are those rows of the
    whole image's."""
    x, offset, weight, bias, mask, g = _deform_case(2, 16, 12, 1.5, 5)
    leaves = [t.clone().requires_grad_(True) for t in (offset, mask)]
    deform_conv2d(x, leaves[0], weight, bias, leaves[1]).backward(g)
    rows = slice(8, 16)
    cut = [t.detach()[:, :, rows].clone().requires_grad_(True)
           for t in (offset, mask)]
    y = deform_conv2d(x, cut[0], weight, bias, cut[1], y0=8)
    y.backward(g[:, :, rows])
    assert torch.equal(y, deform_conv2d_plain(x, offset, weight, bias,
                                              mask)[:, :, rows])
    for s, full in zip(cut, leaves):
        assert torch.equal(s.grad, full.grad[:, :, rows])


def test_op_with_a_row_origin_passes_opcheck():
    x, offset, weight, bias, mask, _ = _deform_case(2, 8, 7, 1.5, 11)
    leaves = [t[:, :, 3:7].clone().requires_grad_(True)
              for t in (offset, mask)]
    torch.library.opcheck(deform_conv2d_op, (
        x, leaves[0], weight.requires_grad_(True),
        bias.requires_grad_(True), leaves[1], 1, None, 3))


# ------------------------------------------------------------ the refusals

def _sharding() -> SpatialSharding:
    """A sharding of rank 0 of a 2 x 2 mesh with no process group: enough
    for the checks that raise before any collective."""
    return SpatialSharding(Mesh2D(N_DATA, N_SPACE, 0, None, None, None))


@pytest.mark.parametrize("shape, message", [
    ((4, 1, 25, 32), "H = 25 does not divide over the space axis's 2"),
    ((3, 1, 32, 32), "batch 3 does not divide over the data axis's 2"),
])
def test_shard_refuses_what_does_not_divide(shape, message):
    with pytest.raises(ValueError, match=message):
        _sharding().shard(torch.zeros(shape))


@pytest.mark.parametrize("kwargs, item", OPTIONS)
def test_jspsr_refuses_what_is_out_of_this_slice(world, kwargs, item):
    """Each option the tiny flagship refused under a sharding before
    (ROADMAP.md queue 1 ``item`` ported it): its sharded eval forward,
    gathered, against the same model in one process: fp32 at rtol 1e-4 /
    atol 1e-5, bf16 within FACTOR x the one-process bf16 model's distance
    from its fp32 one (largest and mean)."""
    data, _, ranks = world
    got = ranks[0]["options"][OPTIONS.index((kwargs, item))]
    state, inputs = data["fwd"]["state"], _tensors(data["fwd"]["inputs"])
    with torch.no_grad():
        want = _option_model(state, kwargs)(inputs).numpy()
        fp32 = _option_model(state, {})(inputs).numpy()
    if not any(v == "bfloat16" for v in kwargs.values()):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=f"item {item}")
        return
    dist, own = np.abs(got - want), np.abs(want - fp32)
    assert dist.max() <= FACTOR * own.max(), (item, dist.max(), own.max())
    assert dist.mean() <= FACTOR * own.mean(), (item, dist.mean(),
                                                 own.mean())


@pytest.mark.parametrize("family, item", [
    ("edsr.EDSR", 9), ("lrru.LRRU", 10),
    ("completionformer.CompletionFormer", 11)])
def test_other_families_are_refused_under_a_sharding(world, family, item):
    """The other families (ROADMAP.md queue 1 items 9, 10 and 11 ported
    them to a sharding) run there: the sharded eval forward of each,
    gathered, equals one process's at rtol 1e-4 / atol 1e-5 (the
    CompletionFormer at its fixed widths on 2 x 64^2)."""
    data, _, ranks = world
    with torch.no_grad():
        want = _family(family).eval()(_tensors(_family_inputs(data,
                                                              family)))
    for r in ranks:
        np.testing.assert_array_equal(r["families"][family],
                                      ranks[0]["families"][family])
    np.testing.assert_allclose(ranks[0]["families"][family], want.numpy(),
                               rtol=1e-4, atol=1e-5, err_msg=f"item {item}")


def test_unported_losses_and_the_input_gradient_are_refused():
    """Nothing is refused on a slab any longer: the deform op's input
    gradient (K3) runs there (its d_x the whole image's gradient from the
    slab's rows), and K1, K2 and K3 take a slab in either mode under launch
    names of their own; every loss is ported (the BCE here, with no
    collective, is this block's share of the whole batch's mean;
    ``tests/test_torch_spatial_models.py`` holds each loss)."""
    from jspsr_torch.losses import get_loss
    from jspsr_torch.ops import deform_cuda

    pred = torch.rand(2, 1, 16, 16)
    with _sharding().active():
        share = get_loss("bce")(pred, pred)
    torch.testing.assert_close(share * WORLD, get_loss("bce")(pred, pred))
    x, offset, weight, bias, mask, _ = _deform_case(1, 8, 8, 1.5, 2)
    d_x = torch.zeros_like(x)
    for y0 in (0, 4):
        leaf = x.clone().requires_grad_(True)
        deform_conv2d(leaf, offset[:, :, y0:y0 + 4], weight, bias,
                      mask[:, :, y0:y0 + 4], y0=y0).sum().backward()
        d_x += leaf.grad
    leaf = x.clone().requires_grad_(True)
    deform_conv2d(leaf, offset, weight, bias, mask).sum().backward()
    torch.testing.assert_close(d_x, leaf.grad, rtol=1e-6, atol=1e-6)
    for kernel in ("deform_fwd", "deform_bwd", "deform_bwd_dx"):
        assert deform_cuda._name(kernel, "bfloat16", x, offset[:, :, 4:],
                                 4) == f"{kernel}_bf16_slab"
        assert deform_cuda._name(kernel, None, x, offset[:, :, 4:],
                                 4) == f"{kernel}_slab"
        assert deform_cuda._name(kernel, "bfloat16", x, offset, 0) == \
            f"{kernel}_bf16"
        assert {f"{kernel}_slab", f"{kernel}_bf16_slab"} <= set(
            deform_cuda.KERNELS)
