"""The port's spatially sharded CompletionFormer
(``parallel.spatial.sharded_forward``, ``sharded_grads``) and the deform
op's input gradient (K3's work) on a row slab, against the JAX package's
``spatial_sharding`` and against the port's one process, on the CPU.

In one process, the plain version of K3 (``deform_conv2d_backward_plain``
with ``need_dx``) on the slabs of a partition of the image's rows (slabs
whose heights are not multiples of K3's 8-row tile included), at 1.5 and
20 px offsets, in both sampling modes: d_offset and d_mask are those rows
of the whole image's, bit for bit; the slabs' d_x summed is the whole
image's within 1e-12 in float64; the op's autograd on the slabs (d_x,
d_weight and d_bias summed, d_offset and d_mask stacked) against
``jax.grad`` of JAX's Pallas op (interpret mode, ``x_grad=True``) under
``force_deform_impl("pallas")`` at the deform suite's 1e-4.

Every multi-rank check runs in one world of four gloo ranks
(``parallel.spawn.run_ranks(..., device="cpu")``, ``world``,
module-scoped) laid out as a 2 x 2 mesh, as
``tests/test_torch_spatial_models.py`` runs its own; the JAX references
run in a thread of the test process meanwhile, on the conftest's forced CPU
devices (``make_2d_mesh(2, 2, jax.devices()[:4])``, inputs put to
``spatial_sharding``, as ``tests/test_train.py:296-309`` runs them), the
weights carried into JAX by ``import_torch_state_dict``:

- units at narrow widths: ``Attention`` at ``sr_ratio`` 8 and 1 (keys and
  values gathered over the space group), a shallow ``PVT`` (one block per
  stage, narrow embeddings; stage 1's 112^2 position grid resized to the
  whole 16^2 grid, then cut to the slab), ``NLSPN`` with TGASS affinities
  with the confidence on and off (forward and the gradients of the
  feature, the guidance, the confidence and the parameters), and the SPN
  head with a DEM that needs its gradient (K3 on the slab through the
  head): each against JAX's sharded module at the JAX suite's rtol 1e-4 /
  atol 1e-5 (the shallow PVT at ``PVT_TOL``; the SPN head has no JAX
  counterpart alone; ``JAX_DATA_ONLY`` says why two units' JAX references
  put their input over the data axis only) and in float64 against the
  port's one process within ``F64_REL`` of each tensor's largest
  magnitude;
- the whole CompletionFormer at its fixed widths (83,689,176 parameters,
  ``{"lr_dem": 1, "image": 3, "mask": 15}``: 18 guidance channels) on 2 x
  64^2 (each rank 1 x 32 x 64, so the deepest levels' slabs are 1 and 2
  rows and the 7 x 7 spatial attention's halo reaches past the
  neighbouring slab): its eval forward against JAX's sharded forward at
  the JAX suite's CompletionFormer tolerance (rtol 1e-3 / atol 1e-4,
  ``tests/test_parity_completionformer.py``); the train-mode gradients of
  L1 + L2 against JAX's sharded ones by ``tests/test_train.py:447-449``'s
  rule, JAX's BatchNorm in its two-pass form; both in float64 against one
  process within ``F64_REL``; and with drop path on (the sharded gradients
  under ``sharded_grads(..., generator=)``) against one process with the
  same seeded generator, in float64. The weights are the port's seeded
  init, the BatchNorm statistics and NLSPN's offset/affinity conv
  perturbed (``utils.perturb``; at the conv's zero init the propagation is
  the identity) and every conv bias off zero.

On the CPU the deform op runs its plain versions: ``deform_cuda.LAUNCHES``
stays as it was.
"""

import contextlib

import numpy as np
import pytest
import torch

from jspsr_torch.models import pvt as P
from jspsr_torch.models.completionformer import CompletionFormer
from jspsr_torch.models.nlspn import NLSPN
from jspsr_torch.models.spn import PostProcessor
from jspsr_torch.ops import deform_cuda
from jspsr_torch.ops.deform_conv import (
    deform_conv2d,
    deform_conv2d_backward_plain,
)
from jspsr_torch.parallel.spawn import run_ranks
from jspsr_torch.utils.weights import state_dict_from_jax_tree

N_DATA, N_SPACE = 2, 2
WORLD = N_DATA * N_SPACE
# float64, sharded against one process: every tensor within this share of
# its largest magnitude (only the order of the sums differs)
F64_REL = 1e-9
FLAGSHIP = {"lr_dem": 1, "image": 3, "mask": 15}
LOSS = {"L1": 1, "L2": 1}
UNIT_TOL = {"rtol": 1e-4, "atol": 1e-5}  # tests/test_train.py:308
# the shallow PVT's tolerance, tests/test_torch_completionformer.py's for it
# unsharded: its outputs reach the hundreds at 64^2, and fp32 sums move its
# small outputs by more than 1e-5 in either package
# (``test_jax_reference_is_jax_unsharded`` prints the port's distance from
# JAX's unsharded module)
PVT_TOL = {"rtol": 1e-4, "atol": 1e-4}
# The units whose JAX reference puts its input over the mesh's data axis
# only: XLA's partitioner on this CPU build (jax 0.9.0) computes a conv
# whose kernel and stride are 8 (Attention's ``sr`` at ``sr_ratio`` 8)
# wrongly when its input is sharded along H with 32 or more channels, so
# JAX's spatially sharded Attention at ``sr_ratio`` 8 and shallow PVT are
# not JAX's own unsharded modules (``test_jax_reference_is_jax_unsharded``
# prints how far). With the input over the data axis JAX computes the
# function that its spatial sharding should; the port's sharded units are
# also held to its one process in float64.
JAX_DATA_ONLY = ("attn_sr8", "pvt")
CF_TOL = {"rtol": 1e-3, "atol": 1e-4}  # test_parity_completionformer.py
# the deform suite's tolerance (tests/test_pallas_deform.py)
DEFORM_TOL = 1e-4
# the seed of the drop-path generator, the same on every rank and in the
# one-process reference
DROP_SEED = 3

PVT_KW = {"embed_dims": (16, 32, 80, 128), "depths": (1, 1, 1, 1)}
ATTN_HW = (16, 24)
# unit -> whether its gradients are checked
UNITS = {"attn_sr8": False, "attn_sr1": False, "pvt": False,
         "nlspn_conf": True, "nlspn_noconf": True, "spn_head": True}
NLSPN_HW = (12, 16)


def _unit(name) -> torch.nn.Module:
    """Unit ``name`` at its narrow widths, torch's default or seeded init
    (its state is loaded over it)."""
    if name.startswith("attn"):
        return P.Attention(32, 2, True, 8 if name == "attn_sr8" else 1)
    if name == "pvt":
        return P.PVT(in_chans=128, patch_size=2, **PVT_KW)
    if name == "spn_head":
        return PostProcessor(3)
    return NLSPN(8, 1, 3, 3, 3, "TGASS", 0.5, name == "nlspn_conf", False)


def _loaded(module, state, dtype=torch.float32):
    module.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return module.to(dtype)


def _tensors(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _nhwc(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 2, 3, 1))


def _nchw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def _tokens(x):
    """(B, C, h, w) -> (B, h*w, C)."""
    return x.flatten(2).transpose(1, 2)


def _map(t, h, w):
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], h, w)


# --------------------------------------------------- one process and ranks

def _unit_run(name, d, dtype, sharding=None):
    """Unit ``name`` on the whole inputs of ``d`` (``sharding`` None) or on
    this rank's blocks of them under ``sharding``: its outputs (gathered
    whole) and, where checked, the gradients of the inputs (gathered
    whole) and of the parameters (summed over the mesh), numpy."""
    module = _loaded(_unit(name), d["state"], dtype)
    module.eval()
    inputs = _tensors(d["inputs"], dtype)
    cot = torch.from_numpy(d["cot"]).to(dtype) if "cot" in d else None
    if sharding is not None:
        inputs = [sharding.shard(x) for x in inputs]
        cot = None if cot is None else sharding.shard(cot)
    grads = UNITS[name]
    for x in inputs if grads else ():
        x.requires_grad_(True)
    ctx = (sharding.active() if sharding is not None
           else contextlib.nullcontext())
    with ctx, torch.set_grad_enabled(grads):
        if name.startswith("attn"):
            h = ATTN_HW[0] // (N_SPACE if sharding is not None else 1)
            outs = [_map(module(_tokens(inputs[0]), h, ATTN_HW[1]), h,
                         ATTN_HW[1])]
        elif name == "pvt":
            outs = module(inputs[0])
        elif name == "spn_head":
            outs = [module(*inputs)]
        else:
            outs = list(module(*inputs))
        if grads:
            (outs[0] * cot).sum().backward()
    out = {"outputs": [_whole(y.detach(), sharding) for y in outs]}
    if grads:
        # the confidence NLSPN does not read without conf_prop: 0
        out["input_grads"] = [_whole(
            torch.zeros_like(x) if x.grad is None else x.grad, sharding)
            for x in inputs]
        params = {k: q for k, q in module.named_parameters()
                  if q.grad is not None}
        if sharding is not None:
            from jspsr_torch.parallel.mesh import all_reduce_grads

            all_reduce_grads(list(params.values()), sharding.mesh.group,
                             average=False)
        out["param_grads"] = {k: q.grad.numpy().copy()
                              for k, q in params.items()}
    return out


def _whole(t, sharding):
    return (t if sharding is None else sharding.gather(t)).numpy().copy()


def _cf(state, dtype=torch.float32):
    model = CompletionFormer(dict(FLAGSHIP),
                             generator=torch.Generator().manual_seed(0))
    return _loaded(model, state, dtype)


def _recording_drop_path(model, keeps: list) -> None:
    """Make ``model``'s PVT append every keep mask it draws to ``keeps``."""
    former = model.backbone.former
    draw = former.drop_path_keep

    def record(*args):
        keep = draw(*args)
        if keep is not None:
            keeps.append(keep.flatten().tolist())
        return keep
    former.drop_path_keep = record


def _cf_one_process(model, d, what, dtype=torch.float64):
    """The whole CompletionFormer's eval forward (``what`` "forward"), its
    train-mode L1 + L2 gradients ("grads"), or those with drop path
    ("drop_path": the generator seeded with DROP_SEED, and the masks it
    drew) on the whole batch in this process."""
    from jspsr_torch.losses import build_criterion

    inputs = _tensors(d["inputs"], dtype)
    if what == "forward":
        with torch.no_grad():
            return model.eval()(inputs).numpy()
    model.train().zero_grad(set_to_none=True)
    kw, keeps = {}, []
    if what == "drop_path":
        kw["generator"] = torch.Generator().manual_seed(DROP_SEED)
        _recording_drop_path(model, keeps)
    build_criterion(dict(LOSS))(model(inputs, **kw), torch.from_numpy(
        d["gt"]).to(dtype))["Total"].backward()
    grads = {k: q.grad.numpy().copy() for k, q in model.named_parameters()
             if q.grad is not None}
    return (grads, keeps) if what == "drop_path" else grads


# the one-process float64 references of the whole model, one per rank
CF_REFERENCES = ("forward", "grads", "drop_path")


def _keep(out: dict, key: str, grads: dict, rank: int) -> None:
    """The whole model's summed gradients: rank 0's under ``key`` (numpy),
    every rank's digest of their bytes under ``key + "_sha256"`` (the
    other ranks' arrays would hold the parent's memory four times
    over)."""
    import hashlib

    digest = hashlib.sha256()
    for k in sorted(grads):
        digest.update(grads[k].numpy().tobytes())
    out[f"{key}_sha256"] = digest.hexdigest()
    out[key] = ({k: v.numpy().copy() for k, v in grads.items()}
                if rank == 0 else None)


def _rank_checks(rank, world, data):
    """Every in-world check of this file on one rank of the 2 x 2 mesh,
    then its share of the one-process float64 references."""
    from jspsr_torch.losses import build_criterion
    from jspsr_torch.parallel.mesh import make_2d_mesh, spatial_sharding
    from jspsr_torch.parallel.spatial import sharded_forward, sharded_grads

    sharding = spatial_sharding(make_2d_mesh(N_DATA, N_SPACE))
    launches = dict(deform_cuda.LAUNCHES)
    out = {"units": {}, "cf": {}}
    for name in UNITS:
        for dtype in (torch.float32, torch.float64):
            out["units"][name, str(dtype)] = _unit_run(
                name, data["units"][name], dtype, sharding)
    d = data["cf"]
    model = _cf(d["state"])
    inputs, gt = _tensors(d["inputs"]), torch.from_numpy(d["gt"])
    criterion = build_criterion(dict(LOSS))
    with torch.no_grad():
        out["cf"]["forward_fp32"] = sharded_forward(
            model.eval(), inputs, sharding).numpy()
    out["cf"]["losses_fp32"], grads = sharded_grads(
        model.train(), criterion, inputs, gt, sharding)
    _keep(out["cf"], "grads_fp32", grads, rank)
    del grads
    model.zero_grad(set_to_none=True)
    # the seeded state again: the train-mode run moved BatchNorm's
    # running statistics, which the eval forward reads
    model = _loaded(model, d["state"], torch.float64)
    inputs, gt = _tensors(d["inputs"], torch.float64), gt.double()
    with torch.no_grad():
        out["cf"]["forward_f64"] = sharded_forward(
            model.eval(), inputs, sharding).numpy()
    for key, kw in (("grads_f64", {}), ("drop_path_f64", {
            "generator": torch.Generator().manual_seed(DROP_SEED)})):
        _, grads = sharded_grads(model.train(), criterion, inputs, gt,
                                 sharding, **kw)
        _keep(out["cf"], key, grads, rank)
        del grads
        model.zero_grad(set_to_none=True)
    out["launches_moved"] = deform_cuda.LAUNCHES != launches
    if rank < len(CF_REFERENCES):
        out["one_process"] = _cf_one_process(
            _loaded(model, d["state"], torch.float64), d,
            CF_REFERENCES[rank])
    return out


# ---------------------------------------------------------------- the JAX

def _jax_unit(name):
    from jspsr_tpu.models import pvt as JP
    from jspsr_tpu.models.nlspn import NLSPN as JaxNLSPN

    if name.startswith("attn"):
        return JP.Attention(32, 2, True, 8 if name == "attn_sr8" else 1)
    if name == "pvt":
        return JP.PVT(in_chans=128, patch_size=2, **PVT_KW)
    return JaxNLSPN(8, 1, 3, 3, 3, "TGASS", 0.5, name == "nlspn_conf", False)


def _jax_unit_ref(name, d, sh, data_only: bool = True):
    """JAX's sharded unit on the whole inputs put to ``sh`` (with
    ``data_only``, ``JAX_DATA_ONLY``'s over the data axis of its mesh; on
    one device where ``sh`` is None): its outputs (NCHW) and, for NLSPN,
    the gradients of ``sum(feat * cot)`` (inputs NCHW, parameters as the
    port's state_dict)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from jspsr_tpu.utils.torch_import import import_torch_state_dict

    if sh is not None and data_only and name in JAX_DATA_ONLY:
        sh = NamedSharding(sh.mesh, PartitionSpec("data"))

    jmod = _jax_unit(name)
    params, state = import_torch_state_dict(jmod, d["state"])
    if name.startswith("attn"):
        h, w = ATTN_HW
        x = jax.device_put(np.ascontiguousarray(
            _tokens(torch.from_numpy(d["inputs"][0])).numpy()), sh)
        y = jax.jit(lambda p, x: jmod(p, {}, x, h, w)[0])(params, x)
        return {"outputs": [_map(torch.from_numpy(np.array(y)), h,
                                 w).numpy()]}
    if name == "pvt":
        x = jax.device_put(_nhwc(d["inputs"][0]), sh)
        ys = jax.jit(lambda p, s, x: jmod(p, s, x, train=False)[0])(
            params, state, x)
        return {"outputs": [_nchw(y) for y in ys]}
    feat, guide, conf = (jax.device_put(_nhwc(a), sh) for a in d["inputs"])
    cot = jnp.asarray(_nhwc(d["cot"]))

    def loss(q, feat, guide, conf):
        (y, off, aff), _ = jmod(q, {}, feat, guide, conf)
        return jnp.sum(y * cot), (y, off, aff)

    (_, outs), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(params, feat, guide, conf)
    port = _unit(name)
    return {"outputs": [_nchw(y) for y in outs],
            "input_grads": [_nchw(g) for g in grads[1:]],
            "param_grads": {k: v.numpy() for k, v in state_dict_from_jax_tree(
                grads[0], port).items()}}


def _jax_cf_refs(d, sh, port):
    """JAX's sharded CompletionFormer: the eval forward and the train-mode
    L1 + L2 gradients (as the state_dict of ``port``, the port's model),
    BatchNorm two-pass."""
    import jax

    from jspsr_tpu.losses import build_criterion as jax_criterion
    from jspsr_tpu.models.completionformer import CompletionFormer as JaxCF
    from jspsr_tpu.nn.layers import set_bn_single_pass
    from jspsr_tpu.utils.torch_import import import_torch_state_dict

    jmod = JaxCF(dict(FLAGSHIP))
    params, bn = import_torch_state_dict(jmod, d["state"])
    x = [jax.device_put(_nhwc(a), sh) for a in d["inputs"]]
    g = jax.device_put(_nhwc(d["gt"]), sh)
    ref = {"forward": _nchw(jax.jit(
        lambda q, s, i: jmod(q, s, i, train=False)[0])(params, bn, x))}
    crit = jax_criterion(dict(LOSS))
    set_bn_single_pass(False)
    try:
        grads = jax.jit(jax.grad(lambda q: crit(jmod(
            q, bn, x, train=True)[0], g)["Total"]))(params)
    finally:
        set_bn_single_pass(True)
    ref["grads"] = {k: v.numpy() for k, v in state_dict_from_jax_tree(
        grads, port).items()}
    return ref


# ---------------------------------------------------------------- the data

def _perturbed(model, seed):
    """``model`` with its BatchNorm statistics and NLSPN's offset/affinity
    conv away from their init (``utils.perturb``) and every conv bias away
    from zero (a zero bias over an all-zero window puts a ReLU at its kink,
    where torch's gradient is 0 and ``jnp.maximum``'s 0.5)."""
    from jspsr_torch.utils.perturb import perturb_weights

    perturb_weights(model, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.conv._ConvNd) and \
                    m.bias is not None and m.bias.abs().max() == 0:
                m.bias.normal_(0, 0.05, generator=gen)
    return model


def _state(module) -> dict:
    return {k: v.numpy().copy() for k, v in module.state_dict().items()}


def _unit_data(rng) -> dict:
    """Each unit's state (seeded, perturbed), NCHW inputs and, where its
    gradients are checked, the output's cotangent."""
    torch.manual_seed(3)  # torch's default init: non-zero biases
    out = {}
    for name in UNITS:
        module = _unit(name)
        if name == "pvt":
            from jspsr_torch.nn import init_weights

            init_weights(module, torch.Generator().manual_seed(6))
        out[name] = {"state": _state(_perturbed(module, 7))}
    h, w = ATTN_HW
    for name in ("attn_sr8", "attn_sr1"):
        out[name]["inputs"] = [rng.normal(size=(2, 32, h, w)).astype(
            np.float32)]
    out["pvt"]["inputs"] = [rng.normal(size=(2, 64, 64, 64)).astype(
        np.float32)]
    h, w = NLSPN_HW
    for name in ("nlspn_conf", "nlspn_noconf"):
        out[name]["inputs"] = [
            rng.uniform(0.1, 0.9, (2, 1, h, w)).astype(np.float32),
            rng.normal(size=(2, 8, h, w)).astype(np.float32),
            rng.uniform(0, 1, (2, 1, h, w)).astype(np.float32)]
        out[name]["cot"] = rng.normal(size=(2, 1, h, w)).astype(np.float32)
    aff = rng.uniform(0, 1, (2, 9, h, w))
    out["spn_head"]["inputs"] = [
        rng.uniform(0.1, 0.9, (2, 1, h, w)).astype(np.float32),
        aff.astype(np.float32),
        (rng.normal(size=(2, 18, h, w)) * 1.5).astype(np.float32)]
    out["spn_head"]["cot"] = rng.normal(size=(2, 1, h, w)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def world():
    """The inputs of every in-world check, the JAX references (computed
    here while the four ranks run) and the four ranks' results."""
    from concurrent.futures import ThreadPoolExecutor

    import jax

    from jspsr_tpu.parallel.mesh import make_2d_mesh, spatial_sharding

    rng = np.random.default_rng(15)
    dem = rng.uniform(0.2, 0.8, (2, 1, 64, 64)).astype(np.float32)
    cf = _perturbed(CompletionFormer(
        dict(FLAGSHIP), generator=torch.Generator().manual_seed(0)), 8)
    data = {"units": _unit_data(rng), "cf": {
        "state": _state(cf),
        "inputs": [dem, rng.uniform(0, 1, (2, 18, 64, 64)).astype(
            np.float32)],
        "gt": (dem + rng.normal(0, 0.02, dem.shape)).astype(np.float32)}}
    with ThreadPoolExecutor(1) as pool:
        running = pool.submit(run_ranks, _rank_checks, WORLD, data,
                              device="cpu", timeout_s=420)
        sh = spatial_sharding(make_2d_mesh(2, 2, jax.devices()[:4]))
        ref = {name: _jax_unit_ref(name, data["units"][name], sh)
               for name in UNITS if name != "spn_head"}
        for name in JAX_DATA_ONLY:
            for key, put, data_only in (("unsharded", None, True),
                                        ("space_sharded", sh, False)):
                ref[name, key] = _jax_unit_ref(
                    name, data["units"][name], put, data_only)["outputs"]
        ref["cf"] = _jax_cf_refs(data["cf"], sh, cf)
        ranks = running.result()
    one = {what: r["one_process"] for what, r in zip(CF_REFERENCES, ranks)}
    return data, ref, ranks, one


# -------------------------------------------------------------- the bounds

def _float64_close(got, want, what=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _float64_close(got[k], want[k], f"{what} {k}")
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _float64_close(g, w, f"{what} {i}")
        return
    err = np.abs(np.asarray(got) - want).max()
    assert err <= F64_REL * np.abs(want).max(), (what, err)


def _jax_bound(got: dict, want: dict):
    """``tests/test_train.py:447-449``'s bound on two gradient sets."""
    a = np.concatenate([got[k].ravel() for k in sorted(want)])
    b = np.concatenate([want[k].ravel() for k in sorted(want)])
    close = np.isclose(a, b, rtol=1e-3, atol=1e-5)
    assert close.mean() > 0.99, f"only {close.mean():.2%} of grads close"
    assert np.abs(a - b).max() < 1e-3


def _same_on_every_rank(ranks, get):
    first = get(ranks[0])
    for r in ranks[1:]:
        got = get(r)
        for k in (first if isinstance(first, dict) else range(len(first))):
            np.testing.assert_array_equal(got[k], first[k], err_msg=str(k))
    return first


def _same_digest(ranks, key):
    """Every rank's summed gradients ``key`` are rank 0's, bit for bit."""
    assert len({r["cf"][f"{key}_sha256"] for r in ranks}) == 1, key


FP32, FP64 = str(torch.float32), str(torch.float64)


# ------------------------------------------------------------- the units

@pytest.mark.parametrize("name", [n for n in UNITS if n != "spn_head"])
def test_unit_matches_jax_sharded(world, name):
    _, ref, ranks, _ = world
    got = _same_on_every_rank(
        ranks, lambda r: r["units"][name, FP32]["outputs"])
    want = ref[name]["outputs"]
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, **(PVT_TOL if name == "pvt"
                                            else UNIT_TOL),
                                   err_msg=f"output {i}")
    if not UNITS[name]:
        return
    for i, (a, b) in enumerate(zip(ranks[0]["units"][name, FP32][
            "input_grads"], ref[name]["input_grads"])):
        if i == 2 and name == "nlspn_noconf":  # the unused confidence
            assert not np.abs(b).max()
            continue
        # tests/test_torch_completionformer.py's bound on NLSPN's input
        # gradients
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4,
                                   err_msg=f"input gradient {i}")
    pg, want = ranks[0]["units"][name, FP32]["param_grads"], \
        ref[name]["param_grads"]
    for k, v in pg.items():
        err = np.linalg.norm(v - want[k]) / max(np.linalg.norm(want[k]),
                                                1e-12)
        assert err < 1e-3 or np.abs(v - want[k]).max() < 1e-6, (k, err)


@pytest.mark.parametrize("name", JAX_DATA_ONLY)
def test_jax_reference_is_jax_unsharded(world, name):
    """The reference of the units whose JAX input lies over the data axis
    only is JAX's unsharded module, within fp32 rounding (rtol = atol =
    1e-5: the batch split changes XLA's order of sums); printed beside
    it: JAX's spatially sharded module's distance from it (not held:
    ``JAX_DATA_ONLY``) and the port's one process's."""
    data, ref, _, _ = world
    port = _unit_run(name, data["units"][name], torch.float32)["outputs"]
    for i, (got, want, space, one) in enumerate(zip(
            ref[name]["outputs"], ref[name, "unsharded"],
            ref[name, "space_sharded"], port)):
        print(f"{name} output {i}: JAX spatially sharded "
              f"{np.abs(space - want).max():.3g}, over the data axis "
              f"{np.abs(got - want).max():.3g}, the port's one process "
              f"{np.abs(one - want).max():.3g} from JAX unsharded (outputs "
              f"up to {np.abs(want).max():.3g})")
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"output {i}")


@pytest.mark.parametrize("name", list(UNITS))
def test_unit_matches_one_process_in_float64(world, name):
    data, _, ranks, _ = world
    want = _unit_run(name, data["units"][name], torch.float64)
    for r in ranks:
        _float64_close(r["units"][name, FP64], want, name)
    if name in ("nlspn_conf", "spn_head"):
        # the feature's (the DEM's) gradient went through K3's slab form
        assert np.abs(want["input_grads"][0]).max() > 0


# ---------------------------------------------------------- the whole model

def test_completionformer_forward_matches_jax_sharded(world):
    _, ref, ranks, _ = world
    got = _same_on_every_rank(ranks, lambda r: [r["cf"]["forward_fp32"]])[0]
    assert got.shape == (2, 1, 64, 64) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref["cf"]["forward"], **CF_TOL)


def test_completionformer_gradients_match_jax_sharded(world):
    _, ref, ranks, _ = world
    _same_digest(ranks, "grads_fp32")
    got, want = ranks[0]["cf"]["grads_fp32"], ref["cf"]["grads"]
    # the frozen NLSPN kernels: no gradient in the port, 0 in JAX
    for k in set(want) - set(got):
        assert not np.any(want[k]), k
    _jax_bound(got, {k: want[k] for k in got})


def test_completionformer_forward_matches_one_process_in_float64(world):
    _, _, ranks, one = world
    for r in ranks:
        _float64_close(r["cf"]["forward_f64"], one["forward"], "forward")


def test_completionformer_gradients_match_one_process_in_float64(world):
    _, _, ranks, one = world
    assert len(one["grads"]) > 300
    _same_digest(ranks, "grads_f64")
    _float64_close(ranks[0]["cf"]["grads_f64"], one["grads"], "grads")


def test_completionformer_drop_path_gradients_match_one_process(world):
    """Drop path on: every rank draws the whole batch's masks from a
    generator seeded alike and keeps its data index's rows, so the slabs of
    one image share its mask; the summed gradients are one process's with
    the same seed, in float64, and differ from those without drop path
    (a mask dropped at least one sample)."""
    _, _, ranks, one = world
    grads, keeps = one["drop_path"]
    assert any(0.0 in k for k in keeps)
    _same_digest(ranks, "drop_path_f64")
    _float64_close(ranks[0]["cf"]["drop_path_f64"], grads, "drop path")
    k = "backbone.former.block4.2.mlp.fc2.weight"
    assert not np.allclose(grads[k], one["grads"][k])


def test_completionformer_ran_the_plain_deform_versions(world):
    assert not any(r["launches_moved"] for r in world[2])


# ------------------------------------------------------- K3 on a row slab

def _deform_case(b, h, w, scale, seed, dtype=torch.float64):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(b, 1, h, w, generator=gen, dtype=dtype)
    offset = torch.randn(b, 18, h, w, generator=gen, dtype=dtype) * scale
    aff = torch.rand(b, 9, h, w, generator=gen, dtype=dtype)
    return (x, offset, torch.randn(1, 1, 3, 3, generator=gen, dtype=dtype),
            torch.randn(1, generator=gen, dtype=dtype),
            aff - aff.mean(1, keepdim=True),
            torch.randn(b, 1, h, w, generator=gen, dtype=dtype))


# a partition of 30 rows into slabs that neither start nor end on K3's
# 8-row tile (5, 11 and 14 rows)
SLABS = ((0, 5), (5, 16), (16, 30))


@pytest.mark.parametrize("sample_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("scale", [1.5, 20.0])
def test_plain_k3_on_slabs_is_the_whole_images(scale, sample_dtype):
    """d_offset and d_mask on each slab bit-equal to those rows of the
    whole image's; the slabs' d_x summed within 1e-12 of the whole image's
    (float64: only the order of the sums differs); d_weight and d_bias
    summed too."""
    x, offset, weight, _, mask, g = _deform_case(2, 30, 20, scale, 4)
    kw = {"need_dx": True, "sample_dtype": sample_dtype}
    whole = deform_conv2d_backward_plain(x, offset, weight, mask, g, **kw)
    sums = [torch.zeros_like(whole[i]) for i in (2, 3, 4)]
    for y0, y1 in SLABS:
        rows = slice(y0, y1)

        def cut(t):
            return t[:, :, rows].contiguous()

        got = deform_conv2d_backward_plain(x, cut(offset), weight, cut(mask),
                                           cut(g), y0=y0, **kw)
        assert got[4].shape == x.shape
        assert torch.equal(got[0], whole[0][:, :, rows])
        assert torch.equal(got[1], whole[1][:, :, rows])
        sums = [s + t for s, t in zip(sums, got[2:])]
    for got, want in zip(sums, whole[2:]):
        assert (got - want).abs().max() <= 1e-12 * want.abs().max()
    assert whole[4].abs().max() > 0


@pytest.mark.parametrize("sample_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("scale", [1.5, 20.0])
def test_op_autograd_on_slabs_matches_jax_pallas(scale, sample_dtype):
    """The op's autograd on each slab (``y0``; x needs its gradient, so
    the backward is K3's work on the slab): d_x, d_weight and d_bias summed
    over the slabs, d_offset and d_mask stacked, against ``jax.grad`` of
    the JAX op on the whole image under ``force_deform_impl("pallas")``
    (the interpret-mode Pallas kernel, ``_bwd_kernel`` with need_dx) at
    1e-4."""
    import jax
    import jax.numpy as jnp

    from jspsr_tpu.ops.deform_conv import deform_conv2d as jax_deform
    from jspsr_tpu.ops.deform_conv import force_deform_impl

    x, offset, weight, bias, mask, g = (
        t.float() for t in _deform_case(2, 30, 20, scale, 9))

    def loss(x, off, wgt, bias, mask):
        y = jax_deform(x, off, wgt, bias, mask, padding=1,
                       sample_dtype=sample_dtype)
        return jnp.sum(y[..., 0] * jnp.asarray(g[:, 0].numpy()))

    with force_deform_impl("pallas"):
        want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
            *(jnp.asarray(a) for a in (
                _nhwc(x), _nhwc(offset),
                weight.numpy().transpose(2, 3, 1, 0), bias.numpy(),
                _nhwc(mask))))
    want = [_nchw(want[0]), _nchw(want[1]),
            np.asarray(want[2]).transpose(3, 2, 0, 1), np.asarray(want[3]),
            _nchw(want[4])]
    launches = dict(deform_cuda.LAUNCHES)
    d_x = torch.zeros_like(x)
    d_w, d_b = torch.zeros_like(weight), torch.zeros_like(bias)
    d_off, d_mask = [], []
    for y0, y1 in SLABS:
        leaves = [x.clone().requires_grad_(True),
                  offset[:, :, y0:y1].clone().requires_grad_(True),
                  weight.clone().requires_grad_(True),
                  bias.clone().requires_grad_(True),
                  mask[:, :, y0:y1].clone().requires_grad_(True)]
        deform_conv2d(*leaves, sample_dtype=sample_dtype, y0=y0).backward(
            g[:, :, y0:y1])
        d_x += leaves[0].grad
        d_w += leaves[2].grad
        d_b += leaves[3].grad
        d_off.append(leaves[1].grad)
        d_mask.append(leaves[4].grad)
    assert deform_cuda.LAUNCHES == launches  # CPU tensors: plain versions
    got = [d_x, torch.cat(d_off, 2), d_w, d_b, torch.cat(d_mask, 2)]
    for name, a, r in zip(("d_x", "d_offset", "d_weight", "d_bias",
                           "d_mask"), got, want):
        np.testing.assert_allclose(a.numpy(), r, rtol=DEFORM_TOL,
                                   atol=DEFORM_TOL, err_msg=name)
    assert np.abs(want[0]).max() > 0
