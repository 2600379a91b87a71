"""Training pieces of the PyTorch port vs the JAX package: losses,
optimizers, LR schedules, param groups, and whole JSPSR train steps.

The same numpy inputs and the same weights (the port's state_dict carried
into JAX by ``import_torch_state_dict``) go through both; JAX results come
back into the port's names and layouts through
``jspsr_torch.utils.weights.state_dict_from_jax_tree``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
import torch.nn.functional as F

from jspsr_tpu.config.loader import AttrDict as JaxAttrDict
from jspsr_tpu.losses import build_criterion as jax_build_criterion
from jspsr_tpu.losses.functions import _REGISTRY as JAX_LOSSES
from jspsr_tpu.models.jspsr import JSPSR as JaxJSPSR
from jspsr_tpu.train import optim as jax_optim
from jspsr_tpu.train.state import TrainState
from jspsr_tpu.train.step import make_train_step as jax_make_train_step
from jspsr_tpu.utils.torch_import import import_torch_state_dict
from jspsr_torch.config.loader import AttrDict
from jspsr_torch.losses import build_criterion, get_loss
from jspsr_torch.losses.functions import _REGISTRY
from jspsr_torch.models.jspsr import JSPSR
from jspsr_torch.ops import deform_cuda
from jspsr_torch.train import optim
from jspsr_torch.train.step import make_train_step
from jspsr_torch.utils.weights import state_dict_from_jax_tree

torch.set_num_threads(2)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _rel_err(got, ref):
    """Relative L2 error of one tensor (absolute where ``ref`` is 0)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-12))


# ---------------------------------------------------------------- losses

def _loss_inputs(name, rng):
    """NHWC (pred, gt) numpy pairs each loss is meant for."""
    shape = (2, 20, 24, 1)
    if name == "norm":
        shape = (2, 20, 24, 3)
    if name == "softmax":
        logits = rng.normal(size=(2, 20, 24, 5)).astype(np.float32)
        label = rng.integers(0, 5, size=(2, 20, 24, 1))
        label[0, :3] = 255  # ignored pixels
        return logits, label.astype(np.float32)
    if name in ("vanilla", "bce", "balanced_bce"):
        return (rng.normal(size=shape).astype(np.float32),
                rng.uniform(0, 1, size=shape).astype(np.float32))
    return (rng.uniform(-0.1, 1.1, size=shape).astype(np.float32),
            rng.uniform(0, 1, size=shape).astype(np.float32))


def test_loss_registry_names_match_jax():
    assert sorted(_REGISTRY) == sorted(JAX_LOSSES)


@pytest.mark.parametrize("name", sorted(JAX_LOSSES))
def test_loss_matches_jax(name):
    pred, gt = _loss_inputs(name, np.random.default_rng(len(name)))
    want = float(JAX_LOSSES[name](jnp.asarray(pred), jnp.asarray(gt)))
    got = float(get_loss(name)(_nchw(pred), _nchw(gt)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_replicate_pad_is_torch_replicate_without_its_backward():
    """The Grad loss's padding: the values of ``F.pad(mode="replicate")``,
    its gradient to rounding, and no replication-pad node in the graph
    (its CUDA backward sums with atomics, which made the JSPSR step differ
    from run to run on the card)."""
    from jspsr_torch.ops.filters import replicate_pad1

    x = torch.randn(3, 2, 7, 9, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    got, want = replicate_pad1(x), F.pad(x, (1, 1, 1, 1), mode="replicate")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    g = torch.randn_like(got)
    torch.testing.assert_close(torch.autograd.grad(got, x, g)[0],
                               torch.autograd.grad(want, x, g)[0],
                               rtol=1e-6, atol=1e-6)
    seen, todo = set(), [get_loss("grad")(x, x.detach() * 0.5).grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(n for n, _ in node.next_functions)
    names = {type(n).__name__ for n in seen}
    assert not any("Pad" in n for n in names), names


@pytest.mark.parametrize("cfg", [{"L1": 1}, {"L1": 1, "L2": 1, "Grad": 0.1},
                                 {"Charbonnier": 0.5, "SSIM": 2.0}])
def test_criterion_matches_jax(cfg):
    pred, gt = _loss_inputs("l1", np.random.default_rng(7))
    want = jax_build_criterion(dict(cfg))(jnp.asarray(pred), jnp.asarray(gt))
    got = build_criterion(dict(cfg))(_nchw(pred), _nchw(gt))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


# ------------------------------------------------------------ optimizers

class _Tiny(torch.nn.Module):
    """Two modules, so that ``diff_lr`` makes two groups."""

    def __init__(self, rng):
        super().__init__()
        self.body = torch.nn.Linear(3, 4)
        self.postprocessor = torch.nn.Linear(4, 2)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.from_numpy(
                    rng.normal(size=p.shape).astype(np.float32)))

    def tree(self):
        # copies: jnp.asarray may alias a numpy buffer on the CPU, and the
        # torch optimizer updates these tensors in place
        return {m: {k: jnp.array(v.detach().numpy(), copy=True)
                    for k, v in getattr(self, m).named_parameters()}
                for m in ("body", "postprocessor")}


def _opt_cfg(name, diff_lr=False, cls=AttrDict):
    return cls({"optimizer": name, "optimizer_kwargs": {
        "lr": 1e-2, "weight_decay": 1e-2, "momentum": 0.9,
        "diff_lr": diff_lr}})


@pytest.mark.parametrize("diff_lr", [False, True], ids=["one", "diff_lr"])
@pytest.mark.parametrize("name", ["SGD", "Adam", "AdamW", "RMSprop"])
def test_optimizer_steps_match_jax(name, diff_lr):
    """Four steps with the same gradients, the learning rate set anew
    (``set_learning_rate``) before the last two. Gradient magnitudes are
    0.5-1.5, where the two eps placements of RMSprop (optax inside the
    square root, torch outside) agree to 1e-6."""
    rng = np.random.default_rng(11)
    model = _Tiny(rng)
    params = model.tree()
    opt = optim.build_optimizer(_opt_cfg(name, diff_lr), model)
    jopt = jax_optim.build_optimizer(_opt_cfg(name, diff_lr, JaxAttrDict),
                                     params)
    jstate = jopt.init(params)
    for step in range(4):
        if step == 2:
            optim.set_learning_rate(opt, 5e-3, base_lr=1e-2)
            jax_optim.set_learning_rate(jstate, 5e-3, base_lr=1e-2)
        grads = {}
        for mod in ("body", "postprocessor"):
            for k, p in getattr(model, mod).named_parameters():
                g = (rng.uniform(0.5, 1.5, p.shape)
                     * rng.choice([-1.0, 1.0], p.shape)).astype(np.float32)
                p.grad = torch.from_numpy(g)
                grads.setdefault(mod, {})[k] = jnp.asarray(g)
        opt.step()
        updates, jstate = jopt.update(grads, jstate, params)
        params = optax.apply_updates(params, updates)
        for mod, leaves in params.items():
            for k, v in leaves.items():
                got = dict(getattr(model, mod).named_parameters())[k]
                np.testing.assert_allclose(
                    got.detach().numpy(), np.asarray(v), rtol=1e-5,
                    atol=1e-6, err_msg=f"{name} step {step} {mod}.{k}")


def test_diff_lr_groups_and_set_learning_rate():
    model = _Tiny(np.random.default_rng(0))
    opt = optim.build_optimizer(_opt_cfg("AdamW", diff_lr=True), model)
    groups = {g["name"]: g for g in opt.param_groups}
    assert set(groups) == {"base", "diff"}
    assert [p is model.postprocessor.weight or p is model.postprocessor.bias
            for p in groups["diff"]["params"]] == [True, True]
    assert groups["base"]["lr"] == 1e-2
    assert groups["diff"]["lr"] == optim.DIFF_LR
    optim.set_learning_rate(opt, 1e-3, base_lr=1e-2)
    assert groups["base"]["lr"] == 1e-3
    assert groups["diff"]["lr"] == pytest.approx(optim.DIFF_LR * 0.1)
    single = optim.build_optimizer(_opt_cfg("AdamW"), model)
    assert [g["name"] for g in single.param_groups] == ["base"]
    with pytest.raises(NotImplementedError):
        optim.build_optimizer(_opt_cfg("LBFGS"), model)


@pytest.mark.parametrize("name", ["WarmupStepLR", "StepLR",
                                  "CosineAnnealingLR", "OneCycleLR",
                                  "ConstantLR"])
def test_lr_schedule_matches_jax(name):
    cfg = {"scheduler": name, "epochs": 300, "optimizer_kwargs": {"lr": 1e-3},
           "scheduler_kwargs": {"max_lr": 1e-3, "step_size": 100,
                                "gamma": 0.5, "warmup_epoch": 3}}
    fn = optim.build_lr_schedule(AttrDict(cfg))
    jfn = jax_optim.build_lr_schedule(JaxAttrDict(cfg))
    assert [fn(e) for e in range(300)] == [jfn(e) for e in range(300)]


# ------------------------------------------------------------ train step

IN_CHANNELS = {"lr_dem": 1, "image": 3, "mask": 15}
LOSS = {"L1": 1, "L2": 1, "Grad": 0.1}
LR = 1e-3


@pytest.fixture
def bn_two_pass():
    """The JAX package's BatchNorm computes the batch variance in one pass,
    E[x²]-E[x]² (``nn/layers.py:156``), which loses digits where a channel's
    |mean|/std is large (at mean/std 300 its gradient is 1.1 % from float64,
    torch's two-pass 1e-6). The comparison runs it in its two-pass form,
    ``set_bn_single_pass(False)``, the arithmetic torch uses."""
    from jspsr_tpu.nn import layers

    layers.set_bn_single_pass(False)
    yield
    layers.set_bn_single_pass(True)


def _batches(n, rng, b=4, side=32):
    return [([rng.uniform(0.05, 0.95, (b, side, side, c)).astype(np.float32)
              for c in IN_CHANNELS.values()],
             rng.uniform(0.05, 0.95, (b, side, side, 1)).astype(np.float32))
            for _ in range(n)]


def _port_model(dtype=torch.float32):
    return JSPSR(dict(IN_CHANNELS), num_feature=8, layers=(1, 1, 1, 1),
                 generator=torch.Generator().manual_seed(3)).to(dtype)


def _both(accum_steps):
    """The port's and the JAX package's JSPSR (num_feature 8, one block per
    stage, SPN head on) with AdamW and a train step each."""
    port = _port_model()
    jmodel = JaxJSPSR(dict(IN_CHANNELS), num_feature=8, layers=(1, 1, 1, 1))
    cfg = {"optimizer": "AdamW", "optimizer_kwargs": {
        "lr": LR, "weight_decay": 1e-6, "momentum": 0.9, "diff_lr": False}}
    opt = optim.build_optimizer(AttrDict(cfg), port)
    step = make_train_step(port, build_criterion(LOSS), opt,
                           accum_steps=accum_steps)
    params, bn = _to_jax(jmodel, port.state_dict())
    jopt = jax_optim.build_optimizer(JaxAttrDict(cfg), params)
    jstep = jax_make_train_step(jmodel, jax_build_criterion(LOSS), jopt,
                                donate=False, accum_steps=accum_steps)
    state = TrainState(params, bn, jopt.init(params), jnp.zeros((), jnp.int32))
    return port, jmodel, opt, step, state, jstep


def _to_jax(jmodel, sd):
    """(params, bn) trees from a port-layout state_dict; copies, since
    jnp.asarray may alias the numpy view of a torch tensor that the torch
    optimizer and BatchNorm update in place."""
    return import_torch_state_dict(
        jmodel, {k: v.detach().numpy().copy() for k, v in sd.items()})


def _resync(port, jmodel, opt, state):
    """The JAX state set to the port's: parameters, BatchNorm statistics
    and AdamW moments, so that each step starts from the same state."""
    sd = port.state_dict()
    params, bn = _to_jax(jmodel, sd)
    named = dict(port.named_parameters())
    moments = []
    for key in ("exp_avg", "exp_avg_sq"):
        msd = dict(sd)
        msd.update({n: opt.state[p][key] for n, p in named.items()
                    if p in opt.state})
        moments.append(_to_jax(jmodel, msd)[0] if opt.state else None)
    opt_state = state.opt_state
    if moments[0] is not None:
        adam, *rest = opt_state.inner_state
        opt_state = opt_state._replace(inner_state=(
            adam._replace(mu=moments[0], nu=moments[1]), *rest))
    return TrainState(params, bn, opt_state, state.step)


def _adam_moments(opt_state):
    adam = opt_state.inner_state[0]
    return adam.mu, adam.nu


def _check_step(port, opt, before, state, losses, jlosses, grad_tree=None):
    """One step from the same state, port against JAX:

    - losses within rtol 1e-4;
    - gradients and Adam's first moments per tensor within 5e-2 relative
      L2, second moments (squares of gradients) within 1e-1: on these
      batches the JAX package's fp32 gradients differ from the port's by
      up to 2.4 % per tensor, and at the first step they are 1.7 % from
      float64 while the port's are within 1e-5
      (``test_port_gradient_matches_float64``). A wrong term or path
      shows as an error of order 1;
    - BatchNorm running statistics within rtol 1e-4;
    - the parameter update per tensor within 1e-2 relative L2 over the
      elements whose new first moments agree within 1 %. Adam's step is
      about lr·m/(sqrt(v)+eps) whatever the gradient's size, so where the
      moments differ by rounding noise (sign flips included) the noise
      sets the step: there the updates may differ by up to 2.1·lr."""
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                   rtol=1e-4, err_msg=k)
    named = dict(port.named_parameters())
    mu, nu = (state_dict_from_jax_tree(t, port) for t in _adam_moments(
        state.opt_state))
    checks = [("exp_avg", mu, 5e-2), ("exp_avg_sq", nu, 1e-1)]
    if grad_tree is not None:
        checks.append(("grad", state_dict_from_jax_tree(grad_tree, port),
                       5e-2))
    for what, ref, tol in checks:
        assert set(ref) == set(named), what
        for name, want in ref.items():
            got = (named[name].grad if what == "grad"
                   else opt.state[named[name]][what])
            assert _rel_err(got.numpy(), want.numpy()) < tol, (what, name)
    for name, want in state_dict_from_jax_tree(state.params, port).items():
        old = before[name].numpy()
        d_port = named[name].detach().numpy() - old
        d_jax = want.numpy() - old
        m_port, m_jax = opt.state[named[name]]["exp_avg"].numpy(), \
            mu[name].numpy()
        noisy = np.abs(m_port - m_jax) > 1e-2 * np.maximum(np.abs(m_port),
                                                           np.abs(m_jax))
        assert _rel_err(d_port[~noisy], d_jax[~noisy]) < 1e-2, name
        assert (np.abs(d_port - d_jax)[noisy] <= 2.1 * LR).all(), name
    bufs = dict(port.named_buffers())
    for name, want in state_dict_from_jax_tree(state.bn_state, port,
                                                "bn").items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(bufs[name].numpy(), want.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)


def test_port_gradient_matches_float64():
    """The port's fp32 gradient of one train-mode step is within 1e-4
    (relative L2, per tensor) of the same step in float64."""
    (inputs, gt), = _batches(1, np.random.default_rng(8))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        model = _port_model(dtype).train()
        pred = model([_nchw(x).to(dtype) for x in inputs])
        build_criterion(LOSS)(pred, _nchw(gt).to(dtype))["Total"].backward()
        grads[dtype] = {n: p.grad.double().numpy()
                        for n, p in model.named_parameters()}
    for name, want in grads[torch.float64].items():
        assert _rel_err(grads[torch.float32][name], want) < 1e-4, name


def test_three_train_steps_match_jax(bn_two_pass):
    """Three steps at batch 4 (32²), each from the same state in both
    packages. At batch 2 the fp32 gradient of this small model is up to
    2 % from float64 in either package (train-mode BatchNorm over so few
    samples), which would hide a real difference."""
    port, jmodel, opt, step, state, jstep = _both(accum_steps=1)
    crit = jax_build_criterion(LOSS)

    @jax.jit
    def jax_grad(params, bn_state, inputs, gt):
        def loss_fn(params):
            pred, _ = jmodel(params, bn_state, inputs, train=True)
            return crit(pred, gt)["Total"]
        return jax.grad(loss_fn)(params)

    launches = dict(deform_cuda.LAUNCHES)
    for inputs, gt in _batches(3, np.random.default_rng(8)):
        state = _resync(port, jmodel, opt, state)
        before = {n: p.detach().clone() for n, p in port.named_parameters()}
        jin, jgt = [jnp.asarray(x) for x in inputs], jnp.asarray(gt)
        grad_tree = jax_grad(state.params, state.bn_state, jin, jgt)
        losses = step([_nchw(x) for x in inputs], _nchw(gt))
        state, jlosses = jstep(state, jin, jgt)
        _check_step(port, opt, before, state, losses, jlosses, grad_tree)
    assert deform_cuda.LAUNCHES == launches  # CPU: plain deform versions


def test_accum_steps_2_matches_jax(bn_two_pass):
    """Two microbatches of 4: the mean gradient, the mean loss and the
    mean of the two BatchNorm updates, as the JAX scan."""
    port, jmodel, opt, step, state, jstep = _both(accum_steps=2)
    for inputs, gt in _batches(2, np.random.default_rng(9), b=8):
        state = _resync(port, jmodel, opt, state)
        before = {n: p.detach().clone() for n, p in port.named_parameters()}
        losses = step([_nchw(x) for x in inputs], _nchw(gt))
        state, jlosses = jstep(state, [jnp.asarray(x) for x in inputs],
                               jnp.asarray(gt))
        _check_step(port, opt, before, state, losses, jlosses)
    tracked = [b for n, b in port.named_buffers()
               if n.endswith("num_batches_tracked")]
    assert tracked and all(int(t) == 2 for t in tracked)  # one per step


def test_accum_steps_must_divide_batch_and_remat_raises():
    """A batch that does not divide into the microbatches raises, with
    ``remat`` too (ported: tests/test_torch_remat.py holds its steps
    bit-equal to the steps without)."""
    port = JSPSR(dict(IN_CHANNELS), num_feature=8, layers=(1, 1, 1, 1))
    opt = torch.optim.AdamW(port.parameters())
    (inputs, gt), = _batches(1, np.random.default_rng(0), b=3, side=16)
    for remat in (False, True):
        step = make_train_step(port, build_criterion(LOSS), opt,
                               accum_steps=2, remat=remat)
        with pytest.raises(ValueError, match="microbatches"):
            step([_nchw(x) for x in inputs], _nchw(gt))


def test_monitor_reports_ranges():
    port = JSPSR(dict(IN_CHANNELS), num_feature=8, layers=(1, 1, 1, 1))
    opt = torch.optim.AdamW(port.parameters())
    step = make_train_step(port, build_criterion(LOSS), opt, monitor=True)
    (inputs, gt), = _batches(1, np.random.default_rng(1), side=16)
    out = step([_nchw(x) for x in inputs], _nchw(gt))
    assert float(out["input_min"]) == pytest.approx(inputs[0].min())
    assert float(out["input_max"]) == pytest.approx(inputs[0].max())
    assert float(out["grad_min"]) < 0 < float(out["grad_max"])
    assert float(out["pred_min"]) <= float(out["pred_max"])


# ------------------------------------------------- trainer: drop-path draws

@pytest.fixture(scope="module")
def cf_cfg(tmp_path_factory):
    """A CompletionFormer run on a miniature DFC30 tree: 3 batches of 2
    per epoch at 32^2 (the backbone's /32)."""
    from jspsr_torch.data.synthetic import generate_mini_dfc30

    root, train, valid = generate_mini_dfc30(
        tmp_path_factory.mktemp("DFC30_8m"), train_cities=("Brest", "Caen"),
        valid_cities=("Vannes",), n_per_city=3, size=32)
    return {
        "name": "torch_drop_path_test", "dataset": "DFC30",
        "dataset_path": str(root), "resolution": 8,
        "train_set": train, "valid_set": valid,
        "input_data": {"COP30": 1, "image": 3, "mask": 15},
        "relative": True, "augment": False, "patch_size": 32,
        "crop_mode": "random", "patches_per_image": 1, "workers": 1,
        "tensor_kwargs": {"log": True, "min": -80, "max": 929,
                          "scale_mask": True},
        "model_name": "CompletionFormer",
        "model_kwargs": {"prop_time": 2, "pretrained": False,
                         "checkpoint": None},
        "loss": {"L1": 1},
        "optimizer": "AdamW",
        "optimizer_kwargs": {"lr": 1e-4, "weight_decay": 1e-6,
                             "momentum": 0.9, "diff_lr": False},
        "scheduler": "WarmupStepLR",
        "scheduler_kwargs": {"max_lr": 1e-4, "step_size": 100, "gamma": 0.5,
                             "warmup_epoch": 1},
        "train_batch_size": 2, "epochs": 1, "verbose": False, "seed": 7,
    }


def _tiny_backbone(model, generator=None):
    """CompletionFormer with its PVT cut to one block per stage (drop-path
    rates 0, 1/30, 2/30, 0.1), at the widths its decoder takes."""
    from jspsr_torch.models.pvt import PVT

    model.backbone.former = PVT(in_chans=128, patch_size=2, depths=(1, 1, 1, 1))
    return model


class _Enough(Exception):
    """Ends a recorded epoch early."""


def _drop_path_masks(cfg, tmp_path, monkeypatch, start_step, n_steps):
    """The drop-path keep masks drawn at each of ``n_steps`` train steps of
    a Trainer whose global step starts at ``start_step``."""
    from jspsr_torch.models.pvt import PVT
    from jspsr_torch.train import trainer as trainer_mod

    build = trainer_mod.build_model
    monkeypatch.setattr(trainer_mod, "build_model",
                        lambda p: _tiny_backbone(build(p)))
    drawn = []
    keep = PVT.drop_path_keep

    def recording_keep(self, *args):
        mask = keep(self, *args)
        if mask is not None:
            drawn.append(mask.clone())
        return mask

    monkeypatch.setattr(PVT, "drop_path_keep", recording_keep)
    t = trainer_mod.Trainer(AttrDict(cfg), result_dir=tmp_path, device="cpu")
    t.global_step = start_step
    inner, per_step = t.train_step, []

    def step(inputs, gt):
        drawn.clear()
        losses = inner(inputs, gt)
        per_step.append(torch.cat([m.flatten() for m in drawn]))
        if len(per_step) == n_steps:
            raise _Enough
        return losses

    t.train_step = step
    with pytest.raises(_Enough):
        t.train_one_epoch(0)
    return per_step


def test_drop_path_draws_depend_on_seed_and_step_alone(cf_cfg, tmp_path,
                                                       monkeypatch):
    """A run brought to global step 2 and a run that starts at step 2 draw
    the same drop-path masks there (the JAX step folds ``state.step`` into
    its key); steps 2 and 3 draw different ones."""
    through = _drop_path_masks(cf_cfg, tmp_path / "a", monkeypatch, 0, 3)
    resumed = _drop_path_masks(cf_cfg, tmp_path / "b", monkeypatch, 2, 2)
    assert through[2].numel() == 3 * 2  # 3 blocks with a rate > 0, batch 2
    torch.testing.assert_close(resumed[0], through[2], rtol=0, atol=0)
    assert not torch.equal(resumed[0], resumed[1])


def test_trainer_refuses_prefetch_split_off(cf_cfg, tmp_path, monkeypatch):
    """``prefetch_split: false`` is ported: the batch's numpy assembly and
    its staging run on one prefetch thread, not two, and the epoch is the
    split one's, bit for bit (every parameter and buffer, and the epoch
    loss). A JSPSR (num_feature 8) on the same tree keeps the epochs
    short."""
    from jspsr_torch.train import trainer as trainer_mod

    stages = []
    prefetch = trainer_mod.device_prefetch

    def counting_prefetch(iterator, transfer, host_stage=None, **kw):
        stages.append(host_stage is not None)
        return prefetch(iterator, transfer, host_stage=host_stage, **kw)

    monkeypatch.setattr(trainer_mod, "device_prefetch", counting_prefetch)
    cfg = dict(cf_cfg, model_name="JSPSR",
               input_data={"lr_dem": 1, "COP30": 1, "image": 3, "mask": 15},
               model_kwargs={"num_block": 1, "num_feature": 8})
    runs = {}
    for split in (True, False):
        t = trainer_mod.Trainer(AttrDict(dict(cfg, prefetch_split=split)),
                                result_dir=tmp_path / str(split),
                                device="cpu")
        loss, _ = t.train_one_epoch(0)
        runs[split] = (loss, t.model.state_dict())
    assert stages == [True, False]
    (want_loss, want), (loss, got) = runs[True], runs[False]
    assert loss == want_loss
    assert all(torch.equal(got[k], want[k]) for k in want)
