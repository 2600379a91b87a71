"""LRRU in the PyTorch port (jspsr_torch/models/lrru.py) against the JAX
package's (jspsr_tpu/models/lrru.py): each module and the whole model in
eval, one train step, the padding of served scenes and the decay of the
parameters the loss does not reach.

The port's weights are carried into JAX with ``import_torch_state_dict``;
the same seeded numpy inputs go through both. Tolerance: rtol 1e-4 / atol
3e-5, the JAX suite's LRRU tolerance (tests/test_parity_lrru.py:45).

The DEM is smooth terrain in which 30 % of the pixels are 0 (no data):
``preserve`` puts the input back wherever the DEM is > 0 before every
round, so only at those pixels do rounds 1-3 reach the output. (A DEM of
independent random pixels with random signs makes both packages' fp32
forwards of the random-weight model up to 3e-4 from float64, each as far
as the other: the deform sampling of a surface that jumps by 1.8 between
neighbours amplifies rounding.)
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from jspsr_tpu.config.loader import AttrDict as JaxAttrDict
from jspsr_tpu.config.loader import create_config as jax_create_config
from jspsr_tpu.losses import build_criterion as jax_build_criterion
from jspsr_tpu.models import lrru as J
from jspsr_tpu.models.factory import build_model as jax_build_model
from jspsr_tpu.train import optim as jax_optim
from jspsr_tpu.train.state import TrainState
from jspsr_tpu.train.step import make_train_step as jax_make_train_step
from jspsr_tpu.utils.torch_import import expected_torch_keys
from jspsr_torch.config.loader import AttrDict, create_config
from jspsr_torch.eval.inference import upscale_dem
from jspsr_torch.losses import build_criterion
from jspsr_torch.models import lrru as L
from jspsr_torch.models.factory import build_model
from jspsr_torch.models.spn import PostProcessor
from jspsr_torch.ops import deform_cuda
from jspsr_torch.train import optim
from jspsr_torch.train.step import make_train_step
from jspsr_torch.utils.perturb import perturb_weights
from jspsr_torch.utils.weights import state_dict_from_jax_tree
from tests.test_torch_train import (  # noqa: F401 (bn_two_pass: a fixture)
    LR,
    _nchw,
    _rel_err,
    _to_jax,
    bn_two_pass,
)

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 3e-5
IN_CHANNELS = {"lr_dem": 1, "image": 3}
# narrow: bc 4 (32-64 channels at the bottom), two blocks in the first
# stage (the within-stage block and the annealed survival probability),
# one in the others
NARROW = {"bc": 4, "layers": (2, 1, 1, 1, 1), "prob": 0.8}
LOSS = {"L1": 1, "L2": 1, "Grad": 0.1}


def smooth_dem(rng, b, h, w, holes=0.3):
    """(B, 1, H, W) smooth terrain in [0.1, 0.9] with the share ``holes``
    of its pixels, in blobs, set to 0."""
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


def _jax_params(jmodule, port_module):
    return _to_jax(jmodule, port_module.state_dict())


def _nhwc(x):
    return jnp.asarray(np.ascontiguousarray(np.asarray(x).transpose(0, 2, 3,
                                                                    1)))


def _back(y):
    return np.asarray(y).transpose(0, 3, 1, 2)


def _u(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


# module name -> (port module, JAX module, numpy inputs NCHW)
def _module_case(name, rng):
    if name == "LBasic2d_bn":
        return (L.Basic2d(6, 8), J.LBasic2d(6, 8, bn=True),
                [_u(rng, 2, 6, 12, 16)])
    if name == "LBasic2d_bias_k5":
        return (L.Basic2d(1, 8, kernel_size=5, padding=2, bn=False),
                J.LBasic2d(1, 8, bn=False, kernel_size=5, padding=2),
                [_u(rng, 2, 1, 12, 16)])
    if name == "LBasic2dTrans":
        return (L.LBasic2dTrans(8, 6), J.LBasic2dTrans(8, 6),
                [_u(rng, 2, 8, 6, 8)])
    if name == "StoDepthBlock_downsample":
        return (L.StoDepthBlock(0.8, True, 8, 16, 2, L.LDownsample(8, 16, 2)),
                J.StoDepthBlock(0.8, True, 8, 16, 2, J.LDownsample(8, 16, 2)),
                [_u(rng, 2, 8, 12, 16)])
    if name == "StoDepthBlock":
        return (L.StoDepthBlock(0.8, True, 8, 8), J.StoDepthBlock(0.8, True,
                                                                  8, 8),
                [_u(rng, 2, 8, 12, 16)])
    if name == "LGuide":
        return L.LGuide(8), J.LGuide(8), [_u(rng, 2, 8, 12, 16),
                                          _u(rng, 2, 8, 12, 16)]
    if name == "BasicDepthEncoder":
        return (L.BasicDepthEncoder(3, 4), J.BasicDepthEncoder(3, 4),
                [smooth_dem(rng, 2, 16, 24), _u(rng, 2, 8, 16, 24)])
    raise KeyError(name)


MODULES = ["LBasic2d_bn", "LBasic2d_bias_k5", "LBasic2dTrans",
           "StoDepthBlock_downsample", "StoDepthBlock", "LGuide",
           "BasicDepthEncoder"]


@pytest.mark.parametrize("name", MODULES)
def test_module_matches_jax_in_eval(name):
    """Each module in eval (StoDepth at survival probability 0.8 with
    ``mult_flag``: ``relu(0.8 * out + idt)``), BatchNorm statistics
    perturbed; the key list is the JAX importer's."""
    rng = np.random.default_rng(MODULES.index(name))
    port, jmod, inputs = _module_case(name, rng)
    perturb_weights(port, seed=1, affine=True).eval()
    assert [k for k in port.state_dict()
            if not k.endswith("num_batches_tracked")] \
        == expected_torch_keys(jmod)
    params, state = _jax_params(jmod, port)
    with torch.no_grad():
        got = port(*[torch.from_numpy(x) for x in inputs])
    want, _ = jmod(params, state, *[_nhwc(x) for x in inputs], train=False)
    if isinstance(got, tuple):  # the encoder's (affinity, offset)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), _back(w), rtol=RTOL,
                                       atol=ATOL)
    else:
        np.testing.assert_allclose(got.numpy(), _back(want), rtol=RTOL,
                                   atol=ATOL)


def test_stodepth_draws_nothing_in_training():
    """In train mode at survival probability 0.8 the block is
    ``relu(out + idt)`` whatever the state of torch's generators, as the
    JAX block is without a key (the JAX LRRU never passes one)."""
    rng = np.random.default_rng(3)
    port = L.StoDepthBlock(0.8, True, 8, 8).train()
    jmod = J.StoDepthBlock(0.8, True, 8, 8)
    params, state = _jax_params(jmod, port)
    x = _u(rng, 2, 8, 12, 16)
    outs = []
    for seed in (0, 1):
        torch.manual_seed(seed)
        outs.append(port(torch.from_numpy(x)).detach())
    assert torch.equal(outs[0], outs[1])
    with torch.no_grad():
        idt = torch.from_numpy(x)
        out = port.bn2(port.conv2(torch.relu(port.bn1(port.conv1(idt)))))
    torch.testing.assert_close(outs[0], torch.relu(out + idt), rtol=0,
                               atol=0)
    want, _ = jmod(params, state, _nhwc(x), train=True)
    np.testing.assert_allclose(outs[0].numpy(), _back(want), rtol=RTOL,
                               atol=ATOL)


def test_post_process_matches_jax():
    """The shared post-process: zero-mean affinities, the deform conv of
    the detached depth (plain version on the CPU), plus the depth; its
    kernel of ones and zero bias perturbed."""
    rng = np.random.default_rng(4)
    port = PostProcessor(3, residual=True)
    with torch.no_grad():
        port.w.add_(torch.from_numpy(_u(rng, 1, 1, 3, 3, lo=-0.2, hi=0.2)))
        port.b.fill_(0.05)
    jmod = J.PostProcess(3, True)
    params = {"w": port.w.detach().numpy().transpose(2, 3, 1, 0),
              "b": port.b.detach().numpy()}
    depth = smooth_dem(rng, 2, 16, 24)
    weight = rng.uniform(0, 1, (2, 9, 16, 24)).astype(np.float32)
    offset = rng.normal(0, 1.5, (2, 18, 16, 24)).astype(np.float32)
    got = port(*[torch.from_numpy(a) for a in (depth, weight, offset)])
    want, _ = jmod(params, {}, *[_nhwc(a) for a in (depth, weight, offset)])
    np.testing.assert_allclose(got.detach().numpy(), _back(want), rtol=RTOL,
                               atol=ATOL)


def _narrow_pair(seed=1):
    port = perturb_weights(L.LRRU(dict(IN_CHANNELS), **NARROW,
                                  generator=torch.Generator().manual_seed(
                                      seed)), seed=2)
    jmodel = J.LRRU(dict(IN_CHANNELS), **NARROW)
    return port, jmodel


def test_lrru_matches_jax_in_eval():
    """The whole narrow model in eval at 48 x 32 on a DEM with 30 % of its
    pixels 0, BatchNorm statistics perturbed."""
    rng = np.random.default_rng(5)
    port, jmodel = _narrow_pair()
    port.eval()
    assert [k for k in port.state_dict()
            if not k.endswith("num_batches_tracked")] \
        == expected_torch_keys(jmodel)
    params, state = _jax_params(jmodel, port)
    dem = smooth_dem(rng, 2, 48, 32)
    img = rng.uniform(0, 1, (2, 3, 48, 32)).astype(np.float32)
    assert 0.25 < (dem <= 0).mean() < 0.35
    with torch.no_grad():
        got = port([torch.from_numpy(dem), torch.from_numpy(img)])
    want, _ = jmodel(params, state, [_nhwc(dem), _nhwc(img)], train=False)
    np.testing.assert_allclose(got.numpy(), _back(want), rtol=RTOL,
                               atol=ATOL)


def test_shipped_config_keys_and_parameters():
    """configs/lrru_r8_img.yml: the JAX package's 20,843,342 parameters and
    its importer's 430 keys, in order."""
    port = build_model(create_config("configs/lrru_r8_img.yml"))
    keys = [k for k in port.state_dict()
            if not k.endswith("num_batches_tracked")]
    assert keys == expected_torch_keys(jax_build_model(
        jax_create_config("configs/lrru_r8_img.yml")))
    assert len(keys) == 430
    assert sum(q.numel() for q in port.parameters()) == 20_843_342


# ------------------------------------------------- served scenes: the pad

def _serving_config(**kw):
    return AttrDict({
        "model_name": "LRRU", "input_data": {"lr_dem": 1, "image": 3},
        "relative": False,
        "tensor_kwargs": {"log": False, "min": -80, "max": 929},
        "model_kwargs": dict(NARROW), **kw})


def test_scene_pads_to_16_where_jax_raises():
    """LRRU's encoder goes down to /16: a 40 x 56 scene (a multiple of 8)
    makes the JAX LRRU raise; the port's ``upscale_dem`` pads it to 48 x
    64 and serves it, and its forward there equals the JAX model's on the
    same padded input. Pixels at the configured minimum elevation scale to
    0, so the rounds reach the output there."""
    rng = np.random.default_rng(6)
    port, jmodel = _narrow_pair(seed=3)
    port.eval()
    params, state = _jax_params(jmodel, port)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jmodel(params, state, [jnp.zeros((1, 40, 40, 1)),
                               jnp.zeros((1, 40, 40, 3))], train=False)

    dem = 100.0 + 300.0 * smooth_dem(rng, 1, 40, 56, holes=0.1)[0, 0]
    dem[dem == 100.0] = -80.0
    sample = {"lr_dem": dem[..., None].astype(np.float32),
              "image": rng.integers(0, 256, (40, 56, 3)).astype(np.uint8)}
    seen = []

    def forward(inputs):
        seen.append([x.numpy().copy() for x in inputs])
        with torch.no_grad():
            out = port(inputs)
        seen[-1].append(out.numpy())
        return out

    pred, _, _ = upscale_dem(forward, sample, _serving_config(), "cpu")
    assert pred.shape == (40, 56, 1) and np.isfinite(pred).all()
    (dem_in, img_in, got), = seen
    assert dem_in.shape == (1, 1, 48, 64) and (dem_in <= 0).any()
    want, _ = jmodel(params, state, [_nhwc(dem_in), _nhwc(img_in)],
                     train=False)
    np.testing.assert_allclose(got, _back(want), rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------ train step

def _adamw(lr, wd):
    return {"optimizer": "AdamW", "optimizer_kwargs": {
        "lr": lr, "weight_decay": wd, "momentum": 0.9, "diff_lr": False}}


@pytest.fixture(scope="module")
def jax_step():
    """The narrow JAX LRRU, its AdamW and its jitted train step, compiled
    once: the learning rate and weight decay are hyperparameters in the
    optimizer state (``optax.inject_hyperparams``), set per test."""
    jmodel = J.LRRU(dict(IN_CHANNELS), **NARROW)
    cfg = JaxAttrDict(_adamw(LR, 1e-6))
    params, _ = _to_jax(jmodel, _narrow_pair()[0].state_dict())
    jopt = jax_optim.build_optimizer(cfg, params)
    return jmodel, jopt, jax_make_train_step(
        jmodel, jax_build_criterion(LOSS), jopt, donate=False)


def _steps(jax_step, port, lr, wd):
    """The port's step and the JAX state, both from ``port``'s weights,
    at ``lr`` and weight decay ``wd``."""
    jmodel, jopt, jstep = jax_step
    opt = optim.build_optimizer(AttrDict(_adamw(lr, wd)), port)
    step = make_train_step(port, build_criterion(LOSS), opt)
    params, bn = _to_jax(jmodel, port.state_dict())
    opt_state = jopt.init(params)
    opt_state.hyperparams.update(learning_rate=jnp.asarray(lr, jnp.float32),
                                 weight_decay=jnp.asarray(wd, jnp.float32))
    state = TrainState(params, bn, opt_state, jnp.zeros((), jnp.int32))
    return opt, step, state, jstep


def _train_batch(rng, b=4, side=32):
    dem = smooth_dem(rng, b, side, side).transpose(0, 2, 3, 1)
    img = rng.uniform(0, 1, (b, side, side, 3)).astype(np.float32)
    gt = np.clip(dem + rng.normal(0, 0.02, dem.shape), 0, 1).astype(
        np.float32)
    return [dem, img], gt


def _float64_grads(port, state, inputs, gt):
    """The port's gradient of the train-mode loss in float64 from the
    weights ``state``."""
    model, _ = _narrow_pair()
    model.load_state_dict(state)
    model = model.double().train()
    pred = model([_nchw(x).double() for x in inputs])
    build_criterion(LOSS)(pred, _nchw(gt).double())["Total"].backward()
    return {n: q.grad for n, q in model.named_parameters()
            if q.grad is not None}


UNREACHED = ("upproj0.", "upproj1.", "upproj2.", "weight_offset0.",
             "weight_offset1.", "weight_offset2.")


def test_train_step_matches_jax(bn_two_pass, jax_step):
    """One train step at batch 4 (32²) from the same state: the losses
    within rtol 1e-4; every gradient of the port within 1e-4 (relative L2
    per tensor) of the port's float64 gradient; the gradients (AdamW's
    first moments over 1 - beta1) within 5e-2 of the JAX package's
    wherever its fp32 gradient is within 1e-2 of float64, exact zeros for
    the heads of rounds 1-3 in both; the parameter updates as
    ``tests/test_torch_train.py`` holds them; the BatchNorm statistics
    within rtol 1e-4. The JAX package's fp32 bias gradient of the DEM stem
    (``conv_lidar``), a sum of 4,096 terms per channel that cancel, is 35 %
    from float64 on this batch where the port's is 5e-5: such a tensor is
    held to float64 alone. On the CPU the deform op runs its plain
    version."""
    port, _ = _narrow_pair(seed=4)
    port.train()
    start = {k: v.clone() for k, v in port.state_dict().items()}
    opt, step, state, jstep = _steps(jax_step, port, LR, 1e-6)
    inputs, gt = _train_batch(np.random.default_rng(7))
    f64 = _float64_grads(port, start, inputs, gt)
    before = {n: q.detach().clone() for n, q in port.named_parameters()}
    launches = dict(deform_cuda.LAUNCHES)
    losses = step([_nchw(x) for x in inputs], _nchw(gt))
    assert deform_cuda.LAUNCHES == launches  # CPU: plain deform versions
    state, jlosses = jstep(state, [jnp.asarray(x) for x in inputs],
                           jnp.asarray(gt))
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                   rtol=1e-4, err_msg=k)

    adam = state.opt_state.inner_state[0]
    mu = state_dict_from_jax_tree(adam.mu, port)
    after = state_dict_from_jax_tree(state.params, port)
    held_to_f64 = []
    for name, q in port.named_parameters():
        grad, jgrad = q.grad, mu[name] / 0.1
        if name.startswith(UNREACHED):
            assert not grad.any() and not jgrad.any(), name
            assert name not in f64  # no gradient reaches them
            continue
        assert _rel_err(grad.numpy(), f64[name].numpy()) < 1e-4, name
        if _rel_err(jgrad.numpy(), f64[name].numpy()) > 1e-2:
            held_to_f64.append(name)
            continue
        assert _rel_err(grad.numpy(), jgrad.numpy()) < 5e-2, name
        # Adam's first step is about -lr * sign(g): where the two
        # gradients differ by rounding noise the sign may flip
        d_port = (q.detach() - before[name]).numpy()
        d_jax = (after[name] - before[name]).numpy()
        m_port, m_jax = opt.state[q]["exp_avg"].numpy(), mu[name].numpy()
        noisy = np.abs(m_port - m_jax) > 1e-2 * np.maximum(np.abs(m_port),
                                                           np.abs(m_jax))
        assert _rel_err(d_port[~noisy], d_jax[~noisy]) < 1e-2, name
        assert (np.abs(d_port - d_jax)[noisy] <= 2.1 * LR).all(), name
    assert len(held_to_f64) <= 2, held_to_f64
    bufs = dict(port.named_buffers())
    for name, want in state_dict_from_jax_tree(state.bn_state, port,
                                                "bn").items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(bufs[name].numpy(), want.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)


def test_unreached_parameters_decay_as_in_jax(jax_step):
    """The heads of rounds 1-3 get no gradient. ``jax.grad`` gives them
    zeros and optax's AdamW decays them and carries their moments; the
    port's step gives them a zero gradient, so torch's AdamW does the same
    (without it they keep ``grad is None`` and AdamW skips them). At
    weight decay 0.1 and lr 1e-2 the decay shows in fp32."""
    port, _ = _narrow_pair(seed=5)
    opt, step, state, jstep = _steps(jax_step, port, 1e-2, 0.1)
    inputs, gt = _train_batch(np.random.default_rng(8))
    before = {n: q.detach().clone() for n, q in port.named_parameters()}
    step([_nchw(x) for x in inputs], _nchw(gt))
    state, _ = jstep(state, [jnp.asarray(x) for x in inputs],
                     jnp.asarray(gt))
    after = state_dict_from_jax_tree(state.params, port)
    named = dict(port.named_parameters())
    heads = [n for n in named if n.startswith(("upproj0.",
                                               "weight_offset0."))]
    for name in heads:
        got, was = named[name].detach(), before[name]
        # decayed wherever it is not 0, as the JAX package decays it
        assert torch.equal(got != was, was != 0), name
        torch.testing.assert_close(got, after[name], rtol=1e-6, atol=0,
                                   msg=name)
        assert not opt.state[named[name]]["exp_avg"].any()
    assert len(heads) == 29
    assert len(opt.state) == len(named)
    assert {int(s["step"]) for s in opt.state.values()} == {1}
