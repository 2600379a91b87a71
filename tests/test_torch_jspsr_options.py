"""JSPSR's execution options in the port, ``fuse_stems`` and
``eval_grouped``, against the port's separate path and against the JAX
package's model with the same option.

The same weights (the port's state_dict, BatchNorm perturbed, carried into
JAX by ``import_torch_state_dict``) and the same numpy inputs go through
all three; the outputs agree at the JAX suite's whole-model tolerance
(rtol 1e-4, atol 2e-5, tests/test_parity_jspsr.py:68): the convs are
regrouped, the arithmetic is fp32 throughout. The bf16 body is held to its
separate path at the JAX package's bf16 bound
(tests/test_jspsr_precision.py:110-111: max 0.1, mean 0.02).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from jspsr_tpu.models.jspsr import JSPSR as JaxJSPSR
from jspsr_tpu.nn import layers as jax_layers
from jspsr_tpu.utils.torch_import import import_torch_state_dict
from jspsr_torch.config.loader import AttrDict
from jspsr_torch.models.factory import build_model
from jspsr_torch.models.jspsr import JSPSR
from jspsr_torch.utils.weights import jax_flat_from_state_dict

torch.set_num_threads(2)

# the branch sets of tests/test_eval_grouped.py:22-26
BRANCH_SETS = [
    ({"lr_dem": 1, "image": 3, "mask": 15}, (2, 2, 2, 2)),
    ({"lr_dem": 1, "image": 3}, (1, 1, 1, 1)),
    ({"lr_dem": 1, "image": 3, "canopy": 1}, (2, 2, 2, 2)),
]
OPTIONS = [{"fuse_stems": True}, {"eval_grouped": True},
           {"fuse_stems": True, "eval_grouped": True}]


def _ids(cases):
    return ["-".join(c) for c, _ in cases]


def _perturb_bn(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0, 0.1, generator=g)
    return model


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _inputs(in_channels, keys, seed, batch=2, side=32):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.05, 0.95, (batch, side, side, in_channels[k]))
            .astype(np.float32) for k in keys]


def _pair(in_channels, layers, compute_dtype=None, **options):
    """(separate-path model, BatchNorm perturbed; the same weights with
    ``options``)."""
    sep = _perturb_bn(JSPSR(dict(in_channels), num_feature=8, layers=layers,
                            compute_dtype=compute_dtype,
                            generator=torch.Generator().manual_seed(0)), 1)
    opt = JSPSR(dict(in_channels), num_feature=8, layers=layers,
                compute_dtype=compute_dtype, **options)
    opt.load_state_dict(sep.state_dict())
    return sep, opt


@pytest.mark.parametrize("options", OPTIONS,
                         ids=["fuse_stems", "eval_grouped", "both"])
@pytest.mark.parametrize("in_channels,layers", BRANCH_SETS,
                         ids=_ids(BRANCH_SETS))
def test_option_eval_forward_matches_separate_and_jax(in_channels, layers,
                                                      options):
    sep, opt = _pair(in_channels, layers, **options)
    assert list(jax_flat_from_state_dict(opt)) == \
        list(jax_flat_from_state_dict(sep))  # the weights do not move
    xs = _inputs(in_channels, sep.input_keys(), seed=42, batch=1)
    with torch.inference_mode():
        want = sep.eval()([_nchw(a) for a in xs]).numpy()
        got = opt.eval()([_nchw(a) for a in xs]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)

    jmodel = JaxJSPSR(dict(in_channels), num_feature=8, layers=layers,
                      **options)
    params, state = import_torch_state_dict(jmodel, opt.state_dict())
    ref, _ = jmodel(params, state, [jnp.asarray(a) for a in xs],
                    train=False)
    np.testing.assert_allclose(got, np.asarray(ref).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=2e-5)


@pytest.fixture
def bn_two_pass():
    """JAX's train-mode BatchNorm in its two-pass form, torch's arithmetic
    (ROADMAP §3 note 5)."""
    jax_layers.set_bn_single_pass(False)
    yield
    jax_layers.set_bn_single_pass(True)


def test_fuse_stems_train_matches_jax(bn_two_pass):
    """A train-mode forward and the gradient of its mean with
    ``fuse_stems``: the output, the image stem's running statistics
    (updated once) and the gradients of the three stems' per-branch
    weights, against the JAX model with the option and against the port's
    separate path (tests/test_jspsr_precision.py:53's case). The gradients
    are held to the separate path within 1e-4 relative L2 and to JAX
    within 5e-2, the train-step tolerance of tests/test_torch_train.py
    (``_check_step``: JAX's fp32 gradients of this small model differ from
    the port's by up to 2.4 % per tensor; here 1.0-1.7 %)."""
    in_channels = {"lr_dem": 1, "image": 3, "mask": 15}
    sep, opt = _pair(in_channels, (1, 1, 1, 1), fuse_stems=True)
    jmodel = JaxJSPSR(dict(in_channels), num_feature=8, layers=(1, 1, 1, 1),
                      fuse_stems=True)
    params, state = import_torch_state_dict(
        jmodel, {k: v.numpy().copy() for k, v in opt.state_dict().items()})
    xs = _inputs(in_channels, sep.input_keys(), seed=3, batch=4)

    def loss(q):
        y, ns = jmodel(q, state, [jnp.asarray(a) for a in xs], train=True)
        return jnp.mean(y), (y, ns)

    jgrads, (ref, ns) = jax.jit(jax.grad(loss, has_aux=True))(params)
    outs = {}
    for name, model in (("sep", sep), ("opt", opt)):
        model.train()
        y = model([_nchw(a) for a in xs])
        y.mean().backward()
        outs[name] = y.detach().numpy()
    np.testing.assert_allclose(outs["opt"], outs["sep"], rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(outs["opt"],
                               np.asarray(ref).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=2e-5)
    bn = opt.conv_img.conv.bn
    assert int(bn.num_batches_tracked) == 1
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(ns["conv_img"]["bn"]["mean"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(ns["conv_img"]["bn"]["var"]),
                               rtol=1e-4, atol=1e-6)
    for stem in ("conv_dem", "conv_img", "conv_aux"):
        got = getattr(opt, stem).conv[0].weight.grad.numpy()
        want = getattr(sep, stem).conv[0].weight.grad.numpy()
        jw = np.asarray(jgrads[stem]["conv"]["w"]).transpose(3, 2, 0, 1)
        for ref_grad, tol in ((want, 1e-4), (jw, 5e-2)):
            rel = np.linalg.norm(got - ref_grad) / np.linalg.norm(ref_grad)
            assert rel < tol, (stem, rel)


def test_eval_grouped_train_takes_the_separate_path():
    """In training ``eval_grouped`` changes nothing: the output and every
    BatchNorm buffer after the forward are the separate path's, bit for
    bit."""
    in_channels = {"lr_dem": 1, "image": 3}
    sep, opt = _pair(in_channels, (1, 1, 1, 1), eval_grouped=True)
    xs = [_nchw(a) for a in _inputs(in_channels, sep.input_keys(), seed=4)]
    got, want = opt.train()(xs), sep.train()(xs)
    assert torch.equal(got, want)
    bufs = dict(sep.named_buffers())
    for name, b in opt.named_buffers():
        assert torch.equal(b, bufs[name]), name


@pytest.mark.parametrize("options", OPTIONS,
                         ids=["fuse_stems", "eval_grouped", "both"])
def test_bf16_body_option_matches_separate(options):
    """The bf16 body with the option against its own separate path, at
    the JAX package's bf16 bound (max 0.1, mean 0.02): the regrouped convs
    round at other points."""
    in_channels = {"lr_dem": 1, "image": 3, "mask": 15}
    sep, opt = _pair(in_channels, (1, 1, 1, 1), compute_dtype="bfloat16",
                     **options)
    xs = [_nchw(a) for a in _inputs(in_channels, sep.input_keys(), seed=5)]
    with torch.inference_mode():
        want, got = sep.eval()(xs), opt.eval()(xs)
    assert got.dtype == torch.float32
    d = (got - want).abs()
    assert float(d.max()) < 0.1 and float(d.mean()) < 0.02


@pytest.mark.parametrize("option", ["fuse_stems", "eval_grouped",
                                    "remat_stages"])
def test_factory_passes_the_options(option):
    """The factory hands each key to the model, as the JAX factory does;
    the parameter keys are the same with the option as without."""
    cfg = AttrDict({"model_name": "JSPSR",
                    "input_data": {"lr_dem": 1, "image": 3},
                    "model_kwargs": {"num_block": 1, "num_feature": 8}})
    plain = build_model(cfg)
    model = build_model(AttrDict(dict(cfg, model_kwargs=dict(
        cfg.model_kwargs, **{option: True}))))
    assert getattr(model, option) is True
    assert list(model.state_dict()) == list(plain.state_dict())
