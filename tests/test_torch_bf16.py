"""The mixed-precision JSPSR (``compute_dtype: bfloat16``, with and without
``spn_sample_dtype: bfloat16``) of the port against the JAX package's.

The JAX parameters (``model.init``) are carried into the port by
``utils/weights.py``; the same numpy inputs (the smooth DEM of
tests/test_jspsr_precision.py) go through both, the JAX model under
``force_deform_impl("pallas")``, so that its deform conv is the Pallas
kernel (interpret mode on the CPU) and honours ``sample_dtype`` (its CPU
default, the gather form, ignores it). Both packages round at bf16, at
different points, so the port is held to twice the JAX package's own
distance between its bf16 and fp32 models: the outputs' largest and mean
distance, and each parameter gradient of one train step in relative L2.
Then the dtype split inside the port's model, its BatchNorm's bf16
arithmetic against the JAX package's, its own bf16-to-fp32 bound
(the JAX test's, tests/test_jspsr_precision.py:110-111), and the shipped
configs/jspsr_r8_img_msk_bf16.yml through the Trainer on the CPU.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from jspsr_tpu.models.jspsr import JSPSR as JaxJSPSR
from jspsr_tpu.nn import layers as jax_layers
from jspsr_tpu.nn.layers import BatchNorm2d as JaxBatchNorm2d, \
    set_bn_single_pass
from jspsr_tpu.ops.deform_conv import force_deform_impl
from jspsr_tpu.train.checkpoint import flatten_tree
from jspsr_torch.config.loader import create_config
from jspsr_torch.data.synthetic import generate_mini_dfc30
from jspsr_torch.models.jspsr import JSPSR
from jspsr_torch.nn.layers import BatchNorm2d
from jspsr_torch.train.trainer import Trainer
from jspsr_torch.utils.weights import state_dict_from_jax, \
    state_dict_from_jax_tree

torch.set_num_threads(2)

BRANCHES = {"lr_dem": 1, "image": 3, "mask": 15}
KW = {"num_feature": 8, "layers": (1, 1, 1, 1)}
# the port's distance from the JAX bf16 model, over the JAX bf16 model's
# distance from its fp32 one (measured: at most 0.8 for the outputs and
# 1.7 for a gradient leaf)
FACTOR = 2.0
SAMPLING = [None, "bfloat16"]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    xs = [rng.uniform(0.3, 0.7, (2, 32, 32, 1)).astype(np.float32),
          rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32),
          rng.uniform(0, 1, (2, 32, 32, 15)).astype(np.float32)]
    gt = np.clip(xs[0] + rng.normal(0, 0.02, xs[0].shape), 0, 1).astype(
        np.float32)
    params, bn = JaxJSPSR(BRANCHES, **KW).init(jax.random.PRNGKey(0))
    flat = {f"params/{k}": np.asarray(v)
            for k, v in flatten_tree(params).items()}
    flat.update({f"bn/{k}": np.asarray(v)
                 for k, v in flatten_tree(bn).items()})
    return xs, gt, params, bn, flat


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _jax(compute, sample):
    return JaxJSPSR(BRANCHES, compute_dtype=compute,
                    spn_sample_dtype=sample, **KW)


def _port(flat, compute, sample, train):
    model = JSPSR(BRANCHES, compute_dtype=compute, spn_sample_dtype=sample,
                  **KW)
    model.load_state_dict(state_dict_from_jax(flat, model))
    return model.train(train)


def _jax_forward(model, setup, train):
    xs, _, params, bn, _ = setup
    with force_deform_impl("pallas"):
        y, _ = jax.jit(lambda q, s, x: model(q, s, x, train=train))(
            params, bn, [jnp.asarray(a) for a in xs])
    return np.asarray(y).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("sample", SAMPLING, ids=["fp32_sampling",
                                                  "bf16_sampling"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bf16_forward_matches_jax(setup, train, sample):
    xs, _, _, _, flat = setup
    ref = _jax_forward(_jax("bfloat16", sample), setup, train)
    ref32 = _jax_forward(_jax(None, None), setup, train)
    with torch.no_grad():
        got = _port(flat, "bfloat16", sample, train)(
            [_nchw(a) for a in xs])
    assert got.dtype == torch.float32 and got.shape == (2, 1, 32, 32)
    got = got.numpy()
    d_port, d_jax = np.abs(got - ref), np.abs(ref - ref32)
    print(f"bf16 forward ({'train' if train else 'eval'}, sampling "
          f"{sample}): port vs JAX bf16 max {d_port.max():.3g} mean "
          f"{d_port.mean():.3g}; JAX bf16 vs fp32 max {d_jax.max():.3g} "
          f"mean {d_jax.mean():.3g}")
    assert d_port.max() <= FACTOR * d_jax.max()
    assert d_port.mean() <= FACTOR * d_jax.mean()


def _jax_grads(model, setup):
    """The gradient of the mean squared error. An L1 term would make the
    SPN bias's gradient a sum of +-1/N terms that cancel, whose distance
    measures where the bf16 noise flips a residual's sign, not the
    gradient's arithmetic."""
    xs, gt, params, bn, _ = setup

    def loss(q):
        y, _ = model(q, bn, [jnp.asarray(a) for a in xs], train=True)
        return jnp.mean(jnp.square(y - jnp.asarray(gt)))

    with force_deform_impl("pallas"):
        return jax.tree_util.tree_map(np.asarray,
                                      jax.jit(jax.grad(loss))(params))


@pytest.mark.parametrize("sample", SAMPLING, ids=["fp32_sampling",
                                                  "bf16_sampling"])
def test_bf16_train_step_grads_match_jax(setup, sample):
    """One train step's parameter gradients: fp32 and finite, and each
    within FACTOR x the JAX package's own bf16-to-fp32 distance (relative
    L2) of the JAX bf16 gradient."""
    xs, gt, _, _, flat = setup
    port = _port(flat, "bfloat16", sample, True)
    g_bf = state_dict_from_jax_tree(_jax_grads(_jax("bfloat16", sample),
                                               setup), port)
    g_32 = state_dict_from_jax_tree(_jax_grads(_jax(None, None), setup),
                                    port)
    y = port([_nchw(a) for a in xs])
    (y - _nchw(gt)).square().mean().backward()
    worst = 0.0
    for name, q in port.named_parameters():
        assert q.grad is not None and q.grad.dtype == torch.float32, name
        assert bool(torch.isfinite(q.grad).all()), name
        got, ref, ref32 = (t.double() for t in (q.grad, g_bf[name],
                                                g_32[name]))
        d_port = float((got - ref).norm() / max(float(ref.norm()), 1e-30))
        d_jax = float((ref - ref32).norm() / max(float(ref32.norm()), 1e-30))
        assert d_port <= FACTOR * d_jax + 1e-6, (name, d_port, d_jax)
        worst = max(worst, d_port / max(d_jax, 1e-30))
    print(f"bf16 gradients (sampling {sample}): the largest port/JAX "
          f"distance over JAX's own bf16/fp32 distance {worst:.3f}")
    for name, buf in port.named_buffers():
        assert buf.dtype in (torch.float32, torch.int64), name


def test_bf16_dtype_split(setup):
    """The stems through conv0 and the Generator run in bf16; the deform
    conv's inputs (the DEM, the affinity, the offsets) and the output are
    fp32; the parameters stay fp32."""
    xs, _, _, _, flat = setup
    model = _port(flat, "bfloat16", None, True)
    seen = {}

    def hook(name):
        def record(module, args, out):
            seen[name] = (tuple(a.dtype for a in args[0])
                          if isinstance(args[0], list)
                          else tuple(a.dtype for a in args),
                          tuple(o.dtype for o in out)
                          if isinstance(out, tuple) else (out.dtype,))
        return record

    for name in ("conv_dem", "conv_img", "conv_aux", "layer1_dem",
                 "layer4_aux", "guide4", "layer3d", "layer1d", "conv0",
                 "generator", "postprocessor"):
        getattr(model, name).register_forward_hook(hook(name))
    out = model([_nchw(a) for a in xs])
    bf16, fp32 = torch.bfloat16, torch.float32
    for name in ("conv_dem", "conv_img", "conv_aux", "layer1_dem",
                 "layer4_aux", "guide4", "layer3d", "layer1d", "conv0"):
        assert seen[name][1] == (bf16,), (name, seen[name])
    assert seen["conv_dem"][0] == (bf16,)
    assert seen["generator"] == ((bf16, bf16), (bf16, bf16))
    assert seen["postprocessor"] == ((fp32, fp32, fp32), (fp32,))
    assert out.dtype == fp32
    assert all(q.dtype == fp32 for q in model.parameters())


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values (8 significant bits) at |v|."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0**-126))) - 7)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bf16_batchnorm_matches_jax(train):
    """The port's BatchNorm2d on a bf16 input against the JAX package's
    (fp32 statistics, then ``(x - mean) * inv + bias`` with each operand
    rounded to bf16), within one bf16 ulp, and its running statistics at
    rtol 1e-5 (the JAX statistics in their two-pass form, as the port
    takes them; its default single pass, E[x^2] - E[x]^2, cancels at
    these means). The channels' means lie far from 0 beside their spreads, so
    where the mean is rounded shows: ``F.batch_norm``, which normalises in
    fp32 and rounds once, misses the same bound."""
    rng = np.random.default_rng(3)
    c = 8
    x = (rng.normal(0, 1, (2, 16, 16, c)) * rng.uniform(0.05, 0.5, c)
         + rng.uniform(-4, 4, c)).astype(np.float32)
    scale, bias, mean = (rng.uniform(lo, hi, c).astype(np.float32)
                         for lo, hi in ((0.5, 2), (-1, 1), (-4, 4)))
    var = rng.uniform(0.01, 0.3, c).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    single_pass = jax_layers._BN_SINGLE_PASS
    set_bn_single_pass(False)  # the port's two-pass statistics
    try:
        ref, state = JaxBatchNorm2d(c)(
            {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
            {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}, xj,
            train=train)
    finally:
        set_bn_single_pass(single_pass)
    ref = np.asarray(ref.astype(jnp.float32)).transpose(0, 3, 1, 2)
    xt = _nchw(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)
    bn = BatchNorm2d(c).train(train)
    with torch.no_grad():
        for buf, a in ((bn.weight, scale), (bn.bias, bias),
                       (bn.running_mean, mean), (bn.running_var, var)):
            buf.copy_(torch.from_numpy(a))
        got = bn(xt)
        single = torch.nn.functional.batch_norm(
            xt, torch.from_numpy(mean.copy()), torch.from_numpy(var.copy()),
            torch.from_numpy(scale), torch.from_numpy(bias), training=train)
    assert got.dtype == torch.bfloat16
    ulp = _bf16_ulp(ref)
    err = np.abs(got.float().numpy() - ref)
    off = np.abs(single.float().numpy() - ref) > ulp
    print(f"bf16 BatchNorm ({'train' if train else 'eval'}): port vs JAX "
          f"{(err / ulp).max():.3g} ulp; F.batch_norm more than an ulp off "
          f"at {off.sum()} of {off.size}")
    assert (err <= ulp).all()
    assert off.any()
    if train:
        for buf, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
            np.testing.assert_allclose(buf.numpy(), np.asarray(state[key]),
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("sample", SAMPLING, ids=["fp32_sampling",
                                                  "bf16_sampling"])
def test_bf16_close_to_port_fp32(setup, sample):
    """The port's bf16 model against its fp32 model on the smooth input:
    the JAX test's bounds (max < 0.1, mean < 0.02)."""
    xs, _, _, _, flat = setup
    inputs = [_nchw(a) for a in xs]
    with torch.no_grad():
        y32 = _port(flat, None, None, False)(inputs)
        ybf = _port(flat, "bfloat16", sample, False)(inputs)
    diff = (y32 - ybf).abs()
    assert float(diff.max()) < 0.1 and float(diff.mean()) < 0.02
    assert float(diff.max()) > 0  # the body really ran in bf16


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("DFC30_8m")
    return generate_mini_dfc30(root, train_cities=("Brest", "Caen"),
                               valid_cities=("Vannes",), n_per_city=2,
                               size=128)


@pytest.mark.parametrize("sample", SAMPLING, ids=["fp32_sampling",
                                                  "bf16_sampling"])
def test_shipped_bf16_config_fits_on_the_cpu(tree, tmp_path, sample):
    """configs/jspsr_r8_img_msk_bf16.yml as shipped (device_normalize,
    pack_mask, device_cache, compute_dtype bfloat16), on a tree of 4 train
    and 2 valid samples of 128^2 (the config's tile crop keeps them
    whole), cut to num_feature 8, one block, batch 2 and one epoch: the
    Trainer builds, keeps the split on the device, and fits with its
    initial eval."""
    root, train, valid = tree
    p = create_config("configs/jspsr_r8_img_msk_bf16.yml")
    p.dataset_path, p.train_set, p.valid_set = str(root), train, valid
    p.train_batch_size, p.epochs, p.workers = 2, 1, 1
    p.model_kwargs.update(num_feature=8, num_block=1,
                          spn_sample_dtype=sample)
    p.verbose = False
    t = Trainer(p, result_dir=tmp_path, device="cpu")
    assert t.scene_cache is not None and t.device_normalize
    assert t.model.compute_dtype == torch.bfloat16
    assert t.model.postprocessor.sample_dtype == sample
    out = t.fit()
    scores = {k: v for k, v in out["result"].items() if k != "input"}
    assert np.isfinite(list(scores.values())).all()
    assert np.isfinite(t.last_epoch_losses["Total"])
