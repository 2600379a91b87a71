"""CompletionFormer in the PyTorch port vs the JAX package, on the CPU.

The same weights (the port's state_dict carried into JAX by
``import_torch_state_dict``) and the same numpy inputs go through both:

- units at small widths: SpatialAttention, CBAMBasicBlock, LBasicBlock
  with LDownsample, Attention (spatial reduction 8 and 1), PVTBlock in
  training with the drop-path masks JAX draws, PatchEmbed, the position
  resize, a shallow PVT, and NLSPN for every affinity with the confidence
  on and off, from a non-zero offset/affinity conv (at its zero init the
  offsets and affinities are 0 and the propagation is the identity);
- the whole model at its fixed widths (83,689,176 parameters): the weight
  bridge, the eval forward at 1 x 64² with 18 guidance channels at the JAX
  suite's CompletionFormer tolerance (rtol 1e-3 / atol 1e-4,
  tests/test_parity_completionformer.py), one 44 x 52 scene through
  whole-scene inference from a JAX ``.npz`` checkpoint (padded to the
  backbone's /32), and one train step at 2 x 64².

The JAX parameters come from the port's weights, not from ``model.init``
(37 s for the whole model here), and the whole model is built once per
module.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import yaml

from jspsr_tpu import nn as jax_nn
from jspsr_tpu.eval.inference import upscale_dem as jax_upscale_dem
from jspsr_tpu.losses import build_criterion as jax_build_criterion
from jspsr_tpu.models import components as JC
from jspsr_tpu.models import lrru as JL
from jspsr_tpu.models import pvt as JP
from jspsr_tpu.models.completionformer import CompletionFormer as JaxCF
from jspsr_tpu.models.nlspn import NLSPN as JaxNLSPN
from jspsr_tpu.nn.module import param_count
from jspsr_tpu.train.checkpoint import save_checkpoint
from jspsr_tpu.train.step import make_forward as jax_make_forward
from jspsr_tpu.utils.torch_import import (
    expected_torch_keys,
    import_torch_state_dict,
)
from jspsr_torch.config.loader import AttrDict, create_config
from jspsr_torch.data.raster_io import read_raster, write_raster
from jspsr_torch.eval.inference import (
    load_scene,
    make_forward,
    run_scene_inference,
    upscale_dem,
)
from jspsr_torch.losses import build_criterion
from jspsr_torch.models import components as C
from jspsr_torch.models import pvt as P
from jspsr_torch.models.completionformer import CompletionFormer
from jspsr_torch.models.factory import build_model
from jspsr_torch.models.lrru import LBasicBlock, LDownsample
from jspsr_torch.models.nlspn import NLSPN
from jspsr_torch.nn import bilinear_resize, init_weights
from jspsr_torch.ops import deform_cuda
from jspsr_torch.train.checkpoint import load_model_params
from jspsr_torch.utils.perturb import perturb_weights
from jspsr_torch.utils.weights import state_dict_from_jax, \
    state_dict_from_jax_tree

torch.set_num_threads(4)

CONFIG = Path(__file__).resolve().parents[1] / "configs" \
    / "completionformer_r8_img_msk.yml"
FLAGSHIP = {"lr_dem": 1, "image": 3, "mask": 15}
LOSS = {"L1": 1, "L2": 1, "Grad": 0.1}
N_PARAMS = 83_689_176
TOL = dict(rtol=1e-4, atol=2e-5)  # units: the whole-model JSPSR tolerance


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _to_jax(jax_module, port):
    """(params, state) of ``jax_module`` from the port module's weights;
    copies, as jnp.asarray may alias the numpy view of a torch tensor."""
    return import_torch_state_dict(
        jax_module, {k: v.detach().numpy().copy()
                     for k, v in port.state_dict().items()})


def _perturb(model, seed, affine=True):
    """``perturb_weights``, by default with the BatchNorm affines, so the
    propagation, its normalisation and the input gradient all do work. The
    whole model keeps its BatchNorm affines: random scales over its
    100-odd BatchNorms put its output near +-150, where the 1e-4 absolute
    tolerance would be fp32 rounding."""
    return perturb_weights(model, seed, affine=affine)


def _rel_err(got, ref):
    """Relative L2 error of one tensor (absolute where ``ref`` is 0)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-12))


def _drop_path_keeps(key, depths, batch, rate=0.1):
    """The keep masks the JAX PVT draws in training: block j of stage i
    uses ``bernoulli(fold_in(key, i*100 + j), 1 - rate_ij, (B, 1, 1))`` for
    both of its residual branches; blocks at rate 0 draw none."""
    rates = [float(v) for v in jnp.linspace(0, rate, sum(depths))]
    keeps, cur = {}, 0
    for i, depth in enumerate(depths):
        for j in range(depth):
            if rates[cur + j] > 0:
                m = jax.random.bernoulli(jax.random.fold_in(key, i * 100 + j),
                                         1.0 - rates[cur + j], (batch, 1, 1))
                keeps[(i, j)] = torch.from_numpy(np.asarray(m, np.float32))
        cur += depth
    return keeps


def _feed_keeps(pvt, keeps):
    """Make the port's PVT use the given keep masks instead of drawing."""
    pvt.drop_path_keep = lambda i, j, b, generator: keeps.get((i, j))


# ------------------------------------------------------------------ units

def test_spatial_attention_matches_jax():
    port = C.SpatialAttention()
    torch.nn.init.normal_(port.conv1.weight, 0, 0.3,
                          generator=torch.Generator().manual_seed(0))
    params, _ = _to_jax(JC.SpatialAttention(), port)
    x = np.random.default_rng(0).normal(size=(2, 9, 11, 16)).astype(
        np.float32)
    ref, _ = JC.SpatialAttention()(params, {}, jnp.asarray(x))
    with torch.no_grad():
        got = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_cbam_basic_block_matches_jax(train):
    port = _perturb(C.CBAMBasicBlock(32, 32, ratio=4), seed=1)
    jmod = JC.CBAMBasicBlock(32, 32, ratio=4)
    params, state = _to_jax(jmod, port)
    x = np.random.default_rng(1).normal(size=(2, 10, 12, 32)).astype(
        np.float32)
    ref, new_state = jmod(params, state, jnp.asarray(x), train=train)
    port.train(train)
    got = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(got.detach()), np.asarray(ref), **TOL)
    if train:
        np.testing.assert_allclose(port.bn2.running_var.numpy(),
                                   np.asarray(new_state["bn2"]["var"]),
                                   rtol=1e-5)


def test_lbasic_block_with_ldownsample_matches_jax():
    port = _perturb(LBasicBlock(16, 32, 2, LDownsample(16, 32, 2)), seed=2)
    jmod = JL.LBasicBlock(16, 32, 2, JL.LDownsample(16, 32, 2))
    params, state = _to_jax(jmod, port)
    x = np.random.default_rng(2).normal(size=(2, 12, 16, 16)).astype(
        np.float32)
    ref, new_state = jmod(params, state, jnp.asarray(x), train=True)
    got = port.train()(_nchw(x))
    np.testing.assert_allclose(_nhwc(got.detach()), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        port.downsample[1].running_mean.numpy(),
        np.asarray(new_state["downsample"]["bn"]["mean"]), rtol=1e-5,
        atol=1e-7)


@pytest.mark.parametrize("sr", [8, 1])
def test_attention_matches_jax(sr):
    torch.manual_seed(3)  # torch's default init: non-zero biases
    port = P.Attention(32, num_heads=2, qkv_bias=True, sr_ratio=sr)
    params, _ = _to_jax(JP.Attention(32, 2, True, sr), port)
    h, w = 16, 24
    x = np.random.default_rng(3).normal(size=(2, h * w, 32)).astype(
        np.float32)
    ref, _ = JP.Attention(32, 2, True, sr)(params, {}, jnp.asarray(x), h, w)
    with torch.no_grad():
        got = port(torch.from_numpy(x), h, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_pvt_block_in_training_matches_jax_with_its_masks():
    """Drop path at rate 0.5 with JAX's keep mask, one mask for both
    residual branches; the CBAM branch and the concat-conv fusion."""
    port = _perturb(P.PVTBlock(32, 2, 4.0, True, drop_path=0.5, sr_ratio=2),
                    seed=4)
    jmod = JP.PVTBlock(32, 2, 4.0, True, drop_path=0.5, sr_ratio=2)
    params, state = _to_jax(jmod, port)
    h, w = 8, 12
    x = np.random.default_rng(4).normal(size=(4, h * w, 32)).astype(
        np.float32)
    key = jax.random.PRNGKey(11)
    keep = jax.random.bernoulli(key, 0.5, (4, 1, 1))
    assert 0 < int(keep.sum()) < 4  # one sample dropped, one kept at least
    with torch.no_grad():  # eval first: training updates the statistics
        ref, _ = jmod(params, state, jnp.asarray(x), h, w, train=False)
        got = port.eval()(torch.from_numpy(x), h, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    ref, _ = jmod(params, state, jnp.asarray(x), h, w, train=True, rng=key)
    got = port.train()(torch.from_numpy(x), h, w,
                       keep=torch.from_numpy(np.asarray(keep, np.float32)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("size", [(112, 112, 32, 32), (7, 7, 4, 4),
                                  (8, 12, 16, 24), (5, 9, 5, 9)],
                         ids=["112to32", "7to4", "up", "same"])
def test_bilinear_resize_matches_jax(size, align_corners):
    """The position-embedding resize shrinks 112² to 32² (stage 1 at 128²
    tiles): torch's non-antialiased bilinear, as the JAX package's matrix
    form reproduces it."""
    h, w, oh, ow = size
    x = np.random.default_rng(h * w).normal(size=(1, h, w, 16)).astype(
        np.float32)
    ref = jax_nn.bilinear_resize(jnp.asarray(x), oh, ow,
                                 align_corners=align_corners)
    got = bilinear_resize(_nchw(x), oh, ow, align_corners=align_corners)
    # torch computes the align-corners source coordinate i·(in-1)/(out-1)
    # in fp32, the JAX package's matrix in float64: 1e-5 of the range
    # apart at 112 -> 32 (the decoder resizes only between equal sizes)
    atol = 1e-4 if align_corners else 1e-6
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-5,
                               atol=atol)


def test_patch_embed_matches_jax():
    torch.manual_seed(5)
    port = P.PatchEmbed(224, 2, 16, 32)
    jmod = JP.PatchEmbed(224, 2, 16, 32)
    params, _ = _to_jax(jmod, port)
    x = np.random.default_rng(5).normal(size=(2, 24, 20, 16)).astype(
        np.float32)
    (ref, hw), _ = jmod(params, {}, jnp.asarray(x))
    with torch.no_grad():
        got, got_hw = port(_nchw(x))
    assert got_hw == hw == (12, 10) and port.grid == jmod.grid == (112, 112)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_shallow_pvt_matches_jax(train):
    """One block per stage at narrow widths, the real embedding layers, the
    pos-embed resizes (stage 1's 112² grid to 16², stage 4's first token
    dropped), and in training the drop-path masks JAX draws."""
    kw = dict(embed_dims=(16, 32, 80, 128), depths=(1, 1, 1, 1))
    port = P.PVT(in_chans=128, patch_size=2, **kw)
    init_weights(port, torch.Generator().manual_seed(6))
    _perturb(port, seed=6)
    jmod = JP.PVT(in_chans=128, patch_size=2, **kw)
    params, state = _to_jax(jmod, port)
    x = np.random.default_rng(6).normal(size=(2, 64, 64, 64)).astype(
        np.float32)
    key = jax.random.PRNGKey(12) if train else None
    refs = jax.jit(lambda p, s, x: jmod(p, s, x, train=train, rng=key)[0])(
        params, state, jnp.asarray(x))
    port.train(train)
    if train:
        _feed_keeps(port, _drop_path_keeps(key, (1, 1, 1, 1), 2))
    with torch.no_grad():
        gots = port(_nchw(x))
    assert [tuple(g.shape[2:]) for g in gots] == [(64, 64), (32, 32),
                                                 (16, 16), (8, 8), (4, 4),
                                                 (2, 2)]
    for i, (got, ref) in enumerate(zip(gots, refs)):
        np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4, err_msg=f"fe{i + 2}")


NLSPN_CASES = [(aff, conf) for aff in ("AS", "ASS", "TC", "TGASS")
               for conf in (True, False)] + [("TGASS", "preserve")]


@pytest.mark.parametrize("affinity,conf", NLSPN_CASES,
                         ids=[f"{a}-{'conf' if c is True else c or 'noconf'}"
                              for a, c in NLSPN_CASES])
def test_nlspn_matches_jax(affinity, conf):
    """Outputs (feature, offsets, affinities) and the gradients to the
    initial feature, the guidance, the confidence, the offset/affinity conv
    and ``aff_scale_const``, from a non-zero offset/affinity conv."""
    preserve = conf == "preserve"
    conf_prop = bool(conf)
    port = _perturb(NLSPN(8, 1, 3, 3, 3, affinity, 0.5, conf_prop, preserve),
                    seed=7)
    jmod = JaxNLSPN(8, 1, 3, 3, 3, affinity, 0.5, conf_prop, preserve)
    params, _ = _to_jax(jmod, port)
    rng = np.random.default_rng(7)
    b, h, w = 2, 12, 16
    feat = rng.uniform(0.1, 0.9, (b, h, w, 1)).astype(np.float32)
    guide = rng.normal(size=(b, h, w, 8)).astype(np.float32)
    confidence = rng.uniform(0, 1, (b, h, w, 1)).astype(np.float32)
    fix = (rng.uniform(0, 1, (b, h, w, 1)) > 0.7) * feat
    cot = rng.normal(size=(b, h, w, 1)).astype(np.float32)

    def jax_loss(params, feat, guide, confidence):
        (y, off, aff), _ = jmod(params, {}, feat, guide, confidence,
                                jnp.asarray(fix, jnp.float32))
        return jnp.sum(y * jnp.asarray(cot)), (y, off, aff)

    (_, (y, off, aff)), grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        params, jnp.asarray(feat), jnp.asarray(guide), jnp.asarray(confidence))

    leaves = [_nchw(a).requires_grad_(True) for a in (feat, guide, confidence)]
    got = port(*leaves, _nchw(fix.astype(np.float32)))
    (got[0] * _nchw(cot)).sum().backward()
    for name, a, r in zip(("feat", "offset", "affinity"), got, (y, off, aff)):
        np.testing.assert_allclose(_nhwc(a), np.asarray(r), **TOL,
                                   err_msg=name)
    assert np.abs(np.asarray(off)).max() > 0.1
    for name, t, r in zip(("d_feat", "d_guidance", "d_confidence"), leaves,
                          grads[1:]):
        if t.grad is None:  # the confidence, unused without conf_prop
            assert not conf_prop and not np.abs(np.asarray(r)).max(), name
            continue
        np.testing.assert_allclose(_nhwc(t.grad), np.asarray(r), rtol=1e-3,
                                   atol=1e-4, err_msg=name)
    pgrads = state_dict_from_jax_tree(grads[0], port)
    for name, p in port.named_parameters():
        if p.grad is None:  # frozen kernels; the scale AS/ASS do not use
            assert not pgrads[name].abs().max(), name
        elif name == "aff_scale_const":
            # with TGASS and no confidence most pixels' affinity sums clamp
            # at 1, where the scale cancels: its gradient is then a sum of
            # cancelling terms (2.6e-5 here, float64 agrees)
            np.testing.assert_allclose(p.grad.numpy(), pgrads[name].numpy(),
                                       rtol=1e-3, atol=1e-6)
        else:
            assert _rel_err(p.grad.numpy(), pgrads[name].numpy()) < 1e-3, name


# ------------------------------------------------------------ whole model

@pytest.fixture(scope="module")
def whole():
    """The config's CompletionFormer at its fixed widths, seeded, with
    perturbed BatchNorm and offset/affinity conv, and its JAX twin."""
    port = _perturb(CompletionFormer(dict(FLAGSHIP), generator=torch.Generator()
                                     .manual_seed(0)), seed=8, affine=False)
    jmod = JaxCF(dict(FLAGSHIP))
    params, state = _to_jax(jmod, port)
    return port, jmod, params, state


def test_bridge_keys_count_and_round_trip(whole):
    """The port's keys are the importer's (as a set: torch lists a module's
    own parameters before its children's, the importer in definition
    order), the parameter count is the JAX package's, and JAX -> port ->
    JAX is the identity, decided by the module tree (the decoder's
    transposed convs sit at ``dec*.0.0``, where no name pattern marks
    them)."""
    port, jmod, params, state = whole
    keys = [k for k in port.state_dict()
            if not k.endswith("num_batches_tracked")]
    want = expected_torch_keys(jmod)
    assert sorted(keys) == sorted(want) and len(keys) == len(want)
    assert sum(p.numel() for p in port.parameters()) == N_PARAMS \
        == param_count(params)
    flat = {f"params/{k}": np.asarray(v) for k, v in _flatten(params).items()}
    flat.update({f"bn/{k}": np.asarray(v) for k, v in _flatten(state).items()})
    sd = state_dict_from_jax(flat, port)
    for k, v in port.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(sd[k], v, rtol=0, atol=0, msg=k)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, path) if isinstance(v, dict) else {path: v})
    return out


def test_factory_builds_the_config_model(whole):
    p = AttrDict({"model_name": "CompletionFormer", "seed": 0,
                  "input_data": {"COP30": 1, "image": 3, "mask": 15},
                  "model_kwargs": {"prop_time": 6, "prop_kernel": 3,
                                   "conf_prop": True, "affinity": "TGASS",
                                   "affinity_gamma": 0.5}})
    model = build_model(p)
    assert sum(q.numel() for q in model.parameters()) == N_PARAMS
    # seeded by p.seed: the fixture's model, also drawn from seed 0
    assert torch.equal(model.backbone.former.pos_embed1,
                       whole[0].backbone.former.pos_embed1)
    assert not model.prop_layer.conv_offset_aff.weight.any()


def test_eval_forward_matches_jax(whole):
    port, jmod, params, state = whole
    rng = np.random.default_rng(9)
    dem = rng.uniform(0.1, 0.9, (1, 64, 64, 1)).astype(np.float32)
    guide = rng.uniform(0, 1, (1, 64, 64, 18)).astype(np.float32)
    fwd = jax.jit(lambda p, s, x: jmod(p, s, x, train=False)[0])
    ref = fwd(params, state, [jnp.asarray(dem), jnp.asarray(guide)])
    launches = dict(deform_cuda.LAUNCHES)
    with torch.inference_mode():
        got = port.eval()([_nchw(dem), _nchw(guide)])
    assert deform_cuda.LAUNCHES == launches  # CPU: plain deform versions
    assert got.shape == (1, 1, 64, 64)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-3,
                               atol=1e-4)


def test_scene_inference_from_npz_matches_jax(whole, tmp_path):
    """Serving: a 44 x 52 scene (DFC30 layout) padded to 64², the guidance
    stacked after the DEM, the port's weights read back from the JAX
    ``.npz`` checkpoint through the bridge (the decoder's transposed convs
    flipped by the module tree); the prediction against JAX's
    ``upscale_dem`` at rtol 1e-3 / atol 1e-4 and the descaled raster
    finite."""
    port, jmod, params, state = whole
    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[0:44, 0:52].astype(np.float32)
    dem = 120 + 40 * np.sin(xx / 9.0) * np.cos(yy / 7.0) \
        + rng.normal(0, 1.0, (44, 52))
    scene = tmp_path / "scene"
    write_raster(scene / "COP30" / "dem.npy", dem.astype(np.float32)[..., None])
    write_raster(scene / "BDORTHO" / "ortho.npy",
                 rng.integers(0, 256, (44, 52, 3)).astype(np.uint8))
    write_raster(scene / "UA2012" / "ua.npy", np.eye(15, dtype=np.uint8)[
        rng.integers(0, 15, (44, 52))])
    save_checkpoint(tmp_path / "cf.npz", params, state)
    # the shipped config, its checkpoint the JAX .npz
    cfg = yaml.safe_load(CONFIG.read_text())
    cfg["model_kwargs"]["checkpoint"] = str(tmp_path / "cf.npz")
    (tmp_path / "cf.yml").write_text(yaml.safe_dump(cfg))
    p = create_config(tmp_path / "cf.yml")
    sample, _ = load_scene(scene, p)
    fwd = jax_make_forward(jmod)
    ref, _, _ = jax_upscale_dem(lambda x: fwd(params, state, x), sample, p)
    model = load_model_params(build_model(p), p.model_kwargs.checkpoint)
    got, _, _ = upscale_dem(make_forward(model), sample, p, device="cpu")
    assert got.shape == (44, 52, 1)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-3, atol=1e-4)
    path, _, _ = run_scene_inference(model, p, scene, tmp_path / "sr.npy",
                                     device="cpu")
    out = read_raster(path)
    assert out.shape == (44, 52, 1) and np.isfinite(out).all()


@pytest.fixture
def bn_two_pass():
    """JAX's two-pass batch variance, the arithmetic torch uses (see
    tests/test_torch_train.py)."""
    from jspsr_tpu.nn import layers

    layers.set_bn_single_pass(False)
    yield
    layers.set_bn_single_pass(True)


def test_train_step_matches_jax(whole, bn_two_pass):
    """One train-mode forward and backward at 2 x 64² (L1 + L2 + 0.1 Grad)
    with the drop-path masks JAX draws, from the same weights:

    - the loss within rtol 1e-5;
    - every gradient within 5e-2 relative L2 of JAX's, per tensor. Here the
      two packages' fp32 gradients differ by up to 1.2 % per tensor (median
      0.03 %), and both are up to 4.5 % from float64 (the PVT's CBAM
      branches, at 2 x 64²): the step is ill-conditioned in fp32 in either
      package. A wrong term or path shows as an error of order 1;
      ``aff_scale_const`` (the TGASS scale, trainable) within 1e-4;
    - the BatchNorm running statistics within rtol 1e-4."""
    port, jmod, params, state = whole
    port = copy.deepcopy(port).train()
    rng = np.random.default_rng(10)
    dem = rng.uniform(0.2, 0.8, (2, 64, 64, 1)).astype(np.float32)
    guide = rng.uniform(0, 1, (2, 64, 64, 18)).astype(np.float32)
    gt = (dem + rng.normal(0, 0.02, dem.shape)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    crit = jax_build_criterion(dict(LOSS))

    def loss_fn(params, state, inputs, gt):
        pred, new_state = jmod(params, state, inputs, train=True, rng=key)
        return crit(pred, gt)["Total"], new_state

    (jloss, jstate), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, state,
                                [jnp.asarray(dem), jnp.asarray(guide)],
                                jnp.asarray(gt))
    keeps = _drop_path_keeps(key, (3, 4, 6, 3), 2)
    assert any(not k.all() for k in keeps.values())  # some sample dropped
    _feed_keeps(port.backbone.former, keeps)
    loss = build_criterion(dict(LOSS))(
        port([_nchw(dem), _nchw(guide)]), _nchw(gt))["Total"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)

    want = state_dict_from_jax_tree(jgrads, port)
    for name, p in port.named_parameters():
        if not p.requires_grad:
            assert p.grad is None and not want[name].abs().max(), name
            continue
        tol = 1e-4 if name.endswith("aff_scale_const") else 5e-2
        assert _rel_err(p.grad.numpy(), want[name].numpy()) < tol, name
    assert port.prop_layer.aff_scale_const.grad.abs().item() > 0
    bufs = dict(port.named_buffers())
    for name, v in state_dict_from_jax_tree(jstate, port, "bn").items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(bufs[name].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)
