"""Eval forward of the PyTorch port's JSPSR vs the JAX package.

The same weights (port state_dict -> the JAX package's importer) and the
same numpy inputs go through both; outputs agree at the JAX suite's
whole-model tolerance (tests/test_parity_jspsr.py). The SPN Generator and
PostProcessor, the modules around the deform kernel, are checked alone.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from jspsr_tpu.models.jspsr import JSPSR as JaxJSPSR
from jspsr_tpu.models.spn import Generator as JaxGenerator
from jspsr_tpu.models.spn import PostProcessor as JaxPostProcessor
from jspsr_tpu.utils.torch_import import import_torch_state_dict
from jspsr_torch.config.loader import AttrDict
from jspsr_torch.models.factory import build_model
from jspsr_torch.models.jspsr import JSPSR
from jspsr_torch.models.spn import Generator, PostProcessor

torch.set_num_threads(2)

# the branch sets of tests/test_parity_jspsr.py, the flagship first, then
# the flagship with the head and fusion options the slice also serves
CASES = [
    ({"lr_dem": 1, "image": 3, "mask": 15}, {}),
    ({"lr_dem": 1, "image": 3}, {}),
    ({"lr_dem": 1, "mask": 15}, {}),
    ({"lr_dem": 1, "image": 3, "canopy": 1}, {}),
    ({"lr_dem": 1, "image": 3, "mask": 15}, {"spn": False}),
    ({"lr_dem": 1, "image": 3, "mask": 15}, {"cat_only": False}),
    ({"lr_dem": 1, "image": 3}, {"spn_scale": 0.5, "generator_leaky": True}),
]


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


def _jax_out(y):
    return np.asarray(y).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("in_channels,kw", CASES,
                         ids=["-".join(c) + "".join(f"-{k}" for k in kw)
                              for c, kw in CASES])
def test_jspsr_eval_forward_matches_jax(in_channels, kw):
    port = _perturb_bn(JSPSR(dict(in_channels), num_feature=8,
                             layers=(1, 1, 1, 1),
                             generator=torch.Generator().manual_seed(0),
                             **kw), seed=1).eval()
    jax_model = JaxJSPSR(dict(in_channels), num_feature=8,
                         layers=(1, 1, 1, 1), **kw)
    params, state = import_torch_state_dict(jax_model, port.state_dict())

    rng = np.random.default_rng(42)
    inputs = [rng.uniform(0.05, 0.95, size=(2, 32, 32, in_channels[k]))
              .astype(np.float32) for k in port.input_keys()]
    ref, _ = jax_model(params, state, [jnp.asarray(a) for a in inputs],
                       train=False)
    with torch.inference_mode():
        got = port([_nchw(a) for a in inputs])
    assert got.shape == (2, 1, 32, 32)
    np.testing.assert_allclose(got.numpy(), _jax_out(ref),
                               rtol=1e-4, atol=2e-5)


def test_generator_matches_jax():
    port = _perturb_bn(Generator(16, 3, bc=8), seed=2).eval()
    jax_gen = JaxGenerator(16, 3, bc=8)
    params, state = import_torch_state_dict(jax_gen, port.state_dict())
    rng = np.random.default_rng(3)
    dem = rng.uniform(0.2, 0.8, (2, 24, 20, 1)).astype(np.float32)
    ctx = rng.normal(size=(2, 24, 20, 16)).astype(np.float32)
    (w_ref, off_ref), _ = jax_gen(params, state, jnp.asarray(dem),
                                  jnp.asarray(ctx), train=False)
    with torch.inference_mode():
        w_got, off_got = port(_nchw(dem), _nchw(ctx))
    np.testing.assert_allclose(w_got.numpy(), _jax_out(w_ref),
                               rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(off_got.numpy(), _jax_out(off_ref),
                               rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_postprocessor_matches_jax(scale):
    rng = np.random.default_rng(4)
    port = PostProcessor(3, residual=True, scale=scale)
    with torch.no_grad():
        port.w.copy_(torch.from_numpy(
            rng.normal(1.0, 0.3, (1, 1, 3, 3)).astype(np.float32)))
        port.b.fill_(0.05)
    jax_pp = JaxPostProcessor(3, residual=True, scale=scale)
    params = {"w": jnp.asarray(port.w.detach().numpy().transpose(2, 3, 1, 0)),
              "b": jnp.asarray(port.b.detach().numpy())}
    dem = rng.uniform(0.2, 0.8, (2, 20, 28, 1)).astype(np.float32)
    aff = rng.uniform(0, 1, (2, 20, 28, 9)).astype(np.float32)
    off = rng.normal(0, 1.5, (2, 20, 28, 18)).astype(np.float32)
    ref, _ = jax_pp(params, {}, jnp.asarray(dem), jnp.asarray(aff),
                    jnp.asarray(off), train=False)
    with torch.inference_mode():
        got = port(_nchw(dem), _nchw(aff), _nchw(off))
    np.testing.assert_allclose(got.numpy(), _jax_out(ref),
                               rtol=1e-4, atol=2e-5)


# the options that raised until the mixed-precision slice ported them
PORTED = ("compute_dtype", "spn_sample_dtype")
# the execution options, which raised until the eleventh slice
EXECUTION = ("remat_stages", "fuse_stems", "eval_grouped")


@pytest.mark.parametrize("option", EXECUTION + PORTED)
def test_unported_options_raise(option):
    """Every option is ported: each builds and runs an eval forward with
    an fp32 output. ``compute_dtype`` and ``spn_sample_dtype``
    (tests/test_torch_bf16.py holds them against JAX) give a bf16 body or
    the bf16-sampling head; the execution options
    (tests/test_torch_jspsr_options.py, tests/test_torch_remat.py) set
    their flag."""
    value = "bfloat16" if option in PORTED else True
    cfg = AttrDict({"model_name": "JSPSR", "input_data": {"lr_dem": 1, "image": 3},
                    "model_kwargs": {"num_block": 1, "num_feature": 8,
                                     option: value}})
    model = build_model(cfg).eval()
    if option == "compute_dtype":
        assert model.compute_dtype == torch.bfloat16
    elif option == "spn_sample_dtype":
        assert model.postprocessor.sample_dtype == "bfloat16"
    else:
        assert getattr(model, option) is True
    rng = np.random.default_rng(5)
    inputs = [torch.from_numpy(rng.uniform(0.1, 0.9, (1, c, 16, 16))
                               .astype(np.float32)) for c in (1, 3)]
    with torch.inference_mode():
        out = model(inputs)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("name", ["EDSR", "LRRU", "CompletionFormer"])
def test_unported_models_raise(name):
    """The three families that raised until their slices landed now build
    (each one's forward and train step are held against JAX in
    tests/test_torch_{completionformer,edsr,lrru}.py); an unknown name
    still raises."""
    cfg = AttrDict({"model_name": name, "input_data": {"lr_dem": 1, "image": 3},
                    "model_kwargs": {"prop_time": 2}})
    model = build_model(cfg)
    if name == "CompletionFormer":
        assert model.input_keys() == ["lr_dem", "guidance"]
        assert model.prop_layer.prop_time == 2
    elif name == "LRRU":
        assert model.input_keys() == ["lr_dem", "image"]
    else:
        assert model.entry.in_channels == 4 and not model.spn
    with pytest.raises(NotImplementedError, match="Unsupported model"):
        build_model(AttrDict(dict(cfg, model_name=f"{name}x")))
