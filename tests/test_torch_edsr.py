"""EDSR in the PyTorch port (jspsr_torch/models/edsr.py) against the JAX
package's (jspsr_tpu/models/edsr.py): the model with and without the SPN
head, the ``Upscaler``, the shipped configs' keys and parameter counts, and
one train step.

The port's weights are carried into JAX with ``import_torch_state_dict``
(the ``Upscaler`` at scale 4, whose second conv that importer does not
map, the other way, with the port's bridge); the same seeded numpy inputs
go through both. Tolerance: rtol 1e-4 / atol 2e-5, the JAX suite's
whole-model tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jspsr_tpu.config.loader import AttrDict as JaxAttrDict
from jspsr_tpu.config.loader import create_config as jax_create_config
from jspsr_tpu.losses import build_criterion as jax_build_criterion
from jspsr_tpu.models import edsr as J
from jspsr_tpu.models.factory import build_model as jax_build_model
from jspsr_tpu.train import optim as jax_optim
from jspsr_tpu.train.state import TrainState
from jspsr_tpu.train.step import make_train_step as jax_make_train_step
from jspsr_tpu.utils.torch_import import expected_torch_keys
from jspsr_torch.config.loader import AttrDict, create_config
from jspsr_torch.losses import build_criterion
from jspsr_torch.models import edsr as E
from jspsr_torch.models.factory import build_model
from jspsr_torch.ops import deform_cuda
from jspsr_torch.train import optim
from jspsr_torch.train.step import make_train_step
from jspsr_torch.utils.perturb import perturb_weights
from jspsr_torch.utils.weights import state_dict_from_jax_tree
from tests.test_torch_train import (  # noqa: F401 (bn_two_pass: a fixture)
    LR,
    _check_step,
    _nchw,
    _resync,
    _to_jax,
    bn_two_pass,
)

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 2e-5
# lr_dem + RGB, stacked; 2 blocks x 16 features
NARROW = {"in_channels": 4, "out_channels": 1, "n_resblocks": 2,
          "n_features": 16}
LOSS = {"L1": 1, "L2": 1, "Grad": 0.1}


def _pair(spn, seed=1):
    port = perturb_weights(E.EDSR(**NARROW, spn=spn,
                                  generator=torch.Generator().manual_seed(
                                      seed)), seed=2)
    return port, J.EDSR(**NARROW, spn=spn)


def _nhwc(x):
    return jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 3, 1)))


@pytest.mark.parametrize("spn", [False, True], ids=["head", "spn"])
def test_edsr_matches_jax_in_eval(spn):
    """The narrow EDSR in eval, given the inputs as a list (the DEM first)
    and stacked; with ``spn`` its SPN head on the detached DEM."""
    rng = np.random.default_rng(int(spn))
    port, jmodel = _pair(spn)
    port.eval()
    assert [k for k in port.state_dict()
            if not k.endswith("num_batches_tracked")] \
        == expected_torch_keys(jmodel)
    params, state = _to_jax(jmodel, port.state_dict())
    x = rng.uniform(0.05, 0.95, (2, 4, 32, 40)).astype(np.float32)
    want, _ = jmodel(params, state, _nhwc(x), train=False)
    want = np.asarray(want).transpose(0, 3, 1, 2)
    with torch.no_grad():
        stacked = port(torch.from_numpy(x))
        listed = port([torch.from_numpy(x[:, :1]), torch.from_numpy(x[:, 1:])])
    torch.testing.assert_close(listed, stacked, rtol=0, atol=0)
    np.testing.assert_allclose(stacked.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("scale", [2, 4])
def test_upscaler_matches_jax(scale):
    """conv + PixelShuffle(2) (twice at scale 4), keys ``0`` (and ``2``).
    The JAX importer maps only the first conv, so scale 4 goes JAX -> port
    through the port's bridge."""
    rng = np.random.default_rng(scale)
    port, jmod = E.Upscaler(8, scale), J.Upscaler(8, scale)
    x = rng.uniform(-1, 1, (2, 8, 6, 10)).astype(np.float32)
    if scale == 2:
        assert list(port.state_dict()) == expected_torch_keys(jmod)
        params, _ = _to_jax(jmod, port.state_dict())
    else:
        params, _ = jmod.init(jax.random.PRNGKey(0))
        port.load_state_dict(state_dict_from_jax_tree(params, port),
                             strict=True)
        assert list(port.state_dict()) == ["0.weight", "0.bias", "2.weight",
                                           "2.bias"]
    want, _ = jmod(params, {}, _nhwc(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, 8, 6 * scale, 10 * scale)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("spn,keys,count", [(False, 70, 1_221_569),
                                            (True, 94, 1_778_659)],
                         ids=["shipped", "spn"])
def test_shipped_config_keys_and_parameters(spn, keys, count):
    """configs/edsr_r8_img.yml (16 blocks x 64 features), as shipped and
    with ``spn: true``: the JAX package's parameter counts and its
    importer's keys, in order."""
    p = create_config("configs/edsr_r8_img.yml")
    jp = jax_create_config("configs/edsr_r8_img.yml")
    p.model_kwargs.spn = jp.model_kwargs.spn = spn
    port = build_model(p)
    names = [k for k in port.state_dict()
             if not k.endswith("num_batches_tracked")]
    assert names == expected_torch_keys(jax_build_model(jp))
    assert len(names) == keys
    assert sum(q.numel() for q in port.parameters()) == count


def test_init_is_the_reference_scheme():
    """EDSR's own convs: normal, std sqrt(2 / (k*k*out_channels)), zero
    bias; the SPN head's: the JSPSR truncated normal."""
    port = E.EDSR(in_channels=4, out_channels=1, n_resblocks=16,
                  n_features=64, spn=True)
    w = port.encoder[3].body[0].weight.detach()
    np.testing.assert_allclose(float(w.std()), (2.0 / (9 * 64)) ** 0.5,
                               rtol=0.02)
    assert not port.encoder[3].body[0].bias.any()
    g = port.generator.convf1.conv[0].weight.detach()
    assert float(g.abs().max()) <= 2 * (2.6 / g[0].numel()) ** 0.5


def test_train_step_matches_jax(bn_two_pass):
    """One train step of EDSR with the SPN head at batch 4 (32²) from the
    same state, by the rule of ``tests/test_torch_train.py``: losses,
    gradients (AdamW's moments), the update, the BatchNorm statistics of
    the head's block. On the CPU the deform op runs its plain version."""
    rng = np.random.default_rng(9)
    port, jmodel = _pair(spn=True, seed=3)
    port.train()
    cfg = {"optimizer": "AdamW", "optimizer_kwargs": {
        "lr": LR, "weight_decay": 1e-6, "momentum": 0.9, "diff_lr": False}}
    opt = optim.build_optimizer(AttrDict(cfg), port)
    step = make_train_step(port, build_criterion(LOSS), opt)
    params, bn = _to_jax(jmodel, port.state_dict())
    jopt = jax_optim.build_optimizer(JaxAttrDict(cfg), params)
    jstep = jax_make_train_step(jmodel, jax_build_criterion(LOSS), jopt,
                                donate=False)
    state = _resync(port, jmodel, opt, TrainState(
        params, bn, jopt.init(params), jnp.zeros((), jnp.int32)))
    x = rng.uniform(0.05, 0.95, (4, 32, 32, 4)).astype(np.float32)
    gt = rng.uniform(0.05, 0.95, (4, 32, 32, 1)).astype(np.float32)
    before = {n: q.detach().clone() for n, q in port.named_parameters()}
    launches = dict(deform_cuda.LAUNCHES)
    losses = step([_nchw(x)], _nchw(gt))
    assert deform_cuda.LAUNCHES == launches  # CPU: plain deform versions
    state, jlosses = jstep(state, [jnp.asarray(x)], jnp.asarray(gt))
    _check_step(port, opt, before, state, losses, jlosses)
