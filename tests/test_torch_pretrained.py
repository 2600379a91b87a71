"""Pretrained bootstraps of the PyTorch port (jspsr_torch/utils/pretrained.py)
against the JAX package's (jspsr_tpu/utils/pretrained.py).

Every file here is a state_dict the test writes itself; URLs are
``file://`` URLs. Both packages start from the same weights (the port's
init carried into JAX) and load the same file, so whatever a load leaves
at init is the same in both.
"""

import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jspsr_tpu.config.loader import AttrDict as JaxAttrDict
from jspsr_tpu.models.edsr import EDSR as JaxEDSR
from jspsr_tpu.models.pvt import PVT as JaxPVT
from jspsr_tpu.utils.pretrained import apply_pretrained as jax_apply_pretrained
from jspsr_tpu.utils.torch_import import import_torch_state_dict
from jspsr_torch.config.loader import AttrDict
from jspsr_torch.models.edsr import EDSR
from jspsr_torch.models.pvt import PVT
from jspsr_torch.utils.perturb import perturb_weights
from jspsr_torch.utils.pretrained import (
    apply_pretrained,
    load_matching,
    resolve_pretrained_path,
)
from jspsr_torch.utils.weights import state_dict_from_jax_tree

torch.set_num_threads(2)

EDSR_KW = {"in_channels": 4, "out_channels": 1, "n_resblocks": 2,
           "n_features": 8}


def _edsr(seed):
    return EDSR(**EDSR_KW, generator=torch.Generator().manual_seed(seed))


def _foreign(sd):
    """A public-checkpoint stand-in: the same tensors under names that
    share nothing with the model's (pairing must go by position)."""
    return {f"stage{i // 4}.block{i % 4}.param{i}": v.clone()
            for i, v in enumerate(sd.values())}


def _cfg(model_name, **mk):
    return {"model_name": model_name, "model_kwargs": mk}


def _jax_tree(jmodel, port):
    """The port's weights as the JAX package's (params, state)."""
    return import_torch_state_dict(
        jmodel, {k: v.detach().numpy().copy()
                 for k, v in port.state_dict().items()})


def _forward_edsr(port, params, state, x):
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    want, _ = JaxEDSR(**EDSR_KW)(params, state,
                                 jnp.asarray(x.transpose(0, 2, 3, 1)),
                                 train=False)
    return got, np.asarray(want).transpose(0, 3, 1, 2)


def test_positional_pretrained_matches_jax(tmp_path):
    """A foreign-named EDSR file with a head of another shape and a
    trailing extra tensor: both packages pair it by position, load what
    fits and keep the head at init; their forwards agree at rtol 1e-4 /
    atol 2e-5."""
    source = _edsr(seed=3).state_dict()
    foreign = _foreign(source)
    head = list(foreign)[-2]
    foreign[head] = torch.zeros(5, 8, 3, 3)
    foreign["tail.extra"] = torch.zeros(7)
    path = tmp_path / "edsr_foreign.pt"
    torch.save(foreign, path)

    port = _edsr(seed=0)
    head_init = port.head.weight.detach().clone()
    params, state = _jax_tree(JaxEDSR(**EDSR_KW), port)
    apply_pretrained(AttrDict(_cfg("EDSR", pretrained=str(path))), port)
    params, state = jax_apply_pretrained(
        JaxAttrDict(_cfg("EDSR", pretrained=str(path))), JaxEDSR(**EDSR_KW),
        params, state)
    torch.testing.assert_close(port.entry.weight.detach(),
                               source["entry.weight"], rtol=0, atol=0)
    torch.testing.assert_close(port.head.weight.detach(), head_init,
                               rtol=0, atol=0)
    x = np.random.default_rng(11).uniform(0, 1, (1, 4, 16, 16)).astype(
        np.float32)
    got, want = _forward_edsr(port, params, state, x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)


def test_pretrained_true_without_its_file_raises(tmp_path, monkeypatch):
    """``pretrained: true`` takes the model's default path (reference
    EDSR.py:87), relative to the working directory; absent, it raises."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="EDSR-b32f128x2"):
        apply_pretrained(AttrDict(_cfg("EDSR", pretrained=True)), _edsr(0))


def test_file_url_is_cached_and_nothing_is_fetched(tmp_path):
    """A ``file://`` URL is copied once into ``pretrained_cache`` and read
    from there after its source is gone; the load equals the direct
    path's. Another URL is read from the cache only."""
    src = tmp_path / "edsr_public.pt"
    torch.save(_foreign(_edsr(seed=7).state_dict()), src)
    direct = apply_pretrained(AttrDict(_cfg("EDSR", pretrained=str(src))),
                              _edsr(0))
    cache = tmp_path / "cache"
    url = src.as_uri()
    resolved = resolve_pretrained_path(url, cache)
    assert cache in Path(resolved).parents
    src.unlink()
    assert resolve_pretrained_path(url, cache) == resolved
    port = apply_pretrained(AttrDict(_cfg(
        "EDSR", pretrained=url, pretrained_cache=str(cache))), _edsr(0))
    for k, v in direct.state_dict().items():
        torch.testing.assert_close(port.state_dict()[k], v, rtol=0, atol=0)
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        resolve_pretrained_path("https://example.invalid/EDSR.pt", cache)


def _fake_cf(former):
    """The attribute path the PVT bootstraps load into."""
    return types.SimpleNamespace(
        backbone=types.SimpleNamespace(former=former))


def _pvt_pair():
    port = PVT(depths=(1, 1, 1, 1))
    jpvt = JaxPVT(depths=(1, 1, 1, 1))
    params, state = _jax_tree(jpvt, port)
    return port, jpvt, {"backbone": {"former": params}}, \
        {"backbone": {"former": state}}


def _assert_same_as_jax(port, params, state):
    """The port module's state equals the JAX (params, state), bit for
    bit."""
    want = {k: v for k, v in {
        **state_dict_from_jax_tree(params, port),
        **state_dict_from_jax_tree(state, port, "bn")}.items()
        if not k.endswith("num_batches_tracked")}
    got = {k: v for k, v in port.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    for k, v in got.items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)


def test_pvt_pretrained_partial_file_matches_jax(tmp_path):
    """A PVT file without a patch embedding's conv, an attention's query
    projection, a BatchNorm's weight and one position embedding, with a
    position embedding of another shape and an extra head: what is absent
    or does not fit keeps its init (the smallest enclosing submodule
    whole), the rest loads, as in the JAX package."""
    source = perturb_weights(PVT(depths=(1, 1, 1, 1)), seed=4,
                             affine=True).state_dict()
    drop = ("patch_embed2.proj.weight", "patch_embed2.proj.bias",
            "block1.0.attn.q.weight", "block1.0.attn.q.bias",
            "embed_layer2.0.bn1.weight", "pos_embed3")
    sd = {k: v for k, v in source.items() if k not in drop}
    sd["pos_embed1"] = torch.zeros(1, 3, 64)
    sd["head.weight"] = torch.zeros(1000, 512)
    path = tmp_path / "pvt.pth"
    torch.save(sd, path)

    port, jpvt, params, state = _pvt_pair()
    init = {k: v.clone() for k, v in port.state_dict().items()}
    cfg = _cfg("CompletionFormer", pvt_pretrained=str(path))
    apply_pretrained(AttrDict(cfg), _fake_cf(port))
    params, state = jax_apply_pretrained(JaxAttrDict(cfg), _fake_cf(jpvt),
                                         params, state)
    _assert_same_as_jax(port, params["backbone"]["former"],
                        state["backbone"]["former"])
    now = port.state_dict()
    kept = [k for k in now if not k.endswith("num_batches_tracked")
            and torch.equal(now[k], init[k])]
    assert set(kept) >= {"patch_embed2.proj.weight", "block1.0.attn.q.bias",
                         "embed_layer2.0.bn1.running_var", "pos_embed1",
                         "pos_embed3"}
    torch.testing.assert_close(now["block1.0.attn.kv.weight"],
                               source["block1.0.attn.kv.weight"])


def test_resnet_pretrained_partial_file_matches_jax(tmp_path):
    """torchvision-named ``layer1`` / ``layer2`` blocks for PVT's two
    embedding stems, without one conv and one BatchNorm's weight, with an
    extra ``fc``: loaded as the JAX package loads them."""
    source = perturb_weights(PVT(depths=(1, 1, 1, 1)), seed=5,
                             affine=True).state_dict()
    sd = {}
    for stem, layer in (("embed_layer1.", "layer1."),
                        ("embed_layer2.", "layer2.")):
        sd.update({layer + k[len(stem):]: v for k, v in source.items()
                   if k.startswith(stem)})
    for k in ("layer1.1.conv2.weight", "layer2.0.downsample.1.weight"):
        del sd[k]
    sd["fc.weight"] = torch.zeros(1000, 512)
    path = tmp_path / "ResNet34.pth"
    torch.save(sd, path)

    port, jpvt, params, state = _pvt_pair()
    cfg = _cfg("CompletionFormer", resnet_pretrained=str(path))
    apply_pretrained(AttrDict(cfg), _fake_cf(port))
    params, state = jax_apply_pretrained(JaxAttrDict(cfg), _fake_cf(jpvt),
                                         params, state)
    _assert_same_as_jax(port, params["backbone"]["former"],
                        state["backbone"]["former"])
    torch.testing.assert_close(port.embed_layer2[0].bn1.running_mean,
                               source["embed_layer2.0.bn1.running_mean"])


def test_missing_running_var_keeps_the_whole_batchnorm():
    """A BatchNorm whose ``running_var`` is absent keeps its init whole,
    not its other three tensors loaded (plain ``load_state_dict(strict=
    False)`` would load them); its neighbours load."""
    target = PVT(depths=(1, 1, 1, 1)).embed_layer1
    source = perturb_weights(PVT(depths=(1, 1, 1, 1)), seed=6,
                             affine=True).embed_layer1.state_dict()
    init = {k: v.clone() for k, v in target.state_dict().items()}
    sd = {k: v for k, v in source.items() if k != "0.bn1.running_var"}
    assert load_matching(target, sd, missing_ok=True) == []
    now = target.state_dict()
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        assert torch.equal(now[f"0.bn1.{leaf}"], init[f"0.bn1.{leaf}"])
        assert torch.equal(now[f"0.bn2.{leaf}"], source[f"0.bn2.{leaf}"])
    with pytest.raises(KeyError, match="running_var"):
        load_matching(target, sd)


def test_trainer_applies_pretrained_before_the_optimizer(tmp_path):
    """The Trainer loads ``model_kwargs.pretrained`` into the model it
    builds, before the optimizer takes its parameters."""
    from jspsr_torch.data.synthetic import generate_mini_dfc30
    from jspsr_torch.train.trainer import Trainer

    root, train, valid = generate_mini_dfc30(
        tmp_path / "DFC30_8m", train_cities=("Brest",),
        valid_cities=("Vannes",), n_per_city=2, size=32)
    source = _edsr(seed=9).state_dict()
    path = tmp_path / "edsr.pt"
    torch.save(_foreign(source), path)
    p = AttrDict({
        "name": "pretrained_test", "dataset": "DFC30",
        "dataset_path": str(root), "resolution": 8, "train_set": train,
        "valid_set": valid,
        "input_data": {"lr_dem": 1, "COP30": 1, "image": 3},
        "relative": True, "patch_size": 32, "crop_mode": "random",
        "patches_per_image": 1, "workers": 1,
        "tensor_kwargs": {"log": True, "min": -80, "max": 929},
        "model_name": "EDSR",
        "model_kwargs": {"num_block": 2, "num_feature": 8,
                         "pretrained": str(path), "checkpoint": None},
        "loss": {"L1": 1}, "optimizer": "AdamW",
        "optimizer_kwargs": {"lr": 1e-3, "weight_decay": 1e-6},
        "scheduler": "ConstantLR", "scheduler_kwargs": {},
        "train_batch_size": 2, "epochs": 1, "verbose": False})
    t = Trainer(p, result_dir=tmp_path / "run", device="cpu")
    for k, v in source.items():
        torch.testing.assert_close(t.model.state_dict()[k], v, rtol=0,
                                   atol=0, msg=k)
    in_opt = {id(q) for g in t.optimizer.param_groups for q in g["params"]}
    assert in_opt == {id(q) for q in t.model.parameters()}
