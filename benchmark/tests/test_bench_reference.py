"""The plain reference against the port on the CPU at a tiny size: the
same weights give the same forward, loss and gradients; the reference's
feed rebuilds the port's batches; its tiled serving gives the port's
rasters."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import cells
from benchmark.reference import reference_model
from benchmark.reference import feed
from benchmark.reference import serve as ref_serve
from benchmark.reference.train import losses, run_steps, step_generator
from benchmark.traffic import generate
from benchmark.weights import seeded_state_dict


def _port(name, tmp_path, **over):
    from jspsr_torch.config.loader import create_config
    from jspsr_torch.models.factory import build_model

    prog = json.loads(json.dumps(cells.config(name)["program"]))
    for k, v in over.items():
        if isinstance(v, dict):
            prog[k].update(v)
        else:
            prog[k] = v
    (tmp_path / "c.json").write_text(json.dumps(prog))
    p = create_config(tmp_path / "c.json")
    fixed = cells.config(name).get("fixed_leaves")
    port = build_model(p)
    port.load_state_dict(seeded_state_dict(port.state_dict(), 17, "cpu",
                                           fixed))
    ref = reference_model(prog)
    ref.load_state_dict(seeded_state_dict(ref.state_dict(), 17, "cpu",
                                          fixed), assign=True)
    return prog, p, port, ref


def test_state_dict_keys_and_shapes_match(tmp_path):
    for name in ("jspsr_r8_img_msk", "completionformer_r8_img_msk"):
        _, _, port, ref = _port(name, tmp_path)
        a, b = port.state_dict(), ref.state_dict()
        assert list(sorted(a)) == list(sorted(b))
        assert all(a[k].shape == b[k].shape for k in a)


def test_jspsr_forward_loss_and_gradients(tmp_path):
    prog, p, port, ref = _port("jspsr_r8_img_msk", tmp_path,
                               model_kwargs={"num_feature": 8,
                                             "num_block": 1})
    from jspsr_torch.losses import build_criterion

    g = torch.Generator().manual_seed(3)
    x = [torch.rand(2, 1, 64, 64, generator=g) * 0.2 + 0.5,
         torch.rand(2, 3, 64, 64, generator=g),
         torch.rand(2, 15, 64, 64, generator=g)]
    gt = x[0] + 0.01 * torch.randn(x[0].shape, generator=g)
    for mod in (port, ref):
        mod.train()
    a, b = port(x), ref(x)
    assert torch.allclose(a, b, rtol=1e-5, atol=1e-6)
    la = build_criterion(dict(p.loss))(a, gt)["Total"]
    lb = losses(b, gt, prog["loss"])["Total"]
    assert abs(la.item() - lb.item()) <= 1e-6 * abs(lb.item())
    la.backward()
    lb.backward()
    gp = dict(port.named_parameters())
    for n, q in ref.named_parameters():
        assert torch.allclose(gp[n].grad, q.grad, rtol=1e-3,
                              atol=1e-4 * q.grad.abs().max() + 1e-12), n


def test_completionformer_train_forward_with_drop_path(tmp_path):
    from jspsr_torch.train.step import seed_step_generator

    _, _, port, ref = _port("completionformer_r8_img_msk", tmp_path)
    g = torch.Generator().manual_seed(4)
    x = [torch.rand(1, 1, 64, 64, generator=g) * 0.2 + 0.5,
         torch.rand(1, 18, 64, 64, generator=g)]
    port.train()
    ref.train()
    ga, gb = torch.Generator(), torch.Generator()
    seed_step_generator(ga, 2 ** 31 + 5, 2)
    step_generator(gb, 2 ** 31 + 5, 2)
    with torch.no_grad():
        assert torch.allclose(port(x, generator=ga), ref(x, generator=gb),
                              rtol=1e-5, atol=1e-6)


def test_feed_rebuilds_the_port_batches(tmp_path):
    from jspsr_torch.config.loader import create_config
    from jspsr_torch.data.dfc30 import DFC30
    from jspsr_torch.data.loader import DataLoader, build_batch_inputs
    from jspsr_torch.data.transforms import build_transforms

    spec = dict(cells.traffic("dfc30_train_13x40"), n_per_city=2)
    generate.write_tree(tmp_path / "DFC30_8m", spec, 99)
    prog = dict(cells.config("jspsr_r8_img_msk")["program"],
                data_root=str(tmp_path))
    (tmp_path / "c.json").write_text(json.dumps(prog))
    p = create_config(tmp_path / "c.json")
    ds = DFC30(split="train", transform=build_transforms(p)[0], seed=99,
               **{k: v for k, v in p.items() if k != "seed"})
    loader = DataLoader(ds, 5, shuffle=True, drop_last=True, seed=99)
    files = generate.tree_files(tmp_path / "DFC30_8m", spec,
                                prog["train_set"])
    for epoch in (0, 3):
        loader.set_epoch(epoch)
        for step, batch in enumerate(loader):
            inputs, gt, _, _ = build_batch_inputs(batch, "JSPSR",
                                                  p.input_data)
            ref_in, ref_gt = feed.batch(files, step, 5, 99, epoch, 128,
                                        dict(p.tensor_kwargs), "cpu")
            for a, b in zip(inputs + [gt], ref_in + [ref_gt]):
                assert np.array_equal(a.transpose(0, 3, 1, 2), b.numpy())


def test_run_steps_moves_every_parameter(tmp_path):
    prog, p, port, ref = _port("jspsr_r8_img_msk", tmp_path,
                               model_kwargs={"num_feature": 8,
                                             "num_block": 1})
    g = torch.Generator().manual_seed(5)
    batch = ([torch.rand(2, 1, 32, 32, generator=g) * 0.2 + 0.5,
              torch.rand(2, 3, 32, 32, generator=g),
              torch.rand(2, 15, 32, 32, generator=g)],
             torch.rand(2, 1, 32, 32, generator=g) * 0.2 + 0.5)
    out = run_steps(ref, [batch] * 3, prog)
    assert len(out["losses"]) == 3
    moved = [n for n, g in out["grad"].items() if g > 0]
    assert len(moved) > 0.9 * len(out["grad"])
    assert all(out["change"][n] > 0 for n in moved)
    assert set(out["grad"]) == {n for n, _ in ref.named_parameters()}


def test_tiled_serving_matches_the_port(tmp_path):
    from jspsr_torch.eval.inference import load_scene
    from jspsr_torch.eval.scene import tile_inference_device

    prog, p, port, ref = _port("jspsr_r8_img_msk", tmp_path,
                               model_kwargs={"num_feature": 8,
                                             "num_block": 1})
    spec = dict(cells.traffic("scenes_334_x64"), n_scenes=2, side=240)
    dirs = generate.write_scenes(tmp_path / "scenes", spec, 5)
    got = [tile_inference_device(port, load_scene(d, p)[0], p,
                                 device="cpu")[0][..., 0] for d in dirs]
    want = ref_serve.serve(ref, dirs, dict(p.tensor_kwargs), "cpu")
    for a, b in zip(got, want):
        assert np.abs(a - b).max() < 5e-3  # metres, fp32 against float64


def test_reference_grid_is_the_r3_protocol():
    assert ref_serve.grid(334, 128) == (103, 3)
    with pytest.raises(ValueError):
        ref_serve.grid(301, 128)
