"""``--export`` and ``eval/export.py``: the port's ``torch.export``
deployment artifact against the eager port model and against the JAX
package's own artifact, on the CPU.

For each family at a small width (JSPSR fp32 and with the bf16 body and
sampling, EDSR with its SPN head, LRRU, CompletionFormer with its PVT cut
to one block per stage), the seeded, perturbed port model is exported at
a batch of 2, saved, and loaded in a fresh process that imports ``torch``
and the op library alone (no ``jspsr_torch.models``, ``.config`` or
``.train``, no JAX). There it runs at batch 1 and 3, equal to the eager
model within atol 1e-6 (the same operations in the same order). The same
weights go into the JAX model (``import_torch_state_dict``) and through
``jspsr_tpu.eval.export``'s artifact (its default, the ``mxu``-pinned
portable lowering), which the port's artifact meets at the tolerance of
that family's parity test: rtol 1e-4 / atol 2e-5 (JSPSR, EDSR), 1e-4 /
3e-5 (LRRU, on smooth DEMs with 30 % no-data), 1e-3 / 1e-4
(CompletionFormer). The mxu pin ignores ``sample_dtype`` (ROADMAP §3 note
10), so the bf16 model, whose port artifact samples in bf16, meets the JAX
bf16-body artifact (fp32 sampling) at the bf16 tests' tolerance: twice the
JAX package's own distance between its bf16 and fp32 models, largest and
mean (tests/test_torch_bf16.py). Then the CLI.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from jspsr_tpu.eval.export import load_exported as jax_load_exported
from jspsr_tpu.eval.export import save_exported as jax_save_exported
from jspsr_tpu.models import edsr as JE
from jspsr_tpu.models import lrru as JL
from jspsr_tpu.models.completionformer import CompletionFormer as JaxCF
from jspsr_tpu.models.jspsr import JSPSR as JaxJSPSR
from jspsr_tpu.models.pvt import PVT as JaxPVT
from jspsr_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from jspsr_tpu.utils.torch_import import import_torch_state_dict
from jspsr_torch.cli.main import main as cli_main
from jspsr_torch.eval.export import (
    ARTIFACT_SUFFIX,
    export_platforms,
    save_exported,
)
from jspsr_torch.models.completionformer import CompletionFormer
from jspsr_torch.models.edsr import EDSR
from jspsr_torch.models.jspsr import JSPSR
from jspsr_torch.models.lrru import LRRU
from jspsr_torch.models.pvt import PVT
from jspsr_torch.ops import deform_cuda
from jspsr_torch.utils.perturb import perturb_weights

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP = {"lr_dem": 1, "image": 3, "mask": 15}
IMG = {"lr_dem": 1, "image": 3}
FAMILIES = ["jspsr", "jspsr_bf16", "edsr_spn", "lrru", "completionformer"]
# the family's parity test's tolerance (rtol, atol)
JAX_TOL = {"jspsr": (1e-4, 2e-5), "edsr_spn": (1e-4, 2e-5),
           "lrru": (1e-4, 3e-5), "completionformer": (1e-3, 1e-4)}
BF16_FACTOR = 2.0

# run in a fresh process: load the artifact with torch and the op library
# alone, run it on every input file, save the outputs
LOADER = r"""
import json, sys
import numpy as np
import torch
from jspsr_torch.eval.export import load_exported
torch.set_num_threads(2)  # the test's: oneDNN's sums follow the threads
fn = load_exported(sys.argv[1], device="cpu")
outs = {}
for name in sys.argv[3:]:
    with np.load(name) as z:
        xs = [torch.from_numpy(z[k]) for k in sorted(z.files)]
    outs[name] = fn(*xs).numpy()
np.savez(sys.argv[2], **{str(i): outs[k] for i, k in enumerate(sys.argv[3:])})
print(json.dumps(sorted(m for m in sys.modules if m.startswith(
    ("jspsr", "jax")))))
"""


def _smooth_dem(rng, b, h, w, holes=0.3):
    """(B, 1, H, W) smooth terrain in [0.1, 0.9], ``holes`` of it at 0
    (tests/test_torch_lrru.py's: a DEM of random pixels leaves LRRU's
    fp32 forward 3e-4 from float64 in both packages)."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    out = []
    for _ in range(b):
        f, ph = rng.uniform(1, 3, 4), rng.uniform(0, 6, 2)
        dem = (0.5 + 0.3 * np.sin(f[0] * np.pi * xx + ph[0])
               * np.cos(f[1] * np.pi * yy + ph[1]) + 0.1 * xx)
        blobs = np.sin(f[2] * np.pi * xx + ph[1]) * np.sin(f[3] * np.pi * yy)
        dem[blobs > np.quantile(blobs, 1.0 - holes)] = 0.0
        out.append(dem)
    return np.asarray(out, np.float32)[:, None]


def _family(name):
    """(port model, seeded and perturbed; its JAX twin; an input maker
    ``(rng, batch) -> [NCHW fp32 numpy]`` in the model's input order)."""
    gen = torch.Generator().manual_seed(3)
    if name.startswith("jspsr"):
        kw = {"num_feature": 8, "layers": (1, 1, 1, 1)}
        if name == "jspsr_bf16":
            kw.update(compute_dtype="bfloat16", spn_sample_dtype="bfloat16")
        port = JSPSR(dict(FLAGSHIP), generator=gen, **kw)
        jax_model = JaxJSPSR(dict(FLAGSHIP), **kw)

        def inputs(rng, b):
            return [rng.uniform(0.3, 0.7, (b, 1, 32, 32)),
                    rng.uniform(0, 1, (b, 3, 32, 32)),
                    rng.uniform(0, 1, (b, 15, 32, 32))]
    elif name == "edsr_spn":
        kw = {"in_channels": 4, "out_channels": 1, "n_resblocks": 1,
              "n_features": 8, "spn": True}
        port, jax_model = EDSR(**kw, generator=gen), JE.EDSR(**kw)

        def inputs(rng, b):
            return [rng.uniform(0.05, 0.95, (b, 4, 32, 32))]
    elif name == "lrru":
        kw = {"bc": 4, "layers": (2, 1, 1, 1, 1), "prob": 0.8}
        port = LRRU(dict(IMG), generator=gen, **kw)
        jax_model = JL.LRRU(dict(IMG), **kw)

        def inputs(rng, b):
            return [_smooth_dem(rng, b, 48, 32),
                    rng.uniform(0, 1, (b, 3, 48, 32))]
    else:
        port = CompletionFormer(dict(FLAGSHIP), generator=gen)
        torch.manual_seed(3)
        port.backbone.former = PVT(in_chans=128, patch_size=2,
                                   depths=(1, 1, 1, 1))
        jax_model = JaxCF(dict(FLAGSHIP))
        jax_model.backbone.former = JaxPVT(in_chans=128, patch_size=2,
                                           depths=(1, 1, 1, 1))

        def inputs(rng, b):
            return [rng.uniform(0.1, 0.9, (b, 1, 64, 64)),
                    rng.uniform(0, 1, (b, 18, 64, 64))]
    port = perturb_weights(port, seed=4, affine=True).eval()

    def made(rng, b):
        return [np.ascontiguousarray(x, np.float32) for x in inputs(rng, b)]

    return port, jax_model, made


def _nhwc(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 2, 3, 1))


@pytest.mark.parametrize("family", FAMILIES)
def test_artifact_round_trip_matches_eager_and_jax(family, tmp_path):
    port, jax_model, inputs = _family(family)
    rng = np.random.default_rng(FAMILIES.index(family))
    batches = {b: inputs(rng, b) for b in (1, 3)}
    launches = dict(deform_cuda.LAUNCHES)
    path = save_exported(tmp_path / family, port,
                         [torch.from_numpy(x) for x in batches[1]])
    assert path.suffix == ARTIFACT_SUFFIX and path.exists()
    # the graph holds the deform op as one node per call of the forward
    program = torch.export.load(path)
    nodes = [n for m in program.graph_module.modules()
             if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes
             if "jspsr.deform_conv2d" in str(n.target)]
    assert len(nodes) == {"lrru": 4, "completionformer": 6}.get(family, 1)

    files = []
    for b, xs in batches.items():
        files.append(tmp_path / f"in_{b}.npz")
        np.savez(files[-1], **{f"{i:02d}": x for i, x in enumerate(xs)})
    run = subprocess.run(
        [sys.executable, "-c", LOADER, str(path), str(tmp_path / "out.npz"),
         *map(str, files)], capture_output=True, text=True, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert run.returncode == 0, run.stderr[-3000:]
    modules = json.loads(run.stdout.strip().splitlines()[-1])
    assert not [m for m in modules if m.startswith(
        ("jax", "jspsr_tpu", "jspsr_torch.models", "jspsr_torch.config",
         "jspsr_torch.train"))], modules
    assert "jspsr_torch.ops.deform_conv" in modules
    with np.load(tmp_path / "out.npz") as z:
        outs = {b: z[str(i)] for i, b in enumerate(batches)}
    assert deform_cuda.LAUNCHES == launches  # CPU: the plain versions

    params, bn = import_torch_state_dict(
        jax_model, {k: v.detach().numpy().copy()
                    for k, v in port.state_dict().items()})
    jax_fn = jax_load_exported(jax_save_exported(
        tmp_path / f"{family}_jax", jax_model, params, bn,
        [_nhwc(x) for x in batches[1]]))
    for b, xs in batches.items():
        got = outs[b]
        with torch.no_grad():
            eager = port([torch.from_numpy(x) for x in xs]).numpy()
        assert got.shape == (b, 1, *xs[0].shape[2:]) and got.dtype == np.float32
        np.testing.assert_allclose(got, eager, rtol=0, atol=1e-6)
        ref = np.asarray(jax_fn(*[_nhwc(x) for x in xs])).transpose(0, 3, 1, 2)
        if family == "jspsr_bf16":
            ref32, _ = jax.jit(lambda q, s, x: JaxJSPSR(
                dict(FLAGSHIP), num_feature=8, layers=(1, 1, 1, 1))(
                    q, s, x, train=False))(params, bn,
                                           [_nhwc(x) for x in xs])
            d_port = np.abs(got - ref)
            d_jax = np.abs(ref - np.asarray(ref32).transpose(0, 3, 1, 2))
            print(f"bf16 artifact at batch {b}: port vs JAX max "
                  f"{d_port.max():.3g} mean {d_port.mean():.3g}; JAX bf16 "
                  f"vs fp32 max {d_jax.max():.3g} mean {d_jax.mean():.3g}")
            assert d_port.max() <= BF16_FACTOR * d_jax.max()
            assert d_port.mean() <= BF16_FACTOR * d_jax.mean()
        else:
            rtol, atol = JAX_TOL[family]
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def test_export_platforms_is_normalised():
    """A scalar string is one name (ADVICE.md's finding on the JAX CLI);
    the JAX default and ``[tpu]`` are both read; a name outside the list
    raises."""
    assert export_platforms("tpu") == ("tpu",)
    assert export_platforms(None) == ("cpu", "tpu")
    assert export_platforms(["cpu", "tpu"]) == ("cpu", "tpu")
    assert export_platforms(["cuda"]) == ("cuda",)
    for bad in ("gpu0", ["cpu", "rocm"]):
        with pytest.raises(ValueError, match="export_platforms"):
            export_platforms(bad)


def _run_cli(argv):
    real_stdout = sys.stdout
    try:
        return cli_main(argv)
    finally:
        logger, sys.stdout = sys.stdout, real_stdout
        if logger is not real_stdout:
            logger.close()


@pytest.mark.parametrize("platforms", [None, "tpu"], ids=["default",
                                                          "scalar_tpu"])
def test_cli_export(tmp_path, platforms):
    """--export builds the model from the config, loads the checkpoint (a
    JAX ``.npz``) and writes a ``.pt2`` whose forward is the checkpoint's
    model; ``export_platforms: tpu`` (a scalar) gives the same artifact;
    without a checkpoint it raises as the JAX CLI does."""
    from jspsr_torch.config.loader import create_config
    from jspsr_torch.eval.export import load_exported
    from jspsr_torch.models.factory import build_model
    from jspsr_torch.train.checkpoint import load_model_params

    port = perturb_weights(JSPSR(dict(IMG), num_feature=8,
                                 layers=(1, 1, 1, 1)), seed=5)
    jax_model = JaxJSPSR(dict(IMG), num_feature=8, layers=(1, 1, 1, 1))
    params, bn = import_torch_state_dict(
        jax_model, {k: v.numpy().copy() for k, v in port.state_dict().items()})
    jax_save_checkpoint(tmp_path / "m.npz", params, bn)
    cfg = {"name": "export_smoke", "verbose": False, "dataset": "DFC30",
           "resolution": 8, "patch_size": 32,
           "input_data": {"COP30": 1, "image": 3},
           "model_name": "JSPSR",
           "model_kwargs": {"num_block": 1, "num_feature": 8,
                            "pretrained": False,
                            "checkpoint": str(tmp_path / "m.npz")},
           "optimizer_kwargs": {"lr": 1e-3}}
    if platforms:
        cfg["export_platforms"] = platforms
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    out = _run_cli(["--config", str(cfg_path), "--export",
                    str(tmp_path / "deploy"), "--device", "cpu",
                    "--result-dir", str(tmp_path / "run")])
    assert out == tmp_path / "deploy.pt2" and out.stat().st_size > 1000
    log = (tmp_path / "run" / "train.log").read_text()
    assert "Exported inference artifact" in log
    model = load_model_params(build_model(create_config(cfg_path)),
                              tmp_path / "m.npz").eval()
    rng = np.random.default_rng(1)
    xs = [torch.from_numpy(rng.uniform(0, 1, (3, c, 32, 32)).astype(
        np.float32)) for c in (1, 3)]
    with torch.no_grad():
        want = model(xs)
    torch.testing.assert_close(load_exported(out, device="cpu")(*xs), want,
                               rtol=0, atol=1e-6)

    cfg["model_kwargs"]["checkpoint"] = None
    cfg_path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(ValueError, match="--export requires"):
        _run_cli(["--config", str(cfg_path), "--export",
                  str(tmp_path / "deploy2"), "--device", "cpu",
                  "--result-dir", str(tmp_path / "run2")])


def test_load_exported_needs_cuda_or_explicit_cpu(tmp_path, monkeypatch):
    """The loader runs on the card unless asked for the CPU; without a
    card it raises rather than run on the CPU."""
    from jspsr_torch.eval.export import load_exported

    port, _, inputs = _family("edsr_spn")
    path = save_exported(tmp_path / "a", port, [torch.zeros(1, 4, 32, 32)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_exported(path)
    xs = inputs(np.random.default_rng(0), 2)
    assert load_exported(path, device="cpu")(
        *map(torch.from_numpy, xs)).shape == (2, 1, 32, 32)
