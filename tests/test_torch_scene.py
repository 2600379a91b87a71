"""Device-tiled scene inference in the PyTorch port vs the JAX package, on
the CPU (mirrors tests/test_scene_device.py).

The grid, its weights and the transfer encodings equal JAX's exactly. An
identity stub round-trips the DEM on exact and padded rectangular grids.
A tiny JSPSR (num_feature 8, layers (1,1,1,1)) is built once in the port
and carried into JAX with ``import_torch_state_dict``; through it:

- ``tile_inference_device`` (metres) against JAX's at atol 5e-3 m, the
  JAX suite's tolerance between its device and host tiled paths
  (tests/test_scene_device.py:141), with the whole-model rtol 1e-4: the
  log descale multiplies a [0,1] error by ln(1009) * (z + 80), about
  3,300 at the 400 m these random weights reach, so one fp32 rounding
  step across the two frameworks is already 5e-3 m there;
- the host ``tile_inference`` ([0,1] prediction) against JAX's at the
  whole-model tolerance, rtol 1e-4 / atol 2e-5;
- chunked (cap 4) against one batch, at the JAX suite's tolerance between
  tile batch sizes (rtol 2e-4 / atol 5e-3 m).
"""

import copy

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from jspsr_tpu.config.loader import AttrDict as JaxAttrDict
from jspsr_tpu.data import normalize as jax_norm
from jspsr_tpu.eval import scene as jax_scene
from jspsr_tpu.eval.inference import run_scene_inference as jax_run_scene
from jspsr_tpu.eval.inference import tile_inference as jax_tile_inference
from jspsr_tpu.models.jspsr import JSPSR as JaxJSPSR
from jspsr_tpu.train.step import make_forward as jax_make_forward
from jspsr_tpu.utils.torch_import import import_torch_state_dict
from jspsr_torch.config.loader import AttrDict
from jspsr_torch.data import normalize as port_norm
from jspsr_torch.data.raster_io import read_raster, write_raster
from jspsr_torch.eval import scene
from jspsr_torch.eval.inference import (
    make_forward,
    run_scene_inference,
    tile_inference,
)
from jspsr_torch.models.jspsr import JSPSR

torch.set_num_threads(4)

BASE_P = {
    "model_name": "JSPSR", "relative": True, "normalize": False,
    "mask_channel": None, "input_data": {"lr_dem": 1, "image": 3},
    "tensor_kwargs": {"log": True, "min": -80, "max": 929,
                      "scale_mask": True},
}
METRES = dict(rtol=1e-4, atol=5e-3)
BATCHES = dict(rtol=2e-4, atol=5e-3)


def _p(**over):
    d = copy.deepcopy(BASE_P)
    d.update(over)
    return AttrDict(copy.deepcopy(d)), JaxAttrDict(copy.deepcopy(d))


def _scene(h, w, seed=0, image=True):
    rng = np.random.default_rng(seed)
    s = {"lr_dem": rng.uniform(10, 200, (h, w, 1)).astype(np.float32)}
    if image:
        s["image"] = rng.integers(0, 255, (h, w, 3)).astype(np.float32)
    return s


class _Identity(torch.nn.Module):
    """Prediction = the LR-DEM tile (normalized space)."""

    def forward(self, inputs):
        return inputs[0]


class _JaxIdentity:
    def __call__(self, params, bn_state, inputs, train=False):
        return inputs[0], bn_state


def _models(inputs, seed):
    port = JSPSR(dict(inputs), num_feature=8, layers=(1, 1, 1, 1),
                 generator=torch.Generator().manual_seed(seed)).eval()
    jm = JaxJSPSR(dict(inputs), num_feature=8, layers=(1, 1, 1, 1))
    params, bn = import_torch_state_dict(jm, port.state_dict())
    return port, (jm, params, bn)


@pytest.fixture(scope="module")
def tiny():
    return _models({"lr_dem": 1, "image": 3}, seed=0)


@pytest.mark.parametrize("tile", [64, 128])
def test_tile_grid_matches_jax(tile):
    sizes = [tile, tile + 1, 160, 200, 241, 333, 334, 500, 700, 1024, 1030]
    for size in sizes:
        assert scene.tile_grid(size, tile) == jax_scene.tile_grid(size, tile)
    assert scene.tile_grid(334, 128) == (103, 3, 334)
    assert scene.tile_grid(1024, 128) == (112, 9, 1024)
    assert scene.tile_grid(500, 128) == (124, 4, 500)
    assert scene.tile_grid(700, 128) == (96, 7, 704)
    with pytest.raises(AssertionError):
        scene.tile_grid(tile - 1, tile)


@pytest.mark.parametrize("h,w,tile", [(334, 334, 128), (1024, 1024, 128),
                                      (500, 700, 128), (257, 200, 128),
                                      (160, 130, 64)])
def test_grid_weights_match_jax(h, w, tile):
    sr, nr, _ = scene.tile_grid(h, tile)
    sc, nc, _ = scene.tile_grid(w, tile)
    np.testing.assert_array_equal(scene.grid_weights(tile, sr, nr, sc, nc),
                                  jax_scene.grid_weights(tile, sr, nr, sc,
                                                         nc))


def test_transfer_encodings_match_jax():
    rng = np.random.default_rng(9)
    s = {
        "lr_dem": rng.uniform(10, 200, (32, 32, 1)).astype(np.float32),
        "image": rng.integers(0, 255, (32, 32, 3)).astype(np.float32),
        "mask": (rng.uniform(0, 1, (32, 32, 15)) < 0.3).astype(np.float32),
        "canopy": rng.uniform(0, 60, (32, 32, 1)).astype(np.float32),
    }
    enc = scene.transfer_encodings(s, list(s))
    assert enc == jax_scene.transfer_encodings(s, list(s))
    assert enc == {"lr_dem": ("f32", 1), "image": ("u8", 3),
                   "mask": ("bits", 15), "canopy": ("f32", 1)}
    u8 = {"image": s["image"].astype(np.uint8),
          "mask": s["mask"].astype(np.uint8),
          "float_image": rng.uniform(0, 255, (32, 32, 3)).astype(np.float32)}
    assert scene.transfer_encodings(u8, list(u8)) == \
        jax_scene.transfer_encodings(u8, list(u8)) == {
            "image": ("u8", 3), "mask": ("bits", 15),
            "float_image": ("f32", 3)}


def test_prepare_scene_matches_jax():
    p, jp = _p(input_data={"lr_dem": 1, "image": 3, "mask": 15})
    rng = np.random.default_rng(4)
    s = _scene(257, 200, seed=4)
    s["mask"] = np.eye(15, dtype=np.uint8)[rng.integers(0, 15, (257, 200))]
    got = scene.prepare_scene(s, p)
    ref = jax_scene.prepare_scene(s, jp)
    assert (got.keys, got.hw, got.enc, got.base) == \
        (ref.keys, ref.hw, ref.enc, ref.base)
    for k in got.keys:
        np.testing.assert_array_equal(got.arrays[k], ref.arrays[k])


def test_identity_round_trip_reference_grid():
    p, jp = _p()
    s = _scene(160, 160, image=False)
    out, t_ms = scene.tile_inference_device(_Identity(), s, p, tile=64,
                                            device="cpu")
    assert out.shape == (160, 160, 1) and t_ms > 0
    np.testing.assert_allclose(out, s["lr_dem"], atol=0.05)
    ref, _ = jax_scene.tile_inference_device(_JaxIdentity(), {}, {}, s, jp,
                                             tile=64)
    np.testing.assert_allclose(out, np.asarray(ref), **METRES)


def test_identity_round_trip_rect_padded():
    """257 rows take the ceil'd grid (stride 65, 3 tiles, padded to 258);
    the blend still reconstructs identical tile predictions."""
    p, jp = _p()
    s = _scene(257, 200, seed=3, image=False)
    out, _ = scene.tile_inference_device(_Identity(), s, p, tile=128,
                                         device="cpu")
    assert out.shape == (257, 200, 1)
    np.testing.assert_allclose(out, s["lr_dem"], atol=0.05)
    ref, _ = jax_scene.tile_inference_device(_JaxIdentity(), {}, {}, s, jp,
                                             tile=128)
    np.testing.assert_allclose(out, np.asarray(ref), **METRES)


def test_nodata_scene_rejected_loudly():
    s = _scene(64, 64, image=False)
    s["lr_dem"][0, 0, 0] = -9999.0
    p, _ = _p(relative=False)
    with pytest.raises(ValueError, match="nodata"):
        scene.prepare_scene(s, p, tile=64)
    p, _ = _p()  # relative: -9999 becomes the base, the top leaves [0, 1]
    with pytest.raises(ValueError, match="outside"):
        scene.prepare_scene(s, p, tile=64)


def test_device_tiled_matches_jax(tiny):
    port, (jm, params, bn) = tiny
    p, jp = _p()
    s = _scene(160, 160, seed=1)
    got, _ = scene.tile_inference_device(port, s, p, tile=64, device="cpu")
    ref, _ = jax_scene.tile_inference_device(jm, params, bn, s, jp, tile=64)
    np.testing.assert_allclose(got, np.asarray(ref), **METRES)


def test_host_tiled_matches_jax(tiny):
    port, (jm, params, bn) = tiny
    p, jp = _p()
    s = _scene(160, 160, seed=2)
    fwd = jax_make_forward(jm)
    ref = jax_tile_inference(lambda x: fwd(params, bn, x), dict(s), jp,
                             tile=64)
    got = tile_inference(make_forward(port), dict(s), p, tile=64,
                         device="cpu")
    assert got.shape == (160, 160, 1)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=2e-5)
    with pytest.raises(ValueError, match="square"):
        tile_inference(make_forward(port), _scene(160, 130), p, tile=64,
                       device="cpu")


def test_chunked_forward_equals_single_batch(tiny):
    port, _ = tiny
    p, _ = _p()
    s = _scene(160, 160, seed=5)
    one, _ = scene.tile_inference_device(port, s, p, tile=64, cap=81,
                                         device="cpu")
    chunked, _ = scene.tile_inference_device(port, s, p, tile=64, cap=4,
                                             device="cpu")  # 3 chunks of 3
    np.testing.assert_allclose(chunked, one, **BATCHES)


def test_prepared_scene_dispatch_path(tiny):
    port, _ = tiny
    p, _ = _p()
    s = _scene(160, 160, seed=8)
    direct, _ = scene.tile_inference_device(port, s, p, tile=64,
                                            device="cpu")
    via_prep = scene.scene_dispatch(port, scene.prepare_scene(s, p, tile=64),
                                    p, device="cpu").numpy()
    np.testing.assert_array_equal(via_prep, direct)


def test_mask_and_base_semantics_match_jax():
    """scale_mask, a 6-channel bit-packed mask and the relative base, through
    both device normalizers."""
    port, (jm, params, bn) = _models({"lr_dem": 1, "image": 3, "mask": 6},
                                     seed=4)
    rng = np.random.default_rng(7)
    s = _scene(160, 160, seed=5)
    s["mask"] = (rng.uniform(0, 1, (160, 160, 6)) < 0.3).astype(np.float32)
    p, jp = _p(input_data={"lr_dem": 1, "image": 3, "mask": 6},
               mask_channel=list(range(6)))
    got, _ = scene.tile_inference_device(port, s, p, tile=64, device="cpu")
    ref, _ = jax_scene.tile_inference_device(jm, params, bn, s, jp, tile=64)
    np.testing.assert_allclose(got, np.asarray(ref), **METRES)


class _TwoInputStub(torch.nn.Module):
    """CompletionFormer's signature: [dem, stacked guidance]."""

    def forward(self, inputs):
        dem, guide = inputs
        assert guide.shape[1] == 3, guide.shape
        return dem


class _StackedStub(torch.nn.Module):
    """EDSR's signature: one channel-stacked input."""

    def forward(self, inputs):
        (x,) = inputs
        assert x.shape[1] == 4, x.shape
        return x[:, :1]


@pytest.mark.parametrize("name,stub", [("CompletionFormer", _TwoInputStub),
                                       ("EDSR", _StackedStub)])
def test_assembly_per_model_family(name, stub):
    p, _ = _p(model_name=name)
    s = _scene(128, 128, seed=15)
    out, _ = scene.tile_inference_device(stub(), s, p, tile=64,
                                         device="cpu")
    np.testing.assert_allclose(out, s["lr_dem"], atol=0.05)
    tiles = {"lr_dem": torch.zeros(2, 1, 4, 4), "image": torch.ones(2, 3, 4,
                                                                    4)}
    got = scene._assemble(tiles, ["lr_dem", "image"], name)
    assert [tuple(t.shape) for t in got] == (
        [(2, 1, 4, 4), (2, 3, 4, 4)] if name == "CompletionFormer"
        else [(2, 4, 4, 4)])


def test_supported_surface_gate():
    assert scene.device_tiling_supported(_p()[0])
    assert not scene.device_tiling_supported(_p(normalize=["lr_dem"])[0])
    p, _ = _p()
    p["tensor_kwargs"]["image_range"] = "[-1, 1]"
    assert not scene.device_tiling_supported(p)


@pytest.mark.parametrize("kind", ["lr_dem", "image", "mask", "canopy",
                                  "coord"])
def test_modality_scale_matches_jax(kind):
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 255, (2, 5, 6, 4)).astype(np.float32)
    base = rng.uniform(0, 10, (2, 1, 1, 1)).astype(np.float32)
    kw = dict(emin=-80, emax=929, elog=True, scale_mask=True, n_div=5,
              relative=True)
    got = port_norm.modality_scale(kind, torch.from_numpy(x),
                                   torch.from_numpy(base), **kw)
    ref = jax_norm.modality_scale(kind, jnp.asarray(x), jnp.asarray(base),
                                  **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("n_ch", [6, 8, 15, 17])
def test_unpack_mask_bits_matches_jax_and_packbits(n_ch):
    rng = np.random.default_rng(n_ch)
    bits = (rng.uniform(0, 1, (3, 4, n_ch)) < 0.4).astype(np.uint8)
    packed = np.packbits(bits, axis=-1)
    got = port_norm.unpack_mask_bits(torch.from_numpy(packed), n_ch).numpy()
    np.testing.assert_array_equal(got, bits)
    np.testing.assert_array_equal(
        got, np.asarray(jax_norm.unpack_mask_bits(jnp.asarray(packed), n_ch)))


def test_mesh_and_missing_cuda_raise(monkeypatch):
    """A mesh of two entries runs the identity stub's tiles in halves and
    gives the mosaic without a mesh, bit for bit
    (tests/test_torch_parallel.py holds a model's to the JAX runner's
    mesh); without CUDA the default device raises."""
    p, _ = _p()
    s = _scene(128, 128, image=False)
    got, _ = scene.tile_inference_device(_Identity(), dict(s), p, tile=64,
                                         mesh=["cpu", "cpu"], device="cpu")
    want, _ = scene.tile_inference_device(_Identity(), dict(s), p, tile=64,
                                          device="cpu")
    np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scene.tile_inference_device(_Identity(), s, p, tile=64)


def test_run_scene_inference_host_tiled_route_matches_jax(tiny, tmp_path):
    """``infer_device_tiling: false`` routes ``tile=True`` to the host tiled
    path, in both packages; the rasters in metres agree at rtol 1e-3
    (test_torch_infer.py's, as the log descale multiplies errors by about
    ln(1009) * (z + 80)) and atol 1e-2 m (for outputs near 0 m)."""
    port, (jm, params, bn) = tiny
    p, jp = _p(infer_device_tiling=False, patch_size=64)
    s = _scene(160, 160, seed=9)
    write_raster(tmp_path / "scene" / "lr_dem.npy", s["lr_dem"])
    write_raster(tmp_path / "scene" / "image.npy", s["image"])
    got, _, _ = run_scene_inference(port, p, tmp_path / "scene",
                                    tmp_path / "port.npy", tile=True,
                                    device="cpu")
    ref, _, _ = jax_run_scene(jm, params, bn, jp, tmp_path / "scene",
                              tmp_path / "jax.npy", tile=True)
    np.testing.assert_allclose(read_raster(got), read_raster(ref), rtol=1e-3,
                               atol=1e-2)


def _dispatch(port, s, p, min_overlap):
    prepared = scene.prepare_scene(s, p, tile=128, min_overlap=min_overlap)
    return scene.scene_dispatch_batch(port, [prepared], p,
                                      device="cpu")[0].numpy()


@pytest.mark.parametrize("side", [301, 303])
def test_runner_cache_separates_overlaps(tiny, side):
    """A scene asked for with ``min_overlap`` 64 after one with 16 gets a
    runner of its own (at 301^2 the two overlaps pad to one shape, 3x3
    tiles against 4x4; at 303^2 they pad to two). Its mosaic equals the
    JAX package's runner built fresh for overlap 64 (a cold cache, where
    JAX is right) at the suite's tolerance, and the port's own runner on a
    cold cache bit for bit."""
    port, (jm, params, bn) = tiny
    p, jp = _p()
    s = _scene(side, side, seed=10)
    scene._RUNNER_CACHE.clear()
    _dispatch(port, s, p, 16)
    got = _dispatch(port, s, p, 64)
    assert len(scene._RUNNER_CACHE) == 2
    scene._RUNNER_CACHE.clear()
    cold = _dispatch(port, s, p, 64)
    np.testing.assert_array_equal(got, cold)

    prepared = jax_scene.prepare_scene(s, jp, tile=128, min_overlap=64)
    run = jax_scene.make_scene_runner(
        jm, jp, prepared.keys, prepared.hw, tile=128, min_overlap=64,
        encodings=prepared.enc)
    ref = run(params, bn, {k: jnp.asarray(prepared.arrays[k][None])
                           for k in prepared.keys},
              jnp.asarray([prepared.base], jnp.float32))[0]
    assert got.shape == (side, side, 1)
    np.testing.assert_allclose(got, np.asarray(ref), **METRES)


def test_mixed_overlaps_are_not_one_batch(tiny):
    port, _ = tiny
    p, _ = _p()
    s = _scene(160, 160, seed=11)
    batch = [scene.prepare_scene(s, p, tile=64, min_overlap=o)
             for o in (16, 32)]
    assert batch[0].arrays["lr_dem"].shape == batch[1].arrays["lr_dem"].shape
    with pytest.raises(ValueError, match="homogeneous"):
        scene.scene_dispatch_batch(port, batch, p, device="cpu")
