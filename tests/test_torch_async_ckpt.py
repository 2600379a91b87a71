"""The port's asynchronous checkpoint backend (``checkpoint_backend:
orbax``, ``jspsr_torch/train/orbax_ckpt.py``) on the CPU.

Its file is the synchronous ``.npz`` backend's, written from a background
thread through a temporary name: the arrays and meta equal the
synchronous file's; a read waits for the write in flight; two saves to one
path leave the later one; a preempted ``save_every_steps`` fit relaunched
under the backend reproduces the uninterrupted fit bit for bit
(tests/test_torch_preempt.py's pattern); the JAX package's loader reads
the file; a JAX orbax directory is refused with the ``.npz`` route named.
"""

import copy
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jspsr_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from jspsr_tpu.train.orbax_ckpt import save_checkpoint_orbax as \
    jax_save_orbax
from jspsr_tpu.train.orbax_ckpt import wait_for_checkpoint as jax_wait
from jspsr_torch.config.loader import AttrDict
from jspsr_torch.models.jspsr import JSPSR
from jspsr_torch.train import orbax_ckpt
from jspsr_torch.train.checkpoint import load_checkpoint, save_checkpoint
from jspsr_torch.train.trainer import Trainer
from tests.test_torch_preempt import _Preempted, _state, env  # noqa: F401

torch.set_num_threads(2)


def _trained(seed=0):
    """A small JSPSR and AdamW after one step: every kind of entry."""
    model = JSPSR({"lr_dem": 1, "image": 3}, num_feature=8,
                  layers=(1, 1, 1, 1),
                  generator=torch.Generator().manual_seed(seed))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    g = torch.Generator().manual_seed(seed)
    x = [torch.rand(2, c, 32, 32, generator=g) for c in (1, 3)]
    model.train()(x).mean().backward()
    opt.step()
    return model, opt


def _read(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture
def slow_writes(monkeypatch):
    """Holds each background write until ``release`` is set."""
    release = threading.Event()
    write = orbax_ckpt.write_npz

    def held(path, arrays):
        assert release.wait(timeout=30)
        return write(path, arrays)

    monkeypatch.setattr(orbax_ckpt, "write_npz", held)
    yield release
    release.set()
    orbax_ckpt.wait_for_checkpoint()


def test_async_file_equals_the_synchronous_one(tmp_path):
    model, opt = _trained()
    extra = {"global_step": 3, "loss_sums": {"Total": 0.25}}
    save_checkpoint(tmp_path / "sync.npz", model, opt, epoch=2,
                    best_result={"RMSE": 1.5}, extra=extra)
    orbax_ckpt.save_checkpoint_orbax(tmp_path / "async.npz", model, opt,
                                     epoch=2, best_result={"RMSE": 1.5},
                                     extra=extra)
    orbax_ckpt.wait_for_checkpoint()
    want, got = _read(tmp_path / "sync.npz"), _read(tmp_path / "async.npz")
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not list(tmp_path.glob("*.tmp.npz"))


def test_a_read_waits_for_the_write_in_flight(tmp_path, slow_writes):
    """``save`` returns before the file exists (the state is on the host);
    ``load_checkpoint`` waits for it; the snapshot is the state at the
    save, not what the model became after it."""
    model, opt = _trained()
    path = tmp_path / "ck.npz"
    want = {k: v.clone() for k, v in model.state_dict().items()}
    orbax_ckpt.save_checkpoint_orbax(path, model, opt, epoch=0)
    assert not path.exists()
    with torch.no_grad():
        for q in model.parameters():
            q.add_(1.0)  # the step loop goes on
    threading.Timer(0.2, slow_writes.set).start()
    flat, meta = load_checkpoint(path)
    assert meta["epoch"] == 0 and "torch_opt_groups" in meta
    fresh = JSPSR({"lr_dem": 1, "image": 3}, num_feature=8,
                  layers=(1, 1, 1, 1))
    from jspsr_torch.train.checkpoint import load_model_state

    load_model_state(fresh, path)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_an_overwrite_while_a_save_is_in_flight(tmp_path, slow_writes):
    """Two saves to one path: the second waits for the first, and the path
    holds the later state, whole."""
    model, opt = _trained()
    path = tmp_path / "ck.npz"
    orbax_ckpt.save_checkpoint_orbax(path, model, opt, epoch=0)
    threading.Timer(0.2, slow_writes.set).start()
    model2, opt2 = _trained(seed=1)
    orbax_ckpt.save_checkpoint_orbax(path, model2, opt2, epoch=1)
    orbax_ckpt.wait_for_checkpoint()
    save_checkpoint(tmp_path / "want.npz", model2, opt2, epoch=1)
    got, want = _read(path), _read(tmp_path / "want.npz")
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not list(tmp_path.glob("*.tmp.npz"))


def test_preempted_fit_resumes_bitexact_under_the_backend(env, tmp_path):
    """tests/test_torch_preempt.py's first case (``save_every_steps: 1``,
    a crash right after the save at epoch 1 step 1) with
    ``checkpoint_backend: orbax``: the relaunched fit is the uninterrupted
    one; the JAX loader reads the best checkpoint the fit renamed."""
    p = copy.deepcopy(env)
    p.update(save_every_steps=1, checkpoint_backend="orbax")
    a = Trainer(AttrDict(p), result_dir=tmp_path / "A", device="cpu")
    out_a = a.fit(initial_eval=False)
    state_a = _state(a)
    assert not a._preempt_path().exists() and a.last_save_ms is not None

    b = Trainer(AttrDict(p), result_dir=tmp_path / "B", device="cpu")
    save = b._save_preempt

    def crash_after_save(epoch, steps_done, loss_sums, n_samples):
        save(epoch, steps_done, loss_sums, n_samples)
        if epoch == 1 and steps_done == 1:
            raise _Preempted

    b._save_preempt = crash_after_save
    with pytest.raises(_Preempted):
        b.fit(initial_eval=False)
    c = Trainer(AttrDict(p), result_dir=tmp_path / "B", device="cpu")
    assert c.start_epoch == 1 and c._mid_resume[1] == 1
    out_c = c.fit(initial_eval=True)
    state_c = _state(c)
    unequal = [k for k in state_a if not torch.equal(state_a[k], state_c[k])]
    assert not unequal, unequal[:8]
    assert out_c["result"]["RMSE"] == out_a["result"]["RMSE"]
    ck = jax_load_checkpoint(out_c["checkpoint"])
    flat_port, meta = load_checkpoint(out_c["checkpoint"])
    assert ck["epoch"] == meta["epoch"]
    leaves = jax.tree_util.tree_leaves_with_path(ck["params"])
    assert leaves
    for path, leaf in leaves:
        key = "params/" + "/".join(str(getattr(k, "key", k)) for k in path)
        np.testing.assert_array_equal(np.asarray(leaf), flat_port[key])


def test_a_jax_orbax_directory_is_refused(tmp_path):
    """A JAX orbax checkpoint (written here with the JAX package's
    backend) cannot be read on a machine without orbax: the port says so
    and names the ``.npz`` route, for the directory and for a path named
    ``*.orbax``."""
    path = tmp_path / "ck.orbax"
    jax_save_orbax(path, {"conv": {"w": jnp.ones((3, 3, 1, 2))}},
                   {"bn": {"mean": jnp.zeros((2,))}}, epoch=1)
    jax_wait()
    assert path.is_dir()
    for target in (path, tmp_path / "absent.orbax"):
        with pytest.raises(ValueError, match=r"orbax.*\.npz"):
            load_checkpoint(target)
