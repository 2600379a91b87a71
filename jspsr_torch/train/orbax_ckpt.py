"""The asynchronous checkpoint backend (``checkpoint_backend: orbax``;
counterpart of ``jspsr_tpu/train/orbax_ckpt.py``, whose name it keeps so
that a reader finds it; it imports no orbax).

What the JAX backend gives a user, this gives too:

- ``save_checkpoint_orbax`` returns once the state is copied to host
  memory; the file is written on a background thread, so the step loop
  does not wait on the disk. A save first waits for the one before it, so
  at most one snapshot is held beside the model, and writes land in the
  order they were made (two saves to one path leave the later one).
- ``wait_for_checkpoint()`` blocks until the write in flight has landed
  and raises what it raised. ``checkpoint.load_checkpoint`` calls it
  before reading, the Trainer before renaming a checkpoint and before
  ``fit`` returns; the writer's thread is joined at interpreter exit.
- The commit is atomic: the bytes go to a temporary name that is renamed
  over the path, so a crash mid-write leaves the previous checkpoint.
- The contents are the synchronous backend's: the same ``.npz`` bytes
  (``checkpoint.checkpoint_arrays``: parameters and BatchNorm state in
  the JAX layout, the optimizer's leaves under ``torch_opt/``, the meta
  with ``torch_opt_groups`` and the caller's ``extra``). Both packages'
  ``.npz`` loaders read them; the file names are the ``.npz`` backend's.

The writer is one per process, as the JAX backend's checkpointer is: a
Trainer made again in the same process (a relaunch) waits for the writes
of the one before it.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import torch

from jspsr_torch.parallel.mesh import is_writer
from jspsr_torch.train.checkpoint import checkpoint_arrays, write_npz


class AsyncCheckpointWriter:
    """One background thread that writes ``.npz`` snapshots in order."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt-writer")
        self._lock = threading.Lock()
        self._pending: Future | None = None

    def wait(self) -> None:
        """Block until the write in flight (if any) has landed."""
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def save(self, path, arrays: dict) -> Future:
        """Write ``arrays`` (host copies) to ``path`` in the background."""
        self.wait()
        future = self._pool.submit(write_npz, Path(path), arrays)
        with self._lock:
            self._pending = future
        return future


_WRITER: AsyncCheckpointWriter | None = None
_WRITER_LOCK = threading.Lock()


def _writer() -> AsyncCheckpointWriter:
    global _WRITER
    with _WRITER_LOCK:
        if _WRITER is None:
            _WRITER = AsyncCheckpointWriter()
        return _WRITER


def save_checkpoint_orbax(path, model: torch.nn.Module, optimizer=None,
                          epoch: int = 0, best_result=None,
                          extra: dict | None = None) -> Path:
    """``checkpoint.save_checkpoint``'s file, written asynchronously:
    returns once the state is on the host. Under a process group only
    rank 0 writes (the JAX backend lets orbax coordinate every process's
    writes; this one writes one ``.npz``)."""
    if not is_writer():
        return Path(path)
    writer = _writer()
    writer.wait()  # the previous snapshot is written before this one
    writer.save(path, checkpoint_arrays(model, optimizer, epoch,
                                        best_result, extra))
    return Path(path)


def wait_for_checkpoint() -> None:
    """Block until the asynchronous save in flight (if any) is committed;
    call before renaming or reading a checkpoint just saved."""
    if _WRITER is not None:
        _WRITER.wait()
