"""Checkpoint manager of the port: save and restore of the training state
with the reference's layout (``repro/ckpt/manager.py``).

Layout per step::

    <dir>/step_<K>/
        index.json      # step, and per leaf its file, shape, dtype, sha256
        <leafpath>.npy  # one file per leaf, "/" in the path as "__"

Async save (the snapshot is taken before ``save`` returns, the files are
written on a thread; ``wait()`` joins), a sha256 per leaf checked on
restore, retention (``max_to_keep``) and atomic publish (write
``.tmp_step_K``, then rename). Leaves are copied to the host, hashed,
written and read by a pool of ``_IO_WORKERS`` threads (the copies,
hashlib and file I/O release the interpreter lock). On an H100 machine a
17 GB checkpoint was written 3.5x faster by 8 threads than by one; a
training step that runs beside an async write is host-bound and slows
while it runs, more with more threads, for a shorter time (PERF.md
section 6).

The state is a tree of dicts whose leaves are tensors, with a
``torch.nn.Module`` standing for its state dict: the trainer's
``{"params": Transformer, "opt": {"mu": {name: t}, "nu": {name: t},
"step": t}}`` has the leaves ``params/<state-dict name>``,
``opt/mu/<name>``, ``opt/nu/<name>`` and ``opt/step``.

bfloat16: numpy has none, so a bfloat16 leaf is written as its raw 2-byte
words under the descr ``'<V2'``, as the reference's files hold it, with
``"dtype": "bfloat16"`` in the index, and read back as those words viewed
as bfloat16. Restore is bit-exact in every dtype, and reads the
reference's own directories (whose bfloat16 leaves the reference's
manager cannot restore into a target: its ``astype`` has no cast from
``V2``).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

#: the ``.npy`` descr of a bfloat16 leaf, as numpy writes the reference's
#: bfloat16 arrays
_BF16_DESCR = "<V2"
#: threads that copy leaves to the host, hash, write and read them
_IO_WORKERS = min(8, os.cpu_count() or 1)


def _flatten_state_torch(state, prefix=""):
    """[(key, tensor)] of ``state``'s leaves in order: dict keys joined
    with "/", a module's state-dict entries under its key."""
    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    if isinstance(state, dict):
        items = []
        for key, val in state.items():
            items += _flatten_state_torch(val, f"{prefix}{key}/")
        return items
    if not isinstance(state, torch.Tensor):
        raise TypeError(f"{prefix[:-1]}: a checkpoint leaf must be a tensor, "
                        f"got {type(state).__name__}")
    return [(prefix[:-1], state)]


def _snapshot_torch(state):
    """[(key, CPU tensor)]: a copy of every leaf, finished before this
    returns. ``copy=True`` matters on the CPU, where ``.to("cpu")`` would
    return the same tensor, which the next optimizer step updates in
    place."""
    items = _flatten_state_torch(state)
    with ThreadPoolExecutor(_IO_WORKERS) as pool:
        return list(zip([key for key, _ in items], pool.map(
            lambda t: t.detach().to("cpu", copy=True),
            [t for _, t in items])))


def _npy_header_and_words(t: torch.Tensor):
    """(``.npy`` header bytes, the data as a C-contiguous numpy array) of
    the CPU tensor ``t``; a bfloat16 tensor as its int16 words under the
    ``'<V2'`` descr."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        words = t.view(torch.int16).numpy()
        descr = _BF16_DESCR
    else:
        words = t.numpy()
        descr = np.lib.format.dtype_to_descr(words.dtype)
    header = {"descr": descr, "fortran_order": False,
              "shape": tuple(t.shape)}
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, header)
    return buf.getvalue(), words


#: bytes enough for any ``.npy`` header this manager or numpy writes for a
#: plain array (version 1.0 headers are at most 65,535 + 10 bytes)
_HEADER_MAX = 65_546


def _read_leaf_torch(path: Path, meta: dict, verify: bool) -> torch.Tensor:
    """The leaf in ``path`` as a CPU tensor owning its memory, after its
    sha256 is checked against ``meta`` (``IOError`` on a mismatch). The
    file is read once, into the buffer the tensor keeps."""
    raw = bytearray(path.stat().st_size)
    with open(path, "rb") as f:
        if f.readinto(raw) != len(raw):
            raise IOError(f"short read of {path.name}")
    if verify and hashlib.sha256(raw).hexdigest() != meta["sha256"]:
        raise IOError(f"checksum mismatch for {path.name}")
    head = io.BytesIO(bytes(raw[:_HEADER_MAX]))
    version = np.lib.format.read_magic(head)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(head)
    elif version == (2, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(head)
    else:
        raise ValueError(f"{path.name}: .npy version {version} unsupported")
    offset = head.tell()
    count = int(np.prod(shape))
    arr = np.frombuffer(raw, dtype=dtype, count=count, offset=offset)
    arr = arr.reshape(shape, order="F" if fortran else "C")
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _write_leaf_torch(directory: Path, key: str, leaf: torch.Tensor) -> dict:
    """Write ``leaf`` as ``directory/<key with "/" as "__">.npy``; its
    index entry (file, shape, dtype, sha256 of the file's bytes)."""
    fname = key.replace("/", "__") + ".npy"
    header, words = _npy_header_and_words(leaf)
    digest = hashlib.sha256(header)
    digest.update(words)
    with open(directory / fname, "wb") as f:
        f.write(header)
        words.tofile(f)
    return {"file": fname, "shape": list(leaf.shape),
            "dtype": str(leaf.dtype).removeprefix("torch."),
            "sha256": digest.hexdigest()}


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state, block: bool = False):
        """Snapshot ``state`` to host memory, then write it on a thread (or
        before returning, with ``block``)."""
        host_state = _snapshot_torch(state)
        self.wait()
        self._thread = threading.Thread(
            target=self._write_guarded, args=(step, host_state), daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self):
        """Join the writing thread; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_guarded(self, step, host_state):
        try:
            self._write(step, host_state)
        except Exception as err:              # handed to wait()
            self._error = err

    def _write(self, step: int, host_state):
        tmp = self.dir / f".tmp_step_{step}"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        with ThreadPoolExecutor(_IO_WORKERS) as pool:
            metas = list(pool.map(lambda item: _write_leaf_torch(tmp, *item),
                                  host_state))
        index = {"step": step, "leaves": {
            key: meta for (key, _), meta in zip(host_state, metas)}}
        (tmp / "index.json").write_text(json.dumps(index, indent=1))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                       # atomic publish
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.max_to_keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self):
        return sorted(int(p.name.split("_")[1])
                      for p in self.dir.glob("step_*"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target=None, verify: bool = True):
        """Restore a step. With no ``target``: ``{key: CPU tensor}`` of
        every leaf in the directory (the reference's directories too). With
        a ``target`` state: each of its leaves is overwritten in place
        (``copy_``, so a module keeps its identity and its device) from the
        leaf of the same key, and the target is returned. Raises
        ``IOError`` on a checksum mismatch, ``KeyError`` for a leaf the
        checkpoint lacks and ``ValueError`` for a shape that differs (both
        before any leaf is written); after an ``IOError`` the leaves read
        before the bad one are already in the target."""
        d = self.dir / f"step_{step}"
        index = json.loads((d / "index.json").read_text())

        def read(key):
            meta = index["leaves"][key]
            return _read_leaf_torch(d / meta["file"], meta, verify)
        if target is None:
            with ThreadPoolExecutor(_IO_WORKERS) as pool:
                return dict(zip(index["leaves"],
                                pool.map(read, index["leaves"])))
        items = _flatten_state_torch(target)
        for key, tgt in items:
            meta = index["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key}")
            if list(meta["shape"]) != list(tgt.shape):
                raise ValueError(
                    f"{key}: checkpoint shape {tuple(meta['shape'])} != "
                    f"target {tuple(tgt.shape)}")
        with torch.no_grad(), ThreadPoolExecutor(_IO_WORKERS) as pool:
            for (_, tgt), leaf in zip(items, pool.map(
                    read, [key for key, _ in items])):
                tgt.copy_(leaf)
        return target
