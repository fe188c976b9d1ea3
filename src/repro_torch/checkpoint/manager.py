"""Fault-tolerant checkpointing: atomic commits, retention, restore.

Port of ``repro/checkpoint/manager.py`` with the same layout on disk, so
a checkpoint written by one package restores in the other:

    <dir>/step_000000123.tmp-<pid>/   (write in progress)
        shard_000.npz                 (flattened leaves, 64 a shard)
        manifest.json                 (step, n_leaves, dtypes, shapes)
    <dir>/step_000000123/             (atomic rename = commit)

Leaves come in ``jax.tree_util``'s order: a dict by sorted key, a list
or tuple in order, a dataclass by its fields (``AdamWState`` as
``(m, v, step)``), ``None`` holding no leaf.  ``tree_flatten`` and
``tree_unflatten`` below give that order; ``optim`` and ``convert`` use
them too.

bfloat16: numpy has no such dtype without ``ml_dtypes``, which the card
machine lacks.  A bf16 leaf is saved as a 2-byte void array of its bits
(the data bytes are what the reference writes; only the ``.npy``
header's dtype string may differ) and the manifest says ``bfloat16``;
``restore`` reads the manifest's ``dtypes`` and views those bits as
``torch.bfloat16``.

``restore`` reads each stored (uncompressed) member of a shard straight
from its offset in the file with ``np.fromfile``, where ``np.load``
copies a member through ``zipfile`` 256 KB at a time and checks its
CRC: a full-width LM state is ~13 GB.  The atomic commit is what
guarantees a complete checkpoint.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import struct
import zipfile
from typing import Any, Iterator, Optional

import numpy as np
import torch

BF16_BITS = np.dtype("V2")


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------
def _flatten(x, leaves: list):
    if x is None:
        return ("none",)
    if isinstance(x, dict):
        keys = sorted(x)
        return ("dict", tuple(keys), tuple(_flatten(x[k], leaves)
                                           for k in keys))
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_flatten(c, leaves) for c in x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        names = tuple(f.name for f in dataclasses.fields(x))
        return ("dataclass", type(x), names,
                tuple(_flatten(getattr(x, n), leaves) for n in names))
    leaves.append(x)
    return ("leaf",)


def tree_flatten(tree) -> tuple[list, Any]:
    """-> (leaves, treedef) in ``jax.tree_util``'s leaf order.  (Module
    functions, not a recursive closure: a closure that calls itself is a
    reference cycle, and would hold every leaf, a model's parameters or
    gradients, until the cyclic garbage collector ran.)"""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def _unflatten(d, it):
    kind = d[0]
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _unflatten(c, it) for k, c in zip(d[1], d[2])}
    if kind == "dataclass":
        return d[1](**{n: _unflatten(c, it) for n, c in zip(d[2], d[3])})
    return d[0](_unflatten(c, it) for c in d[1])


def tree_unflatten(treedef, leaves) -> Any:
    it = iter(leaves)
    out = _unflatten(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree):
    """``fn`` over the leaves of ``tree``, in the same structure."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(x) for x in leaves])


# ---------------------------------------------------------------------------
# leaves <-> numpy (bf16 as its bits)
# ---------------------------------------------------------------------------
def leaf_to_numpy(x) -> np.ndarray:
    """A host numpy copy of a leaf; a bf16 tensor as a |V2 array of its
    bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).cpu().numpy().view(BF16_BITS)
        return x.cpu().numpy()
    return np.asarray(x)


def dtype_name(a: np.ndarray) -> str:
    """The manifest's dtype string: ``bfloat16`` for a 2-byte void (or
    an ``ml_dtypes`` bfloat16) array, else numpy's name."""
    if a.dtype == BF16_BITS or a.dtype.name == "bfloat16":
        return "bfloat16"
    return str(a.dtype)


def leaf_from_numpy(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A tensor on ``device`` from a host array whose dtype the manifest
    names ``dtype`` (``bfloat16``: the array holds the bits)."""
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, order="C")         # a writable C-order copy
    if dtype == "bfloat16":
        if a.dtype.itemsize != 2:
            raise TypeError(f"a bfloat16 leaf needs 2-byte items, got "
                            f"{a.dtype}")
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        if str(a.dtype) != dtype:
            raise TypeError(f"leaf has dtype {a.dtype}, manifest says "
                            f"{dtype}")
        t = torch.from_numpy(a)
    return t.to(device)


def read_npz(path: str) -> Iterator[tuple[str, np.ndarray]]:
    """(name, array) of each member of an ``np.savez`` file (stored, not
    compressed), read from its offset in the file (no CRC check)."""
    fmt = np.lib.format
    with zipfile.ZipFile(path) as zf, open(path, "rb") as raw:
        for info in zf.infolist():
            name = info.filename[:-len(".npy")]
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: {name} is compressed; a "
                                 "checkpoint shard is written by np.savez")
            raw.seek(info.header_offset)
            head = raw.read(30)                # the local file header
            n_name, n_extra = struct.unpack("<HH", head[26:30])
            raw.seek(info.header_offset + 30 + n_name + n_extra)
            version = fmt.read_magic(raw)
            read_header = (fmt.read_array_header_1_0 if version == (1, 0)
                           else fmt.read_array_header_2_0)
            shape, fortran, dtype = read_header(raw)
            if dtype.hasobject:
                raise ValueError(f"{path}: {name} holds Python objects")
            a = np.fromfile(raw, dtype=dtype, count=math.prod(shape))
            yield name, (a.reshape(shape[::-1]).T if fortran
                         else a.reshape(shape))


# ---------------------------------------------------------------------------
class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 chunk_leaves: int = 64):
        self.dir = directory
        self.keep = keep
        self.chunk = chunk_leaves
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp" not in name:
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any) -> str:
        self._gc_tmp()
        leaves, treedef = tree_flatten(state)
        tmp = self._step_dir(step) + f".tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        dtypes, shapes = [], []
        for ci in range(0, len(leaves), self.chunk):
            # one shard's host copies at a time: a full-width state is
            # tens of GB
            chunk = [leaf_to_numpy(x) for x in leaves[ci:ci + self.chunk]]
            dtypes += [dtype_name(a) for a in chunk]
            shapes += [list(a.shape) for a in chunk]
            np.savez(os.path.join(tmp, f"shard_{ci // self.chunk:03d}.npz"),
                     **{f"leaf_{ci + j}": a for j, a in enumerate(chunk)})
            del chunk
        manifest = {
            "step": step,
            "n_leaves": len(leaves),
            "treedef": repr(treedef),
            "dtypes": dtypes,
            "shapes": shapes,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic commit
        self._retain()
        return final

    def restore(self, like: Any, step: Optional[int] = None, *,
                device=None) -> tuple[int, Any]:
        """-> (step, state).

        ``like``: a tree with the target structure; the manifest stores
        leaf metadata but the structure comes from the caller.  Each
        leaf lands on ``device`` if given, else on the device of the
        matching leaf of ``like`` (the CPU for a leaf that is not a
        tensor): the port's stand-in for the reference's
        ``shardings``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        like_leaves, treedef = tree_flatten(like)
        if len(like_leaves) != manifest["n_leaves"]:
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, target "
                f"structure has {len(like_leaves)}")
        leaves: list[Any] = [None] * manifest["n_leaves"]
        for name in sorted(os.listdir(d)):
            if not name.startswith("shard_"):
                continue
            for key, a in read_npz(os.path.join(d, name)):
                i = int(key.split("_")[1])
                dev = device if device is not None else (
                    like_leaves[i].device
                    if isinstance(like_leaves[i], torch.Tensor) else "cpu")
                leaves[i] = leaf_from_numpy(a, manifest["dtypes"][i], dev)
        return step, tree_unflatten(treedef, leaves)

    # ------------------------------------------------------------------
    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def _gc_tmp(self) -> None:
        for name in os.listdir(self.dir):
            if ".tmp-" in name:
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)
