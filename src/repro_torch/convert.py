"""Carry a device index across as numpy arrays.

``device_index_from_numpy`` takes the fields of a reference
``DeviceIndex`` as numpy arrays (``np.asarray(getattr(dix, name))`` for
every name in ``FIELD_DTYPES``, and a sequence of arrays for every
per-level name in ``TUPLE_FIELD_DTYPES`` on hierarchical indices) and
returns the port's index on ``device``; ``device_index_to_numpy`` is the
reverse.  The host sidecars (``host_ov_slot``, ``host_l2_slot``,
``host_res_frag``, ``host_topgrp_frag``, ``host_hub_agent``) pass
through as they are.  The port can then serve from an index the
reference built, and the tests can hold the serve side apart from the
build side.

``tree_from_numpy`` / ``tree_to_numpy`` do the same for model parameter
trees and optimizer states (nested dicts, lists, tuples, ``AdamWState``)
in the reference's leaf order: bfloat16 travels as its bits (a 2-byte
void array, or an ``ml_dtypes`` bfloat16 array from the reference), so
both packages can be given the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from .checkpoint.manager import (dtype_name, leaf_from_numpy,
                                 leaf_to_numpy, tree_flatten, tree_map,
                                 tree_unflatten)
from .core.device_engine import (FIELD_DTYPES, SIDECARS,
                                 TUPLE_FIELD_DTYPES, DeviceIndex,
                                 resolve_device)


def _tensor(name: str, arr, dtype: torch.dtype,
            dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, order="C"))   # a writable copy
    if t.dtype != dtype:
        raise TypeError(f"field {name!r} has dtype {np.asarray(arr).dtype}"
                        f", expected {dtype}")
    return t.to(dev)


def device_index_from_numpy(fields: dict, device=None) -> DeviceIndex:
    """Port ``DeviceIndex`` on ``device`` (default ``cuda``) from a dict
    of numpy arrays with the reference's dtypes.  Every name of
    ``FIELD_DTYPES`` is required; a per-level name that is absent (or an
    empty sequence) means a dense index.  Raises on a missing field or a
    wrong dtype."""
    dev = resolve_device(device)
    tensors = {}
    for name, dtype in FIELD_DTYPES.items():
        if name not in fields:
            raise KeyError(f"missing DeviceIndex field {name!r}")
        tensors[name] = _tensor(name, fields[name], dtype, dev)
    for name, dtype in TUPLE_FIELD_DTYPES.items():
        tensors[name] = tuple(
            _tensor(f"{name}[{li}]", arr, dtype, dev)
            for li, arr in enumerate(fields.get(name, ())))
    levels = {len(tensors[name]) for name in TUPLE_FIELD_DTYPES}
    if len(levels) != 1:
        raise ValueError(f"per-level fields disagree on the number of "
                         f"levels: {sorted(levels)}")
    return DeviceIndex(**tensors,
                       **{k: fields.get(k) for k in SIDECARS})


def device_index_to_numpy(dix: DeviceIndex) -> dict:
    """Every field of ``dix`` as host numpy arrays (a list of arrays per
    per-level field), plus the host sidecars that are set."""
    out = {name: getattr(dix, name).cpu().numpy() for name in FIELD_DTYPES}
    for name in TUPLE_FIELD_DTYPES:
        out[name] = [t.cpu().numpy() for t in getattr(dix, name)]
    for name in SIDECARS:
        if getattr(dix, name) is not None:
            out[name] = getattr(dix, name)
    return out


#: numpy leaf dtypes a tree may carry across (bfloat16 as its bits)
TREE_DTYPES = ("float32", "int32", "bfloat16")


def tree_from_numpy(tree, device=None, like=None):
    """The tree of numpy arrays ``tree`` as tensors on ``device``
    (default ``cuda``).  A leaf must be float32, int32 or bfloat16 bits;
    with ``like`` (a tree of tensors of the same structure) each leaf
    must also have its dtype and shape.  Raises otherwise."""
    dev = resolve_device(device)
    leaves, treedef = tree_flatten(tree)
    want = None
    if like is not None:
        want, like_def = tree_flatten(like)
        if len(want) != len(leaves) or repr(like_def) != repr(treedef):
            raise ValueError("tree structure differs from like's")
    out = []
    for i, a in enumerate(leaves):
        a = np.asarray(a)
        name = dtype_name(a)
        if name not in TREE_DTYPES:
            raise TypeError(f"leaf {i} has dtype {a.dtype}; expected one "
                            f"of {TREE_DTYPES}")
        t = leaf_from_numpy(a, name, dev)
        if want is not None and (t.dtype != want[i].dtype
                                 or t.shape != want[i].shape):
            raise TypeError(f"leaf {i} is {t.dtype}{tuple(t.shape)}, "
                            f"expected {want[i].dtype}"
                            f"{tuple(want[i].shape)}")
        out.append(t)
    return tree_unflatten(treedef, out)


def tree_to_numpy(tree):
    """Host numpy copies of every leaf (bfloat16 as a |V2 array of its
    bits), in the same structure."""
    return tree_map(leaf_to_numpy, tree)
