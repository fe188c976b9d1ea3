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
"""
from __future__ import annotations

import numpy as np
import torch

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
