"""Carry a dense-overlay device index across as numpy arrays.

``device_index_from_numpy`` takes the fields of a reference
``DeviceIndex`` (as numpy arrays, e.g. ``np.asarray(getattr(dix, name))``
for every name in ``FIELD_DTYPES``) and returns the port's index on
``device``; ``device_index_to_numpy`` is the reverse.  The port can then
serve from an index the reference built, and the tests can hold the
serve side apart from the build side.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.device_engine import FIELD_DTYPES, DeviceIndex, resolve_device


def device_index_from_numpy(fields: dict, device=None) -> DeviceIndex:
    """Port ``DeviceIndex`` on ``device`` (default ``cuda``) from a dict
    of numpy arrays holding every dense field, with the reference's
    dtypes.  Raises on a missing field, a wrong dtype, or a hierarchical
    index (whose dense overlay is a placeholder the port cannot serve
    from)."""
    if len(fields.get("sf_of", ())):
        raise ValueError("hierarchical index (sf_of is non-empty): the "
                         "port serves dense-overlay indices only")
    dev = resolve_device(device)
    tensors = {}
    for name, dtype in FIELD_DTYPES.items():
        if name not in fields:
            raise KeyError(f"missing DeviceIndex field {name!r}")
        arr = np.array(fields[name], order="C")      # a writable copy
        t = torch.from_numpy(arr)
        if t.dtype != dtype:
            raise TypeError(f"field {name!r} has dtype {arr.dtype}, "
                            f"expected {dtype}")
        tensors[name] = t.to(dev)
    return DeviceIndex(**tensors,
                       host_ov_slot=fields.get("host_ov_slot"))


def device_index_to_numpy(dix: DeviceIndex) -> dict:
    """Every dense field of ``dix`` as a host numpy array."""
    out = {name: getattr(dix, name).cpu().numpy() for name in FIELD_DTYPES}
    if dix.host_ov_slot is not None:
        out["host_ov_slot"] = dix.host_ov_slot
    return out
