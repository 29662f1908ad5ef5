"""Mesh construction helpers."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    data: int = 1,
    docs: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ("data", "docs") mesh over the available devices.

    ``docs`` defaults to all remaining devices after the data axis.  Device
    order follows jax.devices(); the cards of one host are joined all to
    all by NVLink, so the order does not change the all-gather's cost.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if docs is None:
        if n % data:
            raise ValueError(f"{n} devices not divisible by data={data}")
        docs = n // data
    if data * docs != n:
        raise ValueError(f"mesh {data}x{docs} != {n} devices")
    arr = np.array(devices).reshape(data, docs)
    return Mesh(arr, axis_names=("data", "docs"))
