"""Device-mesh construction helpers."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh"]


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Tuple[str, ...] = ("dp", "tp"),
    devices=None,
) -> Mesh:
    """Build a mesh over the available devices.

    Default layout puts all devices on the data-parallel (batch) axis with a
    trivial tensor-parallel axis; pass ``axis_sizes`` to split. The devices
    are laid out in ``jax.devices()`` order: the cards of one host are
    joined all to all, so no ordering is better than another.
    """
    devices = devices if devices is not None else jax.devices()
    ndev = len(devices)
    if axis_sizes is None:
        axis_sizes = (ndev,) + (1,) * (len(axis_names) - 1)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    if int(np.prod(axis_sizes)) != ndev:
        raise ValueError(f"mesh {axis_sizes} does not match {ndev} devices")
    arr = np.asarray(devices).reshape(axis_sizes)
    return Mesh(arr, axis_names[: len(axis_sizes)])
