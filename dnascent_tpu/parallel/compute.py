"""Active compute mesh: data-parallel placement for the inference pipelines.

The reference parallelises detect with an OpenMP loop over reads
(reference: src/detect.cpp:852) plus one pinned GPU (src/tensor.cpp:78-82).
The equivalent here is SPMD: every batched kernel call in the pipeline
(banded fill, Theil-Sen, windowed Viterbi, CNN forward)
is batch-parallel in its leading read/window axis, so sharding that axis
over a ``('data',)`` mesh and letting GSPMD partition the program yields
per-row results bitwise identical to the single-device run — N-chip output
equals 1-chip output byte for byte.

Usage: the CLI (or a test) activates a mesh once per process::

    from dnascent_tpu.parallel import compute
    compute.set_compute_mesh(compute.make_data_mesh())   # all local devices

and the pipeline stages route every device placement through
:func:`put_rows` (leading axis sharded over ``data``) or :func:`put_rep`
(replicated — pore-model tables, CNN params, flat side streams indexed by
sharded offset vectors).  With no active mesh both degrade to
``jnp.asarray`` — the single-device behaviour is unchanged.

Batch sizes must be divisible by the mesh's data extent for an even layout;
:func:`pad_rows` rounds a row count up (padded rows carry zeros/sentinels
and are discarded at host collection, exactly like the existing power-of-two
window padding).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_ACTIVE: Optional[Mesh] = None

# host<->device byte counters (benchmark observability): every pipeline
# upload routes through put_rows/put_rep and every download through the
# _enqueue_d2h helpers, so these capture the interconnect traffic that
# dominates on slow links (CLAUDE.md bench notes)
_TRANSFER = {"h2d_bytes": 0, "d2h_bytes": 0}


def reset_transfer_counters() -> None:
    _TRANSFER["h2d_bytes"] = 0
    _TRANSFER["d2h_bytes"] = 0


def transfer_counters() -> dict:
    return dict(_TRANSFER)


def count_d2h(*arrays) -> None:
    for a in arrays:
        try:
            _TRANSFER["d2h_bytes"] += int(np.prod(a.shape)) * a.dtype.itemsize
        except (AttributeError, TypeError):
            pass


def _count_h2d(x) -> None:
    try:
        _TRANSFER["h2d_bytes"] += int(np.prod(np.shape(x))) * x.dtype.itemsize
    except (AttributeError, TypeError):
        pass


def make_data_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D ``('data',)`` mesh over the local (or given) devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("data",))


def set_compute_mesh(mesh: Optional[Mesh]) -> None:
    """Activate (or with None deactivate) the pipeline compute mesh."""
    global _ACTIVE
    if mesh is not None and mesh.devices.ndim != 1:
        raise ValueError("compute mesh must be 1-D over a 'data' axis")
    _ACTIVE = mesh


def get_compute_mesh() -> Optional[Mesh]:
    return _ACTIVE


def data_axis_size() -> int:
    return 1 if _ACTIVE is None else int(_ACTIVE.devices.size)


def pad_rows(n: int) -> int:
    """Round a leading-axis extent up to a multiple of the mesh size."""
    ds = data_axis_size()
    return max(ds, -(-n // ds) * ds)


def put_rows(x) -> jax.Array:
    """Place an array with its leading axis sharded over ``data`` (plain
    ``jnp.asarray`` when no mesh is active).  The leading extent must be a
    multiple of :func:`data_axis_size` — callers pad with :func:`pad_rows`.
    """
    _count_h2d(x)
    if _ACTIVE is None:
        return jnp.asarray(x)
    spec = P(*(("data",) + (None,) * (np.ndim(x) - 1)))
    return jax.device_put(x, NamedSharding(_ACTIVE, spec))


def put_rep(x) -> jax.Array:
    """Place an array replicated over the mesh (plain ``jnp.asarray`` when
    no mesh is active)."""
    _count_h2d(x)
    if _ACTIVE is None:
        return jnp.asarray(x)
    return jax.device_put(x, NamedSharding(_ACTIVE, P()))


def put_rep_tree(tree):
    """Replicate a pytree (model params) over the mesh; identity when no
    mesh is active."""
    if _ACTIVE is None:
        return tree
    return jax.device_put(tree, NamedSharding(_ACTIVE, P()))
