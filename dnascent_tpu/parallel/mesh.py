"""Device mesh + sharding strategy.

The reference's only parallelism is OpenMP threads over reads plus a single
pinned GPU (reference: src/detect.cpp:852, src/tensor.cpp:78-82).  This
framework replaces that with SPMD over a JAX mesh:

* axis ``data``  — reads (and CNN training batches) are sharded;
* axis ``seq``   — ultra-long reads' CNN inputs are sharded along the
  position dimension (the conv stack's receptive field is local, so a halo
  exchange of ``halo`` positions makes sequence sharding exact);
* pore-model tables and CNN parameters are replicated.

Multi-host: ``jax.distributed`` initialises per host; input files are
assigned per host (shard-by-file), outputs merged deterministically by
(contig, start, read_id) ordering.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_data: Optional[int] = None, n_seq: int = 1,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_data is None:
        n_data = n // n_seq
    assert n_data * n_seq <= n, (n_data, n_seq, n)
    dev = np.asarray(devices[: n_data * n_seq]).reshape(n_data, n_seq)
    return Mesh(dev, ("data", "seq"))


def data_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, *arrays):
    """Place host arrays with the batch dimension sharded over ``data``."""
    out = []
    for a in arrays:
        spec = P("data", *([None] * (a.ndim - 1)))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out)


def replicate(mesh: Mesh, tree):
    return jax.device_put(tree, replicated(mesh))


# ---------------------------------------------------------------------------
# Sequence-sharded CNN apply (halo exchange over the position axis)
# ---------------------------------------------------------------------------

def sequence_sharded_apply(model, mesh: Mesh, halo: Optional[int] = None):
    """Build a jit-compiled CNN apply with batch sharded over ``data`` and
    the position axis sharded over ``seq``.

    XLA inserts the halo exchanges for the spatially-convolved dimension
    automatically when the inputs carry a ``seq`` sharding — the conv stack's
    receptive field (~500 positions) is tiny next to useful shard lengths, so
    the collectives ride ICI and overlap with compute.
    """
    in_spec = (P(), P("data", "seq"), P("data", "seq"), P("data", "seq", None))
    out_spec = P("data", "seq", None)

    @functools.partial(
        jax.jit,
        in_shardings=tuple(NamedSharding(mesh, s) for s in in_spec),
        out_shardings=NamedSharding(mesh, out_spec),
        static_argnames=())
    def apply(params, core_idx, residual_idx, signal):
        return model.apply(params, core_idx, residual_idx, signal)

    return apply


def data_parallel_train_step(model, optimizer, mesh: Mesh):
    """DP+SP training step: batch over ``data``, sequence over ``seq``,
    replicated params; gradients all-reduce via XLA's sharding propagation."""
    import optax

    def loss_fn(params, batch):
        probs = model.apply(params, batch["core"], batch["residual"],
                            batch["signal"])
        logp = jnp.log(jnp.clip(probs, 1e-9, 1.0))
        labels = jnp.clip(batch["labels"], 0, 2)
        nll = -jnp.take_along_axis(logp, labels[..., None], axis=-1)[..., 0]
        mask = batch["mask"].astype(jnp.float32)
        return jnp.sum(nll * mask) / jnp.maximum(jnp.sum(mask), 1.0)

    batch_spec = {
        "core": P("data", "seq"),
        "residual": P("data", "seq"),
        "signal": P("data", "seq", None),
        "labels": P("data", "seq"),
        "mask": P("data", "seq"),
    }

    @functools.partial(
        jax.jit,
        in_shardings=(NamedSharding(mesh, P()), NamedSharding(mesh, P()),
                      {k: NamedSharding(mesh, v) for k, v in batch_spec.items()}),
        out_shardings=(NamedSharding(mesh, P()), NamedSharding(mesh, P()),
                       NamedSharding(mesh, P())))
    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host initialisation (new subsystem — the reference has no
    distributed backend; SURVEY §5)."""
    if coordinator is not None:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)


def shard_files_for_host(paths: list, process_index: Optional[int] = None,
                         process_count: Optional[int] = None) -> list:
    """Deterministic per-host input assignment (shard by file)."""
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    return [p for i, p in enumerate(sorted(paths)) if i % pc == pi]
