"""CNN training: both reference-parity data generation and actual fitting.

The reference's ``trainCNN`` subcommand only *generates labelled training
tables* (eventalign output annotated with CNN calls; reference:
src/trainCNN.cpp:194-360) — the model itself was trained outside the repo.
This module provides:

* ``generate_training_tables`` — the reference-parity path: run the detect
  pipeline and emit eventalign tables annotated with analogue calls
  (trainCNN.cpp:327-335 runs eventalign twice for this);
* ``train_detect_cnn`` — an actual training loop for DetectCNN from
  labelled per-position examples (cross-entropy, AdamW, bf16 compute,
  data-parallel over a device mesh).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Iterator

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..config import SubstrateConfig, DNA_R10
from ..models import cnn as cnn_mod
from ..io.poremodel import PoreModelSet
from .eventalign import run_eventalign
from .prep import prepare_reads
from .source import ReadRecord


# ---------------------------------------------------------------------------
# Reference-parity path: annotated eventalign tables
# ---------------------------------------------------------------------------

def generate_training_tables(records, models: PoreModelSet, model, params,
                             cfg: SubstrateConfig = DNA_R10) -> Iterator[str]:
    """detect pipeline -> calls -> re-run eventalign with calls attached, so
    emitted rows carry per-position EdU/BrdU columns (trainCNN.cpp:327-335).
    Yields one annotated text block per passing read."""
    from .detect import collect_calls, run_cnn_batched

    records = list(records)
    prepped = prepare_reads(records, models, cfg)
    results = run_eventalign(prepped, models, cfg, collect_text=False)
    probs = run_cnn_batched(model, params, results, prepped)
    calls_per_read = {}
    for p in prepped:
        rid = p.record.read_id
        if rid not in probs or not results[rid].qc_passed:
            continue
        d = collect_calls(p.record, results[rid].positions, probs[rid])
        calls_per_read[rid] = {
            int(c): (float(e), float(b))
            for c, e, b in zip(d.ref_coords, d.edu_prob, d.brdu_prob)
        }
    # second eventalign pass with calls attached
    results2 = run_eventalign(prepped, models, cfg, collect_text=True,
                              calls_per_read=calls_per_read)
    for p in prepped:
        res = results2.get(p.record.read_id)
        if res is not None and res.qc_passed and res.text:
            yield res.text


# ---------------------------------------------------------------------------
# Actual model training
# ---------------------------------------------------------------------------

@dataclass
class TrainBatch:
    core_idx: np.ndarray   # (B, L) int32
    residual_idx: np.ndarray
    signal: np.ndarray     # (B, L, RAWDEPTH) f32
    labels: np.ndarray     # (B, L) int32 in {0,1,2}; -1 = ignore
    mask: np.ndarray       # (B, L) bool


def batches_from_labelled_reads(records_and_labels, models: PoreModelSet,
                                cfg: SubstrateConfig = DNA_R10,
                                seq_len: int = 1024,
                                batch_size: int = 8) -> Iterator[TrainBatch]:
    """Build fixed-shape training batches from (ReadRecord, per-ref-position
    label array) pairs by running the alignment pipeline and chunking the
    aligned positions."""
    chunks = []
    recs = [r for r, _ in records_and_labels]
    labels_by_id = {r.read_id: l for r, l in records_and_labels}
    prepped = prepare_reads(recs, models, cfg)
    results = run_eventalign(prepped, models, cfg)
    for p in prepped:
        res = results.get(p.record.read_id)
        if res is None or not res.qc_passed:
            continue
        pos = res.positions
        lab_ref = labels_by_id[p.record.read_id]
        # map aligned positions back to per-ref-index labels
        lab = lab_ref[np.clip(pos.ref_idx, 0, lab_ref.shape[0] - 1)]
        lab = np.where(pos.center_is_T, lab, -1)  # only T positions scored
        n = pos.coord.shape[0]
        for s in range(0, n, seq_len):
            e = min(s + seq_len, n)
            chunks.append((pos.core_idx[s:e], pos.residual_idx[s:e],
                           pos.signal[s:e], lab[s:e]))
    rng = np.random.default_rng(0)
    rng.shuffle(chunks)
    for i in range(0, len(chunks), batch_size):
        group = chunks[i : i + batch_size]
        # the tail group is padded up to batch_size (rows carry label -1
        # everywhere and are masked out of the loss), so every batch shares
        # one compiled shape and small runs still yield training data
        B = batch_size
        core = np.zeros((B, seq_len), dtype=np.int32)
        resid = np.zeros((B, seq_len), dtype=np.int32)
        sig = np.zeros((B, seq_len, cnn_mod.RAWDEPTH), dtype=np.float32)
        lab = np.full((B, seq_len), -1, dtype=np.int32)
        for b, (c, r, s, l) in enumerate(group):
            n = c.shape[0]
            core[b, :n] = c
            resid[b, :n] = r
            sig[b, :n] = s
            lab[b, :n] = l
        yield TrainBatch(core, resid, sig, lab, lab >= 0)


LABEL_IDS = {"Thym": 0, "BrdU": 1, "EdU": 2}  # output column order of the
#                                reference's detect CNN (detect.cpp:686-714)


def reference_arch_trainer(seed: int = 0, learning_rate: float = 3e-4):
    """(model, params, optimizer) for fitting the reference detect-CNN
    topology from scratch — the in-framework path to usable weights when the
    reference's SavedModel shards are unavailable.  BatchNorm moving
    statistics are frozen (they are inference-time constants in the
    checkpoint layout, not weights)."""
    import jax
    from ..models import reference_cnn
    model = reference_cnn.create_model()
    params = reference_cnn.params_from_tensors(
        reference_cnn.synthetic_tensors(seed))
    labels = jax.tree_util.tree_map_with_path(
        lambda p, _: ("freeze" if "moving_" in jax.tree_util.keystr(p)
                      else "train"), params)
    optimizer = optax.multi_transform(
        {"train": optax.adamw(learning_rate), "freeze": optax.set_to_zero()},
        labels)
    return model, params, optimizer


def make_train_step(model, optimizer):
    def loss_fn(params, batch):
        probs = model.apply(params, batch["core"], batch["residual"],
                            batch["signal"])
        logp = jnp.log(jnp.clip(probs, 1e-9, 1.0))
        labels = jnp.clip(batch["labels"], 0, 2)
        nll = -jnp.take_along_axis(logp, labels[..., None], axis=-1)[..., 0]
        mask = batch["mask"].astype(jnp.float32)
        return jnp.sum(nll * mask) / jnp.maximum(jnp.sum(mask), 1.0)

    @jax.jit
    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def train_detect_cnn(batches: Iterator[TrainBatch], model=None, params=None,
                     learning_rate: float = 3e-4, epochs: int = 1,
                     log_every: int = 50, callback=None,
                     checkpoint_path: str = None,
                     checkpoint_every: int = 500, optimizer=None):
    """Fit a detect model (any object with the ``apply(params, core,
    residual, signal) -> (B, L, 3)`` contract — the in-framework DetectCNN or
    the reference topology); returns (params, losses).

    ``checkpoint_path`` enables periodic npz checkpoints (resume by loading
    them with models.cnn.load_params and passing as ``params``) — training
    checkpoint/restart is a new capability over the reference, whose only
    model artifact is the final SavedModel (SURVEY §5)."""
    if model is None:
        model = cnn_mod.create_model()
    if params is None:
        params = cnn_mod.default_params(model)
    if optimizer is None:
        optimizer = optax.adamw(learning_rate)
    opt_state = optimizer.init(params)
    step = make_train_step(model, optimizer)
    losses = []
    global_step = 0
    batch_list = list(batches)
    for _ in range(epochs):
        for i, b in enumerate(batch_list):
            batch = {
                "core": jnp.asarray(b.core_idx),
                "residual": jnp.asarray(b.residual_idx),
                "signal": jnp.asarray(b.signal),
                "labels": jnp.asarray(b.labels),
                "mask": jnp.asarray(b.mask),
            }
            params, opt_state, loss = step(params, opt_state, batch)
            losses.append(float(loss))
            global_step += 1
            if callback and i % log_every == 0:
                callback(i, float(loss))
            if (checkpoint_path is not None
                    and global_step % checkpoint_every == 0):
                cnn_mod.save_params(params, checkpoint_path)
    if checkpoint_path is not None:
        cnn_mod.save_params(params, checkpoint_path)
    return params, losses
