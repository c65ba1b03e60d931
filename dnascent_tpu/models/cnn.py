"""The detect CNN interface: per-position BrdU/EdU/thymidine classifier.

The reference runs a TensorFlow SavedModel through the TF C API with three
inputs and one output (reference: src/detect.cpp:577-732, src/tensor.cpp):

  input 1: core sequence index, (1, L) — middle 5-mer of each 9-mer, base-4
           encoded + 1 (reads.h:112-124)
  input 2: residual sequence index, (1, L) — outer 4 bases + 1
           (reads.h:125-138)
  input 3: signal, (1, L, 20, 1) — up to RAWDEPTH=20 scaled raw samples per
           reference position, zero padded (reads.h:147-172)
  output:  (L, 3) probabilities ordered [unmodified-T, BrdU, EdU]
           (detect.cpp:686-714)

This module holds what every model shares and needs no flax: the input
constants and u8 signal quantisation, the jitted forward wrappers the detect
pipeline calls (they only use ``model.apply``), and npz parameter I/O.  The
models themselves are ``models/reference_cnn`` (the reference's trained
topology) and ``models/detect_cnn`` (the in-framework flax DetectCNN, imported
only when it is used).
"""

from __future__ import annotations

import functools
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np

CORE_VOCAB = 4 ** 5 + 2      # +1 shift, 0 reserved for padding
RESIDUAL_VOCAB = 4 ** 4 + 2
RAWDEPTH = 20                # reads.h:12
N_CLASSES = 3                # [unmodified-T, BrdU, EdU]

# u8 signal-transfer quantisation: q=0 is padding; valid samples map the
# normalised range [-6, 6] onto [1, 255]
SIG_QUANT_LO, SIG_QUANT_HI = -6.0, 6.0
SIG_QUANT_SCALE = 254.0 / (SIG_QUANT_HI - SIG_QUANT_LO)


def quantise_signal_u8(sig: np.ndarray) -> np.ndarray:
    """Host-side u8 quantisation for cheap transfer (pad stays 0)."""
    q = np.clip(np.rint((sig - SIG_QUANT_LO) * SIG_QUANT_SCALE) + 1.0,
                1.0, 255.0).astype(np.uint8)
    return np.where(sig == 0.0, np.uint8(0), q)


def create_model(**kwargs):
    """The in-framework DetectCNN (imports flax; see models/detect_cnn)."""
    from .detect_cnn import create_model as _create
    return _create(**kwargs)


def default_params(model=None, seed: int = 0):
    """Deterministic fallback DetectCNN parameters used when no trained
    weights are available (the reference's weight files are absent from
    its mount)."""
    from .detect_cnn import default_params as _default
    return _default(model, seed)


@functools.partial(jax.jit, static_argnames=("model",))
def apply_model(model, params, core_idx, residual_idx, signal):
    return model.apply(params, core_idx, residual_idx, signal)


@functools.partial(jax.jit, static_argnames=("model",))
def apply_model_f16(model, params, core_idx, residual_idx, signal):
    """f16 output transfer: halves the probability download (quantised to
    uint8 for modbam anyway; human-readable prints are model outputs, not
    reference-parity values)."""
    return model.apply(params, core_idx, residual_idx,
                       signal).astype(jnp.float16)


def _t_index_from_deltas(t_delta_u16):
    """Reconstruct flat B*L centre-T indices from u16 increments (first
    entry holds the first index; cross-read jumps stay < 2L < 65536 for the
    position buckets in use, so u16 is lossless)."""
    return jnp.cumsum(t_delta_u16.astype(jnp.int32))


def _sig_from_flat(flat_sig_u8, counts_u8, B, L):
    """Rebuild the (B, L, RAWDEPTH) u8 window matrix from the flat stream +
    per-position counts with a cumsum + gather (device side)."""
    counts = counts_u8.astype(jnp.int32).reshape(B * L)
    offs = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1]])
    j = jnp.arange(RAWDEPTH, dtype=jnp.int32)
    idx = offs[:, None] + j[None, :]
    valid = j[None, :] < counts[:, None]
    flat = flat_sig_u8.astype(jnp.int32)
    sig_q = jnp.where(valid, flat[jnp.clip(idx, 0, flat.shape[0] - 1)], 0)
    return sig_q.astype(jnp.uint8).reshape(B, L, RAWDEPTH)


@functools.partial(jax.jit, static_argnames=("model",))
def apply_model_flat_f16(model, params, core_idx, residual_idx,
                         flat_sig_u8, counts_u8, t_delta_u16):
    """Transfer-lean forward for slow interconnects.

    Per-position raw-sample windows arrive as one flat u8 stream plus a
    per-position count (instead of the zero-padded (B, L, RAWDEPTH) matrix —
    roughly half the bytes at typical stay lengths); the window matrix is
    reconstructed on device with a cumsum + gather.  Output probabilities
    are gathered at the centre-T positions (u16 index increments, rebuilt on
    device — the only positions the caller reports, detect.cpp:690) and only
    the [BrdU, EdU] columns come back (detect unpacks just those two,
    detect.cpp:698), so the download shrinks ~3x.
    """
    B, L = core_idx.shape
    sig = _sig_from_flat(flat_sig_u8, counts_u8, B, L)
    probs = model.apply(params, core_idx, residual_idx, sig)
    t_index = _t_index_from_deltas(t_delta_u16)
    return probs.reshape(B * L, -1)[t_index, 1:].astype(jnp.float16)


@functools.partial(jax.jit, static_argnames=("model",))
def apply_model_flat_f16_packed(model, params, core_idx,
                                residual_idx, sig_payload, sig_widths,
                                sig_mins, counts_u8, t_delta_u16):
    """Same as :func:`apply_model_flat_f16` but the flat u8 signal stream
    arrives block-bit-packed (~6 bits/sample instead of 8; see
    ops/blockpack.py) and is reconstructed bit-exactly on device."""
    from ..ops import blockpack as _bpk
    B, L = core_idx.shape
    flat_sig_u8 = _bpk.unpack_u8(sig_payload, sig_widths, sig_mins,
                                 sig_widths.shape[0] * _bpk.BLOCK)
    sig = _sig_from_flat(flat_sig_u8, counts_u8, B, L)
    probs = model.apply(params, core_idx, residual_idx, sig)
    t_index = _t_index_from_deltas(t_delta_u16)
    return probs.reshape(B * L, -1)[t_index, 1:].astype(jnp.float16)


@functools.partial(jax.jit, static_argnames=("model",))
def apply_model_from_flat_ranks_f16(model, params, ks_base,
                                    ks_delta, flat_off, n_pos, flat_ranks,
                                    flat_sig_u8, counts_u8, t_delta_u16):
    """Most transfer-lean forward: the two sequence-index planes are derived
    on device from the batch's resident flat k-mer-rank array (uploaded once
    by prep as u8 codes), so the call ships only per-position kmer-start
    deltas (u8 when they fit, u16 otherwise) plus the flat signal stream.
    (Deriving the T-position index on device via jnp.nonzero was tried and
    measured ~10% slower end-to-end — the compaction costs more than the
    2-byte-per-T-position upload saves.)

    ``ks_base``/``ks_delta``: per-row first kmer_start and non-negative
    position-to-position increments (cumsum reconstructs kmer_start);
    ``flat_off``: per-row offset of the read's ranks in ``flat_ranks``;
    ``n_pos``: per-row valid position count (padding gets index 0, the
    embedding tables' padding row); ``t_delta_u16``: u16 increments of the
    flat B*L centre-T indices.  Only [BrdU, EdU] columns come back.
    """
    B, L = ks_delta.shape
    core_idx, residual_idx = _idx_planes_from_ranks(
        ks_base, ks_delta, flat_off, n_pos, flat_ranks)
    sig = _sig_from_flat(flat_sig_u8, counts_u8, B, L)
    probs = model.apply(params, core_idx, residual_idx, sig)
    t_index = _t_index_from_deltas(t_delta_u16)
    return probs.reshape(B * L, -1)[t_index, 1:].astype(jnp.float16)


def _idx_planes_from_ranks(ks_base, ks_delta, flat_off, n_pos, flat_ranks):
    """Derive the core/residual embedding-index planes on device from the
    resident flat k-mer-rank array + per-position kmer-start deltas."""
    from ..ops.seqcodes import (core_index_from_ranks,
                                residual_index_from_ranks)
    L = ks_delta.shape[1]
    ks = ks_base[:, None] + jnp.cumsum(ks_delta.astype(jnp.int32), axis=1)
    in_pos = jnp.arange(L, dtype=jnp.int32)[None, :] < n_pos[:, None]
    gidx = jnp.clip(flat_off[:, None] + ks, 0, flat_ranks.shape[0] - 1)
    rank = flat_ranks[gidx]
    core_idx = jnp.where(in_pos, core_index_from_ranks(rank), 0)
    residual_idx = jnp.where(in_pos, residual_index_from_ranks(rank), 0)
    return core_idx, residual_idx


@functools.partial(jax.jit, static_argnames=("model", "L"))
def apply_model_from_flat_ranks_f16_packed(model, params, ks_base,
                                           flat_off, n_pos, flat_ranks,
                                           sig_payload, sig_widths, sig_mins,
                                           aux_payload, aux_widths, aux_mins,
                                           td_payload, td_widths, td_mins,
                                           L: int):
    """Fully block-bit-packed forward (ops/blockpack.py): the flat u8
    signal stream (~6 of 8 bits used), the per-position sample counts +
    kmer-start deltas (concatenated into one ``aux`` stream, ~7 of 16
    combined bits used), and the u16 centre-T index increments (~4 of 16
    bits) all arrive packed and are reconstructed bit-exactly on device.
    Everything downstream of the unpacks matches
    :func:`apply_model_from_flat_ranks_f16` operation for operation."""
    from ..ops import blockpack as _bpk
    B = n_pos.shape[0]
    aux = _bpk.unpack_u8(aux_payload, aux_widths, aux_mins, 2 * B * L)
    counts_u8 = aux[: B * L]
    ks_delta = aux[B * L:].reshape(B, L)
    core_idx, residual_idx = _idx_planes_from_ranks(
        ks_base, ks_delta, flat_off, n_pos, flat_ranks)
    flat_sig_u8 = _bpk.unpack_u8(sig_payload, sig_widths, sig_mins,
                                 sig_widths.shape[0] * _bpk.BLOCK)
    sig = _sig_from_flat(flat_sig_u8, counts_u8, B, L)
    probs = model.apply(params, core_idx, residual_idx, sig)
    t_delta = _bpk.unpack_u16(td_payload, td_widths, td_mins,
                              td_widths.shape[0] * _bpk.BLOCK)
    t_index = _t_index_from_deltas(t_delta)
    return probs.reshape(B * L, -1)[t_index, 1:].astype(jnp.float16)


# ---------------------------------------------------------------------------
# Parameter persistence (npz; orbax used for training checkpoints elsewhere)
# ---------------------------------------------------------------------------

def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def save_params(params, path: str) -> None:
    """Write a parameter tree as an npz of '/'-joined paths."""
    np.savez(path, **{k: np.asarray(v) for k, v in _flatten(params).items()})


def load_params(path: str) -> dict:
    """Read :func:`save_params` output back into a nested dict."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = jnp.asarray(data[key])
    return tree
