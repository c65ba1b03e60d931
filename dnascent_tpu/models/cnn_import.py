"""Import reference-trained detect-CNN weights from a TF SavedModel.

The reference loads ``dnn_models/detect_model_BrdUEdU_DNAr10_4_1`` through the
TensorFlow C API (src/tensor.cpp:24-105, src/detect.cpp:576-719).  A user
migrating to this framework brings that SavedModel directory; this module
reads its tensor bundle WITHOUT TensorFlow (see
:mod:`dnascent_tpu.io.tf_bundle`) and re-exports the weights as the npz
format used throughout this package.

The trained checkpoint decomposes exactly into (see
``reference_cnn_manifest.json``, extracted from the shipped index):

* ``layer_with_weights-0/1`` — two stacked Keras GRU(16) cells
  (kernel ``(in,48)``, recurrent ``(16,48)``, bias ``(2,48)``; reset_after)
  encoding the per-position 20-sample raw-signal window
  (reads.h:147-171 builds that window);
* 30 SeparableConv1D + 38 BatchNorm + 9 Conv1D layers in three widening
  stages — 64ch/kernel-5, 128ch/kernel-9, 256ch/kernel-17 — with
  plain-conv shortcut layers at the stage joins;
* a final ``(64,3)`` dense head producing [unmodified-T, BrdU, EdU].

The mounted reference carries only ``variables.index`` (shapes/dtypes, no
values) and no ``saved_model.pb`` (no graph topology), so this module
validates architecture against the manifest and exports raw tensors; it does
not re-instantiate the exact Keras graph; :mod:`dnascent_tpu.models.reference_cnn`
runs the tensors in JAX.  The in-framework DetectCNN
(:mod:`dnascent_tpu.models.detect_cnn`) is trained via ``trainCNN``.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

from ..io import tf_bundle

_MANIFEST = os.path.join(os.path.dirname(__file__),
                         "reference_cnn_manifest.json")

_VAR_RE = re.compile(r"layer_with_weights-(\d+)/([a-z_]+)/\.ATTRIBUTES")
_TRAIN_RE = re.compile(r"trainable_variables/(\d+)/\.ATTRIBUTES")


def load_manifest() -> dict:
    """Tensor inventory of the reference's shipped trained model."""
    with open(_MANIFEST) as f:
        return json.load(f)


def check_savedmodel_architecture(model_dir: str) -> list[str]:
    """Compare a SavedModel's variable shapes against the reference
    manifest; returns a list of human-readable mismatches (empty = exact
    architecture match with the shipped detect model)."""
    got = tf_bundle.read_savedmodel_shapes(model_dir)
    want = load_manifest()["tensors"]
    problems = []
    for name, spec in want.items():
        if name not in got:
            problems.append(f"missing: {name}")
        elif list(got[name].shape) != spec["shape"]:
            problems.append(
                f"shape mismatch {name}: {list(got[name].shape)} "
                f"!= {spec['shape']}")
    for name in got:
        if name not in want and not name.startswith("_CHECKPOINTABLE"):
            problems.append(f"unexpected: {name}")
    return problems


def load_savedmodel_tensors(model_dir: str) -> dict[str, np.ndarray]:
    """Load all weight tensors from a full SavedModel directory (requires
    the ``variables.data-*`` shards), keyed ``layer<N>/<part>``."""
    prefix = os.path.join(model_dir, "variables", "variables")
    raw = tf_bundle.read_tensors(prefix)
    out = {}
    for name, arr in raw.items():
        m = _VAR_RE.match(name)
        if m:
            out[f"layer{int(m.group(1))}/{m.group(2)}"] = arr
            continue
        m = _TRAIN_RE.match(name)
        if m:
            # the GRU cells (0-5) and the dense head (190/191) are stored
            # only under their trainable_variables alias in the checkpoint
            out[f"trainable{int(m.group(1))}"] = arr
    return out


def savedmodel_to_npz(model_dir: str, out_path: str) -> int:
    """Export a reference SavedModel's weights to a flat npz; returns the
    number of tensors written."""
    tensors = load_savedmodel_tensors(model_dir)
    if not tensors:
        raise ValueError(f"no layer weights found under {model_dir}")
    np.savez_compressed(out_path,
                        **{k.replace("/", "."): v for k, v in tensors.items()})
    return len(tensors)
