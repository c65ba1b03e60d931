"""The reference's trained detect-CNN architecture, in JAX.

The reference ships its product-quality classifier as a TF SavedModel
(``dnn_models/detect_model_BrdUEdU_DNAr10_4_1``, loaded via the TF C API in
src/tensor.cpp:12-106 and invoked in src/detect.cpp:577-732).  The mount
carries only ``variables.index`` — shapes and dtypes, no values and no
``saved_model.pb`` graph — but the shape inventory
(``reference_cnn_manifest.json``, 268 tensors) determines the topology
completely:

* **Signal encoder** — two stacked ``GRU(16)`` cells (Keras v2
  ``reset_after`` layout: kernel ``(in, 48)``, recurrent ``(16, 48)``,
  bias ``(2, 48)``) run across the per-position window of up to
  RAWDEPTH=20 scaled raw samples (built in reads.h:147-172); zero-padded
  samples are masked (state carried through), matching the reads.h comment
  "these will be masked by the neural network".
* **QuartzNet-style separable-conv trunk** — a prologue ``Conv1D(64, k=3)``
  + BN, then five residual blocks, each six ``SeparableConv1D`` (BN+ReLU
  after the first five) with a parallel shortcut ``Conv1D`` from the block
  input and a BN on each branch before the add:
  2 blocks @ 64 ch / k=5, 2 blocks @ 128 ch / k=9, 1 block @ 256 ch / k=17.
  The layer_with_weights ordering (sep,BN ×5, sep, shortcut-conv, BN, BN)
  pins this wiring exactly: 30 separable convs, 9 plain convs, 38 BNs — the
  manifest's full census.
* **Epilogue** — ``Conv1D 256→256 (k=3)`` + BN, ``256→128 (k=3)`` + BN,
  ``128→64 (k=3)``, then a dense ``(64, 3)`` softmax head over
  [unmodified-T, BrdU, EdU] (probability unpacking: detect.cpp:686-714).

One detail is NOT recoverable from shapes alone: the checkpoint holds **no
input projection**, so the original model lifted the concatenated
per-position features — GRU(16) output + the core/residual sequence-index
scalars fed as floats (detect.cpp:589-626) — to the trunk's 64 channels
with a parameter-free op.  This reconstruction zero-pads the 18 channels to
64 (the canonical parameter-free channel lift).  Everything with weights
loads 1:1 from the SavedModel bundle; with the reference's
``variables.data-*`` shards present, ``detect --model <savedmodel-dir>``
runs this topology.

Convolutions run in bfloat16 with float32 parameters; the GRU (full-f32
products), BatchNorm statistics, and softmax head stay float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

RAWDEPTH = 20
N_CLASSES = 3
GRU_UNITS = 16

# trunk wiring derived from the manifest's layer_with_weights census
_PROLOGUE = (2, 3)                      # Conv1D(3,64,64), BN
_BLOCKS = (
    dict(seps=(4, 6, 8, 10, 12, 14), bns=(5, 7, 9, 11, 13),
         shortcut=15, bn_main=16, bn_short=17),
    dict(seps=(18, 20, 22, 24, 26, 28), bns=(19, 21, 23, 25, 27),
         shortcut=29, bn_main=30, bn_short=31),
    dict(seps=(32, 34, 36, 38, 40, 42), bns=(33, 35, 37, 39, 41),
         shortcut=43, bn_main=44, bn_short=45),
    dict(seps=(46, 48, 50, 52, 54, 56), bns=(47, 49, 51, 53, 55),
         shortcut=57, bn_main=58, bn_short=59),
    dict(seps=(60, 62, 64, 66, 68, 70), bns=(61, 63, 65, 67, 69),
         shortcut=71, bn_main=72, bn_short=73),
)
_EPILOGUE = ((74, 75), (76, 77), (78, None))   # (conv, bn-or-None)

# (kernel, in_ch, out_ch) per plain conv / separable conv, from the manifest
_CONV_SHAPES = {
    2: (3, 64, 64), 15: (5, 64, 64), 29: (5, 64, 64), 43: (9, 64, 128),
    57: (9, 128, 128), 71: (17, 128, 256), 74: (3, 256, 256),
    76: (3, 256, 128), 78: (3, 128, 64),
}
_SEP_SHAPES = {}
for _b, (_k, _cin, _cout) in ((0, (5, 64, 64)), (1, (5, 64, 64)),
                              (2, (9, 64, 128)), (3, (9, 128, 128)),
                              (4, (17, 128, 256))):
    for _j, _s in enumerate(_BLOCKS[_b]["seps"]):
        _SEP_SHAPES[_s] = (_k, _cin if _j == 0 else _cout, _cout)
_BN_CH = {3: 64}
for _blk in _BLOCKS:
    _c = _SEP_SHAPES[_blk["seps"][0]][2]
    for _l in _blk["bns"]:
        _BN_CH[_l] = _c
    _BN_CH[_blk["bn_main"]] = _c
    _BN_CH[_blk["bn_short"]] = _c
_BN_CH[75] = 256
_BN_CH[77] = 128

_BN_EPS = 1e-3   # Keras BatchNormalization default
_F32 = jax.lax.Precision.HIGHEST


# conv compute dtype: bfloat16 by default; bench.py's CPU-baseline
# worker sets DNASCENT_REFCNN_F32=1 so the CPU measurement runs plain float32
# (what the reference's TF CPU build uses) instead of emulated bf16
_CONV_DTYPE = (jnp.float32 if __import__("os").environ.get(
    "DNASCENT_REFCNN_F32") else jnp.bfloat16)


def _conv1d(x, kernel, bias):
    y = jax.lax.conv_general_dilated(
        x.astype(_CONV_DTYPE), kernel.astype(_CONV_DTYPE),
        window_strides=(1,), padding="SAME",
        dimension_numbers=("NWC", "WIO", "NWC"))
    return y.astype(jnp.float32) + bias


def _sepconv1d(x, p):
    dw = p["depthwise_kernel"]              # (k, C, 1) — TF layout
    c = dw.shape[1]
    dwk = jnp.transpose(dw, (0, 2, 1))       # (k, 1, C) for grouped conv
    y = jax.lax.conv_general_dilated(
        x.astype(_CONV_DTYPE), dwk.astype(_CONV_DTYPE),
        window_strides=(1,), padding="SAME",
        dimension_numbers=("NWC", "WIO", "NWC"), feature_group_count=c)
    y = jax.lax.conv_general_dilated(
        y, p["pointwise_kernel"].astype(_CONV_DTYPE),
        window_strides=(1,), padding="SAME",
        dimension_numbers=("NWC", "WIO", "NWC"))
    return y.astype(jnp.float32) + p["bias"]


def _bn(x, p):
    inv = jax.lax.rsqrt(p["moving_variance"] + _BN_EPS)
    return (x - p["moving_mean"]) * inv * p["gamma"] + p["beta"]


def _gru_scan(x, mask, p0, p1):
    """Two stacked Keras-v2 GRU(16) cells over the sample axis.

    x: (N, T) float32 samples; mask: (N, T) bool (False = padded step, the
    state is carried through unchanged — Keras Masking semantics).  Returns
    the final hidden state of the second cell, (N, 16).
    Keras reset_after gate math (recurrent_activation=sigmoid,
    activation=tanh, gate order [z, r, h]):
        z = σ(x·Wz + bxz + h·Uz + bhz)
        r = σ(x·Wr + bxr + h·Ur + bhr)
        hh = tanh(x·Wh + bxh + r * (h·Uh + bhh))
        h' = z*h + (1-z)*hh
    """
    n = x.shape[0]
    u = GRU_UNITS

    def cell(p, xt, h):
        # full f32 products: the card would otherwise run these 16-wide
        # dots in TF32 (about three decimal digits)
        gx = jnp.dot(xt, p["kernel"], precision=_F32) + p["bias"][0]
        gh = jnp.dot(h, p["recurrent"], precision=_F32) + p["bias"][1]
        xz, xr, xh = gx[:, :u], gx[:, u:2 * u], gx[:, 2 * u:]
        hz, hr, hh_ = gh[:, :u], gh[:, u:2 * u], gh[:, 2 * u:]
        z = jax.nn.sigmoid(xz + hz)
        r = jax.nn.sigmoid(xr + hr)
        hh = jnp.tanh(xh + r * hh_)
        return z * h + (1.0 - z) * hh

    def step(carry, inp):
        h0, h1 = carry
        xt, mt = inp
        n0 = cell(p0, xt[:, None], h0)
        n1 = cell(p1, n0, h1)
        m = mt[:, None]
        return (jnp.where(m, n0, h0), jnp.where(m, n1, h1)), None

    init = (jnp.zeros((n, u), jnp.float32), jnp.zeros((n, u), jnp.float32))
    (h0, h1), _ = jax.lax.scan(step, init,
                               (x.T.astype(jnp.float32), mask.T))
    return h1


@dataclass(frozen=True)
class ReferenceDetectCNN:
    """The detect pipeline's model interface (shared with the in-framework
    DetectCNN): ``apply(params, core_idx, residual_idx, signal) -> (B, L, 3)``
    float32 probabilities (hashable, so it rides jit static args)."""

    def apply(self, params, core_idx, residual_idx, signal):
        from .cnn import SIG_QUANT_SCALE, SIG_QUANT_LO
        B, L, T = signal.shape
        if signal.dtype == jnp.uint8:
            q = signal.astype(jnp.float32)
            signal = jnp.where(q == 0.0, 0.0,
                               (q - 1.0) / SIG_QUANT_SCALE + SIG_QUANT_LO)
        signal = signal.astype(jnp.float32)
        flat = signal.reshape(B * L, T)
        h = _gru_scan(flat, flat != 0.0, params["gru0"], params["gru1"])
        h = h.reshape(B, L, GRU_UNITS)
        feats = jnp.concatenate(
            [h, core_idx.astype(jnp.float32)[..., None],
             residual_idx.astype(jnp.float32)[..., None]], axis=-1)
        # parameter-free lift to the trunk's 64 channels (see module doc)
        x = jnp.pad(feats, ((0, 0), (0, 0), (0, 64 - feats.shape[-1])))

        x = _conv1d(x, params["layer2"]["kernel"], params["layer2"]["bias"])
        x = jax.nn.relu(_bn(x, params["layer3"]))
        for blk in _BLOCKS:
            y = x
            for s, b in zip(blk["seps"][:-1], blk["bns"]):
                y = _sepconv1d(y, params[f"layer{s}"])
                y = jax.nn.relu(_bn(y, params[f"layer{b}"]))
            y = _sepconv1d(y, params[f"layer{blk['seps'][-1]}"])
            s = _conv1d(x, params[f"layer{blk['shortcut']}"]["kernel"],
                        params[f"layer{blk['shortcut']}"]["bias"])
            y = _bn(y, params[f"layer{blk['bn_main']}"])
            s = _bn(s, params[f"layer{blk['bn_short']}"])
            x = jax.nn.relu(y + s)
        for conv, bn in _EPILOGUE:
            x = _conv1d(x, params[f"layer{conv}"]["kernel"],
                        params[f"layer{conv}"]["bias"])
            if bn is not None:
                x = jax.nn.relu(_bn(x, params[f"layer{bn}"]))
            else:
                x = jax.nn.relu(x)
        logits = (jnp.dot(x, params["head"]["kernel"], precision=_F32)
                  + params["head"]["bias"])
        return jax.nn.softmax(logits, axis=-1)

    def receptive_field(self) -> int:
        """Positions of context per output (for halo-chunked inference):
        prologue 2 + blocks 2*6*4 + 2*6*8 + 1*6*16 + epilogue 3*2 = 248."""
        rf = 1 + (_CONV_SHAPES[2][0] - 1)
        for blk in _BLOCKS:
            rf += 6 * (_SEP_SHAPES[blk["seps"][0]][0] - 1)
        for conv, _ in _EPILOGUE:
            rf += _CONV_SHAPES[conv][0] - 1
        return rf


def create_model() -> ReferenceDetectCNN:
    return ReferenceDetectCNN()


def params_from_tensors(tensors: dict[str, np.ndarray]):
    """Assemble the apply() param tree from a SavedModel tensor dict
    (``cnn_import.load_savedmodel_tensors`` output: ``layer<N>/<part>`` for
    the trunk, ``trainable<N>`` for the GRU cells and the dense head)."""
    def need(key):
        if key not in tensors:
            raise KeyError(f"SavedModel tensor missing: {key}")
        return jnp.asarray(np.asarray(tensors[key], dtype=np.float32))

    params: dict = {}
    params["gru0"] = {"kernel": need("trainable0"),
                      "recurrent": need("trainable1"),
                      "bias": need("trainable2")}
    params["gru1"] = {"kernel": need("trainable3"),
                      "recurrent": need("trainable4"),
                      "bias": need("trainable5")}
    params["head"] = {"kernel": need("trainable190"),
                      "bias": need("trainable191")}
    for i, (k, cin, cout) in _CONV_SHAPES.items():
        params[f"layer{i}"] = {"kernel": need(f"layer{i}/kernel"),
                               "bias": need(f"layer{i}/bias")}
        if params[f"layer{i}"]["kernel"].shape != (k, cin, cout):
            raise ValueError(
                f"layer{i} kernel shape "
                f"{params[f'layer{i}']['kernel'].shape} != {(k, cin, cout)}")
    for i in _SEP_SHAPES:
        params[f"layer{i}"] = {
            "depthwise_kernel": need(f"layer{i}/depthwise_kernel"),
            "pointwise_kernel": need(f"layer{i}/pointwise_kernel"),
            "bias": need(f"layer{i}/bias")}
    for i, c in _BN_CH.items():
        params[f"layer{i}"] = {k: need(f"layer{i}/{k}") for k in
                               ("gamma", "beta", "moving_mean",
                                "moving_variance")}
        if params[f"layer{i}"]["gamma"].shape != (c,):
            raise ValueError(f"layer{i} BN channels "
                             f"{params[f'layer{i}']['gamma'].shape} != {c}")
    return params


def synthetic_tensors(seed: int = 0) -> dict[str, np.ndarray]:
    """A full random tensor dict with the manifest's exact shapes — stands
    in for the (absent) trained values in tests and lets the topology be
    exercised end to end."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=None):
        scale = scale or 1.0 / np.sqrt(max(1, np.prod(shape[:-1])))
        return rng.normal(0.0, scale, size=shape).astype(np.float32)

    t: dict[str, np.ndarray] = {}
    t["trainable0"] = w(1, 48)
    t["trainable1"] = w(GRU_UNITS, 48)
    t["trainable2"] = np.zeros((2, 48), np.float32)
    t["trainable3"] = w(GRU_UNITS, 48)
    t["trainable4"] = w(GRU_UNITS, 48)
    t["trainable5"] = np.zeros((2, 48), np.float32)
    t["trainable190"] = w(64, N_CLASSES)
    t["trainable191"] = np.zeros(N_CLASSES, np.float32)
    for i, (k, cin, cout) in _CONV_SHAPES.items():
        t[f"layer{i}/kernel"] = w(k, cin, cout)
        t[f"layer{i}/bias"] = np.zeros(cout, np.float32)
    for i, (k, cin, cout) in _SEP_SHAPES.items():
        t[f"layer{i}/depthwise_kernel"] = w(k, cin, 1)
        t[f"layer{i}/pointwise_kernel"] = w(1, cin, cout)
        t[f"layer{i}/bias"] = np.zeros(cout, np.float32)
    for i, c in _BN_CH.items():
        t[f"layer{i}/gamma"] = np.ones(c, np.float32)
        t[f"layer{i}/beta"] = np.zeros(c, np.float32)
        t[f"layer{i}/moving_mean"] = np.zeros(c, np.float32)
        t[f"layer{i}/moving_variance"] = np.ones(c, np.float32)
    return t


def load_savedmodel(model_dir: str):
    """(model, params) from a reference SavedModel directory with its
    ``variables.data-*`` shards present; validates the architecture against
    the shipped manifest first."""
    from . import cnn_import
    problems = cnn_import.check_savedmodel_architecture(model_dir)
    if problems:
        raise ValueError("SavedModel does not match the reference detect "
                         "model architecture:\n  " + "\n  ".join(problems))
    tensors = cnn_import.load_savedmodel_tensors(model_dir)
    return create_model(), params_from_tensors(tensors)
