"""The in-framework DetectCNN (flax): the model ``trainCNN --fit`` trains
by default and ``detect --allow-untrained-cnn`` runs with random weights.

Embeddings for the two sequence streams, a masked encoder over the 20 raw
samples, and a dilated residual convolution stack (local receptive field
~265 positions, so ultra-long reads can be sequence-sharded with a halo).
Dense/conv compute runs in bfloat16 with float32 parameters and a float32
softmax head.  This is the only module that imports flax; the detect path
with the reference topology (``--model``) never loads it.
"""

from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp

from .cnn import (CORE_VOCAB, N_CLASSES, RAWDEPTH, RESIDUAL_VOCAB,
                  SIG_QUANT_LO, SIG_QUANT_SCALE)


class ConvBlock(nn.Module):
    """Pre-norm dilated residual conv block (bf16 compute)."""

    features: int
    kernel: int = 5
    dilation: int = 1

    @nn.compact
    def __call__(self, x):
        h = nn.LayerNorm(dtype=jnp.float32)(x)
        h = h.astype(jnp.bfloat16)
        h = nn.Conv(self.features, (self.kernel,),
                    kernel_dilation=(self.dilation,),
                    dtype=jnp.bfloat16, param_dtype=jnp.float32)(h)
        h = nn.gelu(h)
        h = nn.Conv(self.features, (1,), dtype=jnp.bfloat16,
                    param_dtype=jnp.float32)(h)
        return x + h.astype(x.dtype)


class DetectCNN(nn.Module):
    """Per-position analogue classifier with the reference's input contract.

    Default sizing is matched to the reference model's scale: its SavedModel
    manifest (reference_cnn_manifest.json, from dnn_models/.../variables.index)
    shows a ~64-channel separable-conv stack, so a 128-channel dense-conv
    stack with 8 dilated blocks (receptive field ~265 positions) carries
    comfortably more capacity while keeping the device time per batch
    small."""

    d_model: int = 128
    d_core: int = 64
    d_residual: int = 32
    d_signal: int = 96
    dilations: tuple = (1, 2, 4, 8, 16, 32, 1, 2)
    kernel: int = 5

    @nn.compact
    def __call__(self, core_idx, residual_idx, signal):
        """core_idx/residual_idx: (B, L) int32; signal: (B, L, RAWDEPTH)
        float (f16 accepted for cheap host->device transfer).
        Returns (B, L, 3) float32 class probabilities."""
        if signal.dtype == jnp.uint8:
            q = signal.astype(jnp.float32)
            signal = jnp.where(
                q == 0.0, 0.0,
                (q - 1.0) / SIG_QUANT_SCALE + SIG_QUANT_LO)
        signal = signal.astype(jnp.float32)
        core_idx = core_idx.astype(jnp.int32)
        residual_idx = residual_idx.astype(jnp.int32)
        mask = (signal != 0.0)
        nvalid = jnp.maximum(mask.sum(-1, keepdims=True), 1)
        mean = jnp.sum(signal * mask, -1, keepdims=True) / nvalid
        var = jnp.sum(((signal - mean) * mask) ** 2, -1, keepdims=True) / nvalid
        sig_feats = jnp.concatenate(
            [signal, mask.astype(jnp.float32), mean,
             jnp.sqrt(var + 1e-6),
             jnp.log(nvalid.astype(jnp.float32))], axis=-1)
        s = nn.Dense(self.d_signal, dtype=jnp.bfloat16,
                     param_dtype=jnp.float32)(sig_feats.astype(jnp.bfloat16))
        s = nn.gelu(s)

        c = nn.Embed(CORE_VOCAB, self.d_core, dtype=jnp.bfloat16,
                     param_dtype=jnp.float32)(core_idx)
        r = nn.Embed(RESIDUAL_VOCAB, self.d_residual, dtype=jnp.bfloat16,
                     param_dtype=jnp.float32)(residual_idx)

        x = jnp.concatenate([s, c, r], axis=-1)
        x = nn.Dense(self.d_model, dtype=jnp.bfloat16,
                     param_dtype=jnp.float32)(x)
        x = x.astype(jnp.float32)
        for d in self.dilations:
            x = ConvBlock(self.d_model, self.kernel, d)(x)
        x = nn.LayerNorm(dtype=jnp.float32)(x)
        logits = nn.Dense(N_CLASSES, dtype=jnp.float32,
                          param_dtype=jnp.float32)(x)
        return jax.nn.softmax(logits, axis=-1)

    def receptive_field(self) -> int:
        return 1 + sum((self.kernel - 1) * d for d in self.dilations)


def create_model(**kwargs) -> DetectCNN:
    return DetectCNN(**kwargs)


def init_params(model: DetectCNN, rng: jax.Array, length: int = 256):
    dummy = (jnp.zeros((1, length), jnp.int32),
             jnp.zeros((1, length), jnp.int32),
             jnp.zeros((1, length, RAWDEPTH), jnp.float32))
    return model.init(rng, *dummy)


def default_params(model: DetectCNN | None = None, seed: int = 0):
    """Deterministic fallback parameters used when no trained weights are
    available (the reference's weight files are absent from its mount)."""
    model = model or create_model()
    return init_params(model, jax.random.PRNGKey(seed))
