"""Device-side k-mer rank arithmetic from packed base codes.

Per-kmer i32 rank uploads (4 bytes/kmer) move 4x the bytes of the u8 base
codes they derive from (a saving sized for a slow interconnect; its value
over PCIe is not measured yet).
These helpers recompute ranks (and the CNN's core/residual indices) on
device from u8 code streams, matching the host helpers in utils/seqtools
exactly:

* base codes: A=0, T=1, G=2, C=3 (data_IO.cpp:129-141); 255 marks non-ACGT
  (the u8 view of encode_bases' -1),
* rank = base-4 big-endian over the k window; any non-ACGT base in the
  window gives rank 0, mirroring the pipelines' ``where(rank < 0, 0, rank)``
  defaulting (data_IO.cpp:131),
* core index = 9-mer digits 2..6 (+1), residual = digits 0,1,7,8 (+1)
  (reads.h:112-138); centre base is digit 4.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def ranks_from_codes(codes: jnp.ndarray, k: int = 9) -> jnp.ndarray:
    """(..., L) u8 base codes -> (..., L-k+1) i32 ranks (0 where the window
    contains a non-ACGT base)."""
    n = codes.shape[-1] - k + 1
    bad = codes == 255
    safe = jnp.where(bad, 0, codes).astype(jnp.int32)
    r = jnp.zeros(codes.shape[:-1] + (n,), jnp.int32)
    anybad = jnp.zeros(codes.shape[:-1] + (n,), bool)
    for i in range(k):
        r = r + (safe[..., i : i + n] << (2 * (k - 1 - i)))
        anybad = anybad | bad[..., i : i + n]
    return jnp.where(anybad, 0, r)


@functools.partial(jax.jit, static_argnames=("k",))
def flat_ranks_from_codes_jit(codes_flat: jnp.ndarray, k: int = 9):
    """Flat u8 code stream -> same-length i32 rank stream (tail k-1 entries
    zero-padded).  Per-read segments must carry their k-1 trailing bases so
    in-read ranks never mix reads; the spill ranks at each segment tail are
    garbage that downstream masks (n_states / n_kmers) never read."""
    r = ranks_from_codes(codes_flat, k)
    return jnp.pad(r, (0, k - 1))


def pack_codes_host(codes_u8):
    """Host-side 2-bit pack of a base-code array (last axis, length must be
    a multiple of 4): four bases per byte, little-endian within the byte,
    plus a non-ACGT bitmap (np.packbits big-endian).  Quarters the dominant
    sequence upload (codes are 2 bits of entropy shipped as 8)."""
    import numpy as np
    assert codes_u8.shape[-1] % 4 == 0, codes_u8.shape
    bad = codes_u8 == 255
    safe = np.where(bad, 0, codes_u8)
    packed = (safe[..., 0::4] | (safe[..., 1::4] << 2)
              | (safe[..., 2::4] << 4) | (safe[..., 3::4] << 6)
              ).astype(np.uint8)
    badmap = np.packbits(bad, axis=-1)
    return packed, badmap


def codes_from_packed(packed: jnp.ndarray, badmap: jnp.ndarray,
                      n: int) -> jnp.ndarray:
    """Device-side inverse of pack_codes_host -> (..., n) u8 codes with 255
    at non-ACGT positions."""
    shifts2 = jnp.arange(0, 8, 2, dtype=jnp.uint8)
    vals = (packed[..., :, None] >> shifts2) & 3
    codes = vals.reshape(*packed.shape[:-1], -1)[..., :n]
    shifts1 = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    bad = ((badmap[..., :, None] >> shifts1) & 1)
    bad = bad.reshape(*badmap.shape[:-1], -1)[..., :n]
    return jnp.where(bad == 1, jnp.uint8(255), codes.astype(jnp.uint8))


@functools.partial(jax.jit, static_argnames=("k", "n"))
def flat_ranks_from_packed_jit(packed: jnp.ndarray, badmap: jnp.ndarray,
                               n: int, k: int = 9):
    """flat_ranks_from_codes_jit fed by the 2-bit packed stream."""
    codes = codes_from_packed(packed, badmap, n)
    r = ranks_from_codes(codes, k)
    return jnp.pad(r, (0, k - 1))


def core_index_from_ranks(ranks: jnp.ndarray) -> jnp.ndarray:
    """9-mer rank -> CNN core-sequence index (digits 2..6, +1)."""
    return ((ranks >> 4) & 1023) + 1


def residual_index_from_ranks(ranks: jnp.ndarray) -> jnp.ndarray:
    """9-mer rank -> CNN residual-sequence index (digits 0,1,7,8, +1)."""
    return (((ranks >> 16) & 3) * 64 + ((ranks >> 14) & 3) * 16
            + ((ranks >> 2) & 3) * 4 + (ranks & 3) + 1)


def center_is_t_from_ranks(ranks: jnp.ndarray) -> jnp.ndarray:
    """9-mer rank -> centre base (digit 4) == T."""
    return ((ranks >> 8) & 3) == 1
