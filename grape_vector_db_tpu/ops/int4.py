"""int4 symmetric quantization — the next rung of the bandwidth ladder.

The IVF probe (ops/ivf_pallas.py on a GPU) is bound by the bytes it reads:
int8-resident lists halve the bytes per list of bf16. Packed int4 halves
them AGAIN (0.5 byte/dim), and doubles the rows a device holds.

Packing layout: nibbles are packed SPLIT-PLANE instead of adjacent-dim:
byte ``j`` of a row holds dim ``j`` in its low nibble and dim ``j + D/2`` in
its high nibble. A kernel then unpacks with two pure elementwise ops —

    lo = (packed & 0xF) - 8      # dims [0,      D/2)
    hi = (packed >> 4)  - 8      # dims [D/2,    D)

— and dots each half against the matching query half:
``dot(q[:, :D/2], lo) + dot(q[:, D/2:], hi)``. No interleave, no gather.

Codes are offset-binary: ``u = clip(round(v / s), -8, 7) + 8`` with
``s = max|v| / 7`` per row, stored as INT8-typed bytes (bit pattern of the
unsigned packed value): a uint8-typed corpus would force a corpus-wide
``bitcast_convert_type`` before a kernel that takes int8, which XLA
materializes as a real copy. A per-row ``factor`` folds dequantization and
the cosine norm division exactly as the int8 scheme does (ops/int8.py).

No reference analog (quantization.rs only has 1-bit); this engine exists
because device memory bandwidth rewards it.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = ["quantize_int4", "unpack_int4", "unpack_int4_split"]


@jax.jit
def quantize_int4(vecs: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """[M, D] f32 -> (packed [M, D/2] int8 split-plane, scale [M] f32).

    scale = max|v| / 7; levels -8..7 stored offset-binary (u = q + 8).
    The packed bytes carry the unsigned value's bit pattern in an
    int8-typed array (see module docstring for why int8).
    D must be even.
    """
    vf = vecs.astype(jnp.float32)
    m, d = vf.shape
    assert d % 2 == 0, f"int4 packing needs an even dim, got {d}"
    s = jnp.max(jnp.abs(vf), axis=1) / 7.0
    q = jnp.clip(jnp.round(vf / jnp.maximum(s, 1e-12)[:, None]), -8, 7)
    u = (q + 8.0).astype(jnp.uint8)                       # [M, D] in 0..15
    lo, hi = u[:, : d // 2], u[:, d // 2:]
    packed = jnp.bitwise_or(lo, jnp.left_shift(hi, 4))    # [M, D/2]
    return jax.lax.bitcast_convert_type(packed, jnp.int8), s


@jax.jit
def unpack_int4_split(packed: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """[..., D/2] int8/uint8 -> (lo [..., D/2], hi [..., D/2]) f32 in -8..7.

    ``lo`` holds dims [0, D/2), ``hi`` holds dims [D/2, D) — the same two
    planes the probe kernel unpacks; callers dot each against the
    matching query half (or concatenate for a full row). Accepts either
    byte dtype: the int32 widen + mask recovers the unsigned nibbles from
    int8-typed storage and is a no-op rearrangement for uint8.
    """
    p32 = packed.astype(jnp.int32)
    lo = jnp.bitwise_and(p32, 0xF).astype(jnp.float32) - 8.0
    hi = jnp.bitwise_and(jnp.right_shift(p32, 4), 0xF).astype(jnp.float32) - 8.0
    return lo, hi


@jax.jit
def unpack_int4(packed: jax.Array) -> jax.Array:
    """[..., D/2] int8/uint8 -> [..., D] f32 dequantized levels (unscaled)."""
    lo, hi = unpack_int4_split(packed)
    return jnp.concatenate([lo, hi], axis=-1)
