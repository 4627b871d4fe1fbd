"""Single-round-trip device->host fetch for (scores, slots) result pairs.

Every search path ends by pulling a float score plane and an integer slot
plane off the device. `np.asarray` per array is one BLOCKING device-to-host
transfer each, so a query would pay two synchronizations (the reference's
equivalent cost is a sled read, storage.rs:296-339). Packing the pair into
one plane and reading back once halves the blocking round trips; the host
splits and bitcasts back for free (same-width dtype views copy nothing).

The packed plane is **int32**, not f32: slot indices bitcast into f32 lanes
are denormals (any int < 2^23 has a zero exponent field), and a device that
flushes denormals to zero (a flush-to-zero float mode) would return every
slot as 0. Bitcasting the f32 scores into int32 lanes is the safe direction;
integer lanes pass through concat + transfer bit-exactly.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["fetch_scores_slots"]


@jax.jit
def _pack(vals, idxs):
    return jnp.concatenate(
        [lax.bitcast_convert_type(vals.astype(jnp.float32), jnp.int32),
         idxs.astype(jnp.int32)],
        axis=-1,
    )


def fetch_scores_slots(vals, idxs) -> Tuple[np.ndarray, np.ndarray]:
    """(device [..., k] scores, device [..., k] int slots) -> host numpy pair
    via ONE blocking transfer. Shapes must match on the minor axis."""
    k = vals.shape[-1]
    out = np.asarray(_pack(vals, idxs))
    return out[..., :k].view(np.float32), out[..., k:]
