"""Precision-pinned matmul helpers.

An H100 computes float32 matmuls in TF32 (a 10-bit mantissa, ~3 decimal
digits) unless ``Precision.HIGHEST`` is asked for. That is the right trade for
large neural-net matmuls but wrong for Kalman covariance algebra: with a
reduced-precision default a 0.3% relative error on a covariance insertion
block was observed, versus 6e-8 at HIGHEST. So every accuracy-critical
contraction in the filters and the pose-graph solver goes through these
wrappers; bulk elementwise work (the vast majority of the hot path) is true
fp32 regardless.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


def dot32(a, b):
    """jnp.matmul at full fp32 precision."""
    return jnp.matmul(a, b, precision=HIGHEST)


def einsum32(subscripts, *operands):
    """jnp.einsum at full fp32 precision."""
    return jnp.einsum(subscripts, *operands, precision=HIGHEST)


def sel_cols(dim, li, k: int = 2):
    """(dim, k) one-hot selection matrix for columns (li, ..., li+k-1).

    Replaces per-world dynamic_slice/dynamic_update_slice in the batched
    filter math: under vmap those lower to gather/scatter with batched start
    indices, which serialize badly on accelerators. With one-hot selection
    every dynamic-index read becomes a small batched matmul and every write
    becomes masked outer products — plain fused elementwise work. Out-of-range li yields zero
    columns (reads give 0, writes become no-ops), which callers guard anyway.
    """
    iota = jnp.arange(dim)
    return jnp.stack(
        [(iota == li + j).astype(jnp.float32) for j in range(k)], axis=1
    )
