"""Exact angular binning of integer direction vectors.

Angles that feed an integer decision (ORB's steering bin, KHT's vote bin)
must not depend on a backend's f32 ``atan2``, whose last bits differ between
the CPU and a GPU. ``angle_bin`` takes the f32 ``atan2`` only as a proposal
and settles the bin with exact integer cross products against host-built
bin edges, so every backend returns the same bin.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = ["angle_bin"]

_EDGE_BITS = 9        # bin-edge directions as int32 multiples of 2^-9
_SPLIT = 16           # operands split into a high and a 16-bit low limb


def _edges(n_bins: int, centred: bool):
    first = -np.pi / n_bins if centred else 0.0
    t = first + 2 * np.pi * np.arange(n_bins) / n_bins
    one = 1 << _EDGE_BITS
    return (np.round(np.cos(t) * one).astype(np.int32),
            np.round(np.sin(t) * one).astype(np.int32))


def _cross_ge0(a, b, c, s):
    """sign(c*b - s*a) >= 0, exact in int32 for any int32 a, b and
    |c|, |s| <= 2^9: both operands split into a high limb (< 2^15) and a
    16-bit low limb, so every partial sum stays below 2^27, and the carry
    of the low sum folds into the high sum."""
    mask = (1 << _SPLIT) - 1
    hi = (b >> _SPLIT) * c - (a >> _SPLIT) * s
    lo = (b & mask) * c - (a & mask) * s
    return hi + (lo >> _SPLIT) >= 0


def angle_bin(a, b, n_bins: int, centred: bool = False):
    """Bin index in [0, n_bins) of the direction (a, b), both int32.
    Bin k spans the angles [k, k+1) * 360/n_bins degrees,
    or with ``centred`` [k - 1/2, k + 1/2) * 360/n_bins. The zero vector
    falls in bin 0."""
    c_tab, s_tab = (jnp.asarray(t) for t in _edges(n_bins, centred))
    deg = jnp.rad2deg(jnp.arctan2(b.astype(jnp.float32),
                                  a.astype(jnp.float32)))
    k0 = jnp.floor(deg * (n_bins / 360.0) + (0.5 if centred else 0.0)
                   ).astype(jnp.int32)

    def ahead(k):          # (a, b) at or counter-clockwise of edge k
        k = k % n_bins
        return _cross_ge0(a, b, c_tab[k], s_tab[k])

    k = jnp.where(~ahead(k0), k0 - 1, jnp.where(ahead(k0 + 1), k0 + 1, k0))
    return jnp.where((a == 0) & (b == 0), 0, k % n_bins)
