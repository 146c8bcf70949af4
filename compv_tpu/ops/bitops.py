"""Bit packing / unpacking / popcount utilities.

Reference: base/compv_bits.cxx (logical-op kernels) and the popcount used by
Hamming distance (base/math/compv_math_distance.cxx:21-34). Descriptors
are kept in *unpacked* bit-plane form (N, 256) u8/int8 whenever they feed
the matcher (so Hamming becomes a matmul), and packed (N, 32) u8 for storage/serialization parity with the
reference's 32-byte descriptor rows.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["pack_bits_to_bytes", "unpack_bytes_to_bits", "popcount_bytes",
           "bits_and", "bits_or", "bits_xor", "bits_not"]

# numpy, not jnp: module-level device arrays would initialize the XLA
# backend at import time and break jax.distributed.initialize ordering
_BIT_WEIGHTS = np.asarray([1, 2, 4, 8, 16, 32, 64, 128], np.uint8)  # LSB-first


def pack_bits_to_bytes(bits: jax.Array) -> jax.Array:
    """(..., 8*B) {0,1} -> (..., B) u8, LSB-first within each byte (matches
    the reference descriptor bit order where bit k of byte b is test
    8*b + k)."""
    shape = bits.shape
    b = bits.reshape(*shape[:-1], shape[-1] // 8, 8).astype(jnp.uint8)
    return jnp.sum(b * jnp.asarray(_BIT_WEIGHTS), axis=-1).astype(jnp.uint8)


def unpack_bytes_to_bits(bytes_arr: jax.Array) -> jax.Array:
    """(..., B) u8 -> (..., 8*B) {0,1} u8, LSB-first."""
    shape = bytes_arr.shape
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (bytes_arr[..., None] >> shifts) & jnp.uint8(1)
    return bits.reshape(*shape[:-1], shape[-1] * 8)


def popcount_bytes(bytes_arr: jax.Array) -> jax.Array:
    """Per-row popcount of packed bytes: (..., B) u8 -> (...,) i32."""
    return jnp.sum(unpack_bytes_to_bits(bytes_arr).astype(jnp.int32), axis=-1)


def bits_and(a, b):
    return jnp.bitwise_and(a, b)


def bits_or(a, b):
    return jnp.bitwise_or(a, b)


def bits_xor(a, b):
    return jnp.bitwise_xor(a, b)


def bits_not(a):
    return jnp.bitwise_not(a)
