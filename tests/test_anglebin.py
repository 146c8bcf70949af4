"""Exact angular binning (ops/anglebin.py) against a float64 oracle."""
import jax.numpy as jnp
import numpy as np
import pytest

from compv_tpu.ops.anglebin import _edges, angle_bin


def _oracle(a, b, n, centred):
    """Sector of (a, b) among the int edge directions, in exact integer
    (Python int) cross products."""
    c, s = _edges(n, centred)
    out = []
    for x, y in zip(a.tolist(), b.tolist()):
        if x == 0 and y == 0:
            out.append(0)
            continue
        ahead = [int(cc) * y - int(ss) * x >= 0 for cc, ss in zip(c, s)]
        out.append(next(k for k in range(n)
                        if ahead[k] and not ahead[(k + 1) % n]))
    return np.asarray(out)


@pytest.mark.parametrize("n,centred,scale", [(360, False, 2 ** 21),
                                            (360, True, 2 ** 30),
                                            (32, True, 1000)])
def test_matches_integer_oracle(n, centred, scale):
    rs = np.random.default_rng(n + int(centred))
    a = rs.integers(-scale, scale, 400, dtype=np.int64)
    b = rs.integers(-scale, scale, 400, dtype=np.int64)
    # directions lying exactly on table edges, both axes, and the origin
    c, s = _edges(n, centred)
    a = np.concatenate([a, c * 3, [5, 0, -5, 0, 0]]).astype(np.int32)
    b = np.concatenate([b, s * 3, [0, 5, 0, -5, 0]]).astype(np.int32)
    got = np.asarray(angle_bin(jnp.asarray(a), jnp.asarray(b), n, centred))
    np.testing.assert_array_equal(got, _oracle(a, b, n, centred))


def test_close_to_float_angle():
    rs = np.random.default_rng(1)
    ang = rs.uniform(0, 2 * np.pi, 500)
    a = np.round(1e6 * np.cos(ang)).astype(np.int32)
    b = np.round(1e6 * np.sin(ang)).astype(np.int32)
    got = np.asarray(angle_bin(jnp.asarray(a), jnp.asarray(b), 360))
    want = np.floor(np.rad2deg(np.arctan2(b, a)) % 360).astype(int)
    # the 2^-9 edge tables sit within ~0.12 degrees of the ideal edges
    assert (np.minimum((got - want) % 360, (want - got) % 360) <= 1).all()
    assert (got == want).mean() > 0.7
