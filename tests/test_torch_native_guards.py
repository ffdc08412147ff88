"""The port's ``native.fill_matrix_encode`` refuses spans the C++ loop
would write or read out of bounds, and fills valid spans with the JAX
package's bytes.

The C++ loop (``csrc/nimble_host.cpp``, ``nimble_fill_matrix_encode``)
copies ``lens[i]`` bytes from ``raw[offsets[i]:]`` into row ``row0 + i`` of
``out`` and checks nothing; the port's wrapper raises ``ValueError`` when a
length exceeds the row width, when the rows run past ``out``, or when a
span runs past ``raw``.
"""

import numpy as np
import pytest

from nimble_tpu_torch import native as port_native


def _spans(seed, n=64, width=120, raw_len=12000):
    rng = np.random.default_rng(seed)
    raw = rng.choice(list(b"ACGTNacgtn@+I\n"), raw_len).astype(
        np.uint8).tobytes()
    lens = rng.integers(0, width + 1, n).astype(np.int64)
    offs = np.sort(rng.integers(0, raw_len - width, n)).astype(np.int64)
    return raw, offs, lens


def _fill_both(raw, offs, lens, shape, row0):
    from nimble_tpu import native as jax_native

    got = np.zeros(shape, dtype=np.int8)
    want = np.zeros(shape, dtype=np.int8)
    assert port_native.fill_matrix_encode(raw, offs, lens, shape[1], got,
                                          row0=row0)
    assert jax_native.fill_matrix_encode(raw, offs, lens, shape[1], want,
                                         row0=row0)
    return got, want


@pytest.mark.parametrize("row0", [0, 7, 16])
def test_valid_spans_give_the_jax_packages_bytes(row0):
    raw, offs, lens = _spans(row0)
    got, want = _fill_both(raw, offs, lens, (80, 120), row0)
    np.testing.assert_array_equal(got, want)
    assert got.any()


def test_spans_at_the_limits_are_taken():
    """A span of the full row width, into the last row of out, ending at
    the last byte of raw."""
    raw, _, _ = _spans(4)
    offs = np.array([0, len(raw) - 120], dtype=np.int64)
    lens = np.array([120, 120], dtype=np.int64)
    got, want = _fill_both(raw, offs, lens, (3, 120), 1)
    np.testing.assert_array_equal(got, want)
    assert not got[0].any() and got[2].any()


@pytest.mark.parametrize("case,match", [
    ("long span", "exceeds the row width"),
    ("rows past out", "run past"),
    ("span past raw", "of a 12000-byte buffer"),
])
def test_overruns_raise(case, match):
    raw, offs, lens = _spans(3)
    out = np.zeros((64, 120), dtype=np.int8)
    row0 = 0
    if case == "long span":
        lens[5] = 121
    elif case == "rows past out":
        row0 = 1
    else:
        lens[-1] = 10
        offs[-1] = len(raw) - 9
    before = out.copy()
    with pytest.raises(ValueError, match=match):
        port_native.fill_matrix_encode(raw, offs, lens, 120, out, row0=row0)
    np.testing.assert_array_equal(out, before)
