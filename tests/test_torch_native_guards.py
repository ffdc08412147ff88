"""The port's ``native.fill_matrix_encode`` refuses spans it would write
or read out of bounds, fills valid spans with the JAX package's bytes, and
encodes every byte as ``utils.dna.encode_bases`` does.

The C++ fill (``csrc/nimble_host.cpp``, ``nimble_fill_matrix_encode``)
encodes ``lens[i]`` bytes from ``raw[offsets[i]:]`` into row ``row0 + i`` of
``out``, sixteen at a time, and zeroes the row past them.  It checks every
span before it writes a byte; the wrapper raises ``ValueError`` when a
length is negative or exceeds the row width, when the rows run past
``out``, or when a span starts before or runs past ``raw``.
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
    ("negative length", "a length of -1 exceeds"),
    ("negative offset", "a span ends at byte"),
    ("first span past raw", "of a 12000-byte buffer"),
    ("rows before out", "run past"),
    ("lengths short", "63 lengths for 64 offsets"),
    ("out not int8", "2-D int8"),
    ("out not contiguous", "C-contiguous"),
])
def test_overruns_raise(case, match):
    raw, offs, lens = _spans(3)
    out = np.zeros((64, 120), dtype=np.int8)
    row0 = 0
    if case == "long span":
        lens[5] = 121
    elif case == "rows past out":
        row0 = 1
    elif case == "span past raw":
        lens[-1] = 10
        offs[-1] = len(raw) - 9
    elif case == "negative length":
        lens[40] = -1
    elif case == "negative offset":
        offs[0] = -1
    elif case == "first span past raw":
        offs[0] = len(raw)
        lens[0] = 1
    elif case == "rows before out":
        row0 = -1
    elif case == "lengths short":
        lens = lens[:-1]
    elif case == "out not int8":
        out = np.zeros((64, 120), dtype=np.uint8)
    else:
        out = np.zeros((64, 240), dtype=np.int8)[:, ::2]
    before = out.copy()
    with pytest.raises(ValueError, match=match):
        port_native.fill_matrix_encode(raw, offs, lens, 120, out, row0=row0)
    np.testing.assert_array_equal(out, before)


def _every_byte_rows(max_len=97):
    """For each length 1..max_len, 256 rows in which byte value v sits at
    every position of the row (row r holds (r + j) % 256 at position j),
    each starting at another offset modulo 32 of a raw buffer whose last
    span ends at its last byte."""
    spans, parts, at = [], [], 0
    for n in range(1, max_len + 1):
        for r in range(256):
            gap = (r + n) % 32
            parts.append(np.full(gap, ord("\n"), dtype=np.uint8))
            parts.append(((r + np.arange(n)) % 256).astype(np.uint8))
            spans.append((at + gap, n))
            at += gap + n
    raw = np.concatenate(parts).tobytes()
    offs, lens = (np.array(c, dtype=np.int64) for c in zip(*spans))
    return raw, offs, lens


@pytest.mark.parametrize("width", ["each_length", "padded"])
def test_every_byte_encodes_at_every_position(width):
    """Every byte value, at every position modulo 32 of a row and at row
    lengths 1..97, encodes as ``utils.dna.encode_bases`` does, with zeros
    past the length: into a matrix as wide as the rows (so the 16-byte
    steps store into the rows after) or 131 wide, from an ``np.empty``
    matrix."""
    from nimble_tpu_torch.utils.dna import encode_bases

    raw, offs, lens = _every_byte_rows()
    groups = ([lens == n for n in range(1, 98)] if width == "each_length"
              else [np.ones(len(lens), dtype=bool)])
    for rows in groups:
        W = int(lens[rows].max()) if width == "each_length" else 131
        out = np.empty((int(rows.sum()), W), dtype=np.int8)
        assert port_native.fill_matrix_encode(raw, offs[rows], lens[rows],
                                              W, out)
        for row, off, n in zip(out, offs[rows], lens[rows]):
            want = np.zeros(W, dtype=np.int8)
            want[:n] = encode_bases(raw[off:off + n])
            np.testing.assert_array_equal(row, want)
