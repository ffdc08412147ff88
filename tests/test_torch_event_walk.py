"""The event walk of ``csrc/span_walk.cuh``, modelled in numpy, against the
step walk ``ops.span_walk.span_walk_plain``, bit for bit.

The CUDA walk (shared by ``probe_walk_filter.cu`` and
``fused_span_walk.cu``) does not step: per window of 32 steps it reduces
each lane's valid bits v and valid & match bits m over the group's live
lanes (anyM, allM, anyA, allA), adds the popcounts up to the first event
E = (anyM & ~allM) | (~anyM & anyA & ~allA) (lowest bit forward, highest
bit left), sets the live lanes there and starts the next window after it;
a group down to one live lane counts its steps left in closed form.
:func:`event_walk` is that algorithm one read at a time, on the kernel's
own quantities (the per-lane valid intervals, match bits from the
gathered words, 32-step windows from the group's first step), so the CUDA
code's arithmetic is tested here on the CPU; the kernel itself is held to
the plain walk on the card (``tests/test_torch_span_walk.py``,
``tests/test_torch_probe_walk.py``, ``chip_smoke.py`` phase 2).

Cases: hypothesis-drawn allele-like references (rows that copy one row
with substitutions and differ in length, so lanes are valid over
different intervals and agree or part at substitutions and shifts), C = 1
to 16, both walk directions; and the allele-family library of
``workload.allele_family`` probed at bucket 92, where most reads hold
several live candidates.  Every output is an integer: exact equality.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from nimble_tpu_torch.index.build import build_index
from nimble_tpu_torch.models.aligner import pack_reads
from nimble_tpu_torch.ops import span_walk as sw
from nimble_tpu_torch.ops.compact import probe_candidates
from nimble_tpu_torch.ops.device_index import build_bucketed_index
from nimble_tpu_torch.ops.device_tables import (
    IndexTables,
    tables_from_bucketed_index,
)
from nimble_tpu_torch.workload import allele_family

M32 = 0xFFFFFFFF


def _match_bits(words, phase, reads):
    """(B, C) python ints: bit p set where the candidate's reference base at
    read position p (its gathered window from ``phase``) equals read base
    p, p < Lmax; the kernel's step words."""
    B, C, NW = words.shape
    Lmax = reads.shape[1]
    w = words.astype(np.int64) & M32
    s = phase.astype(np.int64)[..., None] * 2
    aligned = ((w[..., :-1] >> s) | (w[..., 1:] << (32 - s))) & M32
    aligned = np.where(s == 0, w[..., :-1], aligned)
    p = np.arange(Lmax)
    codes = (aligned[..., p >> 4] >> (2 * (p & 15))) & 3          # (B, C, L)
    match = codes == reads[:, None, :]
    weights = [1 << i for i in range(Lmax)]
    return [[sum(wt for wt, hit in zip(weights, match[b, c]) if hit)
             for c in range(C)] for b in range(B)]


def _bits(steps: int, base: int) -> int:
    """Bits of steps base..base+31 (0 below step 0)."""
    return (steps >> base if base >= 0 else steps << -base) & M32


def _range_bits(base: int, lo: int, hi: int) -> int:
    def below(n):
        return 0 if n <= 0 else (M32 if n >= 32 else (1 << n) - 1)
    return below(hi - base) & ~below(lo - base) & M32


def _window(live: int, v: list, m: list, left: bool):
    """One window over the live lanes: (event bit or -1, matched steps,
    acted steps, new live mask)."""
    lanes = [c for c in range(len(v)) if live >> c & 1]
    any_m = any_a = 0
    all_m = all_a = M32
    for c in lanes:
        any_m |= m[c]
        all_m &= m[c]
        any_a |= v[c]
        all_a &= v[c]
    ev = ((any_m & ~all_m) | (~any_m & any_a & ~all_a)) & M32
    if ev == 0:
        return -1, bin(any_m).count("1"), bin(any_a).count("1"), live
    e = ev.bit_length() - 1 if left else (ev & -ev).bit_length() - 1
    upto = (M32 << e) & M32 if left else (2 << e) - 1
    pick = m if any_m >> e & 1 else v
    new = sum(1 << c for c in lanes if pick[c] >> e & 1)
    return (e, bin(any_m & upto).count("1"), bin(any_a & upto).count("1"),
            new)


def event_walk(reads, read_lens, anchor, base_off, r_len, live0, words,
               phase, *, k: int):
    """numpy model of ``nimble_walk::walk_lanes``: the arguments of
    ``fused_span_walk_plain`` (numpy arrays) -> (live (B, C) bool, score,
    mm, events per read)."""
    B, Lmax = reads.shape
    C = live0.shape[1]
    P = Lmax - k + 1
    steps = _match_bits(words, phase, reads)
    live_out = np.zeros((B, C), dtype=bool)
    score = np.zeros(B, dtype=np.int32)
    mm = np.zeros(B, dtype=np.int32)
    events = np.zeros(B, dtype=np.int32)
    clamp = lambda x, lo, hi: max(lo, min(int(x), hi))  # noqa: E731
    for b in range(B):
        anc = int(anchor[b])
        base = base_off[b].astype(np.int64)
        f_lo = clamp(anc + k, k, Lmax)
        f_hi = [min(clamp(r_len[b, c] - base[c], -1, Lmax),
                    min(int(read_lens[b]), Lmax)) for c in range(C)]
        l_lo = [clamp(-base[c], 0, Lmax) for c in range(C)]
        l_hi = clamp(anc, 0, P - 1)
        live = sum(1 << c for c in range(C) if live0[b, c])
        f_end = max([f_hi[c] for c in range(C)
                     if live0[b, c] and f_lo < f_hi[c]], default=0)
        l_beg = min([l_lo[c] for c in range(C)
                     if live0[b, c] and l_lo[c] < l_hi], default=Lmax)
        s = a = 0
        cur, top = f_lo, l_hi - 1

        def close_if_one(cur, top):
            """One live lane: its steps left in closed form, and the walk
            ends; (score, acts, cur, top) added / moved."""
            if bin(live).count("1") != 1 or (cur >= f_end and top < l_beg):
                return 0, 0, cur, top
            c = live.bit_length() - 1
            ds = da = 0
            for lo, hi in ((cur, f_hi[c]), (l_lo[c], min(l_hi, top + 1))):
                for w in range(lo, hi, 32):
                    v = _range_bits(w, lo, hi)
                    ds += bin(v & _bits(steps[b][c], w)).count("1")
                    da += bin(v).count("1")
            return ds, da, max(cur, f_end), min(top, l_beg - 1)

        ds, da, cur, top = close_if_one(cur, top)
        s, a = s + ds, a + da
        while cur < f_end:
            v = [_range_bits(cur, f_lo, f_hi[c]) if live >> c & 1 else 0
                 for c in range(C)]
            m = [v[c] & _bits(steps[b][c], cur) for c in range(C)]
            e, ds, da, live = _window(live, v, m, left=False)
            s, a, events[b] = s + ds, a + da, events[b] + (e >= 0)
            cur = cur + 32 if e < 0 else cur + e + 1
            ds, da, cur, top = close_if_one(cur, top)
            s, a = s + ds, a + da
        while top >= l_beg:
            lo = top - 31
            v = [_range_bits(lo, l_lo[c], l_hi) if live >> c & 1 else 0
                 for c in range(C)]
            m = [v[c] & _bits(steps[b][c], lo) for c in range(C)]
            e, ds, da, live = _window(live, v, m, left=True)
            s, a, events[b] = s + ds, a + da, events[b] + (e >= 0)
            top = lo - 1 if e < 0 else lo + e - 1
            ds, da, cur, top = close_if_one(cur, top)
            s, a = s + ds, a + da
        live_out[b] = [(live >> c) & 1 for c in range(C)]
        score[b], mm[b] = s, a - s
    return live_out, score, mm, events


def _model_vs_plain(packed, anchor, rows, offs, live0, t, bucket, lib=None):
    """(model results, plain results) on the same candidates."""
    reads, read_lens = sw.unpack_reads(packed, bucket)
    args = {n: v.numpy() for n, v in sw.walk_args(
        reads, read_lens, anchor, rows, offs, live0, t, lib).items()}
    want = sw.span_walk_plain(packed, anchor, rows, offs, live0, t,
                              bucket=bucket, lib=lib)
    return event_walk(**args, k=t.k), want


def _assert_equal(got, want):
    live, score, mm, events = got
    np.testing.assert_array_equal(live, want[0].numpy())
    np.testing.assert_array_equal(score, want[1].numpy())
    np.testing.assert_array_equal(mm, want[2].numpy())


# --- hypothesis: allele-like references, C = 1..16 -------------------------

def _allele_case(seed, C, Lmax, k, divergence, shift_rate, B=24):
    """Rows copying row 0 with substitutions at ``divergence``, each cut to
    its own start and end (so lanes' valid intervals differ, both ways);
    reads from the uncut copies; per read C candidates, mostly the read's own offset in some
    row (they agree but at substitutions), a ``shift_rate`` of them
    shifted by 1-3 bases (they part at once), ~20% not live."""
    rng = np.random.default_rng(seed)
    n_rows = 6
    first = rng.integers(0, 4, 400).astype(np.int8)
    alleles, cuts, rows_codes = [], [], []
    for r in range(n_rows):
        c = first.copy()
        if r:
            sites = rng.random(len(c)) < divergence
            c[sites] = (c[sites] + rng.integers(1, 4, int(sites.sum()))) % 4
        lo = 0 if r == 0 else int(rng.integers(0, 60))
        hi = len(c) if r == 0 else len(c) - int(rng.integers(0, 60))
        alleles.append(c)
        cuts.append(lo)
        rows_codes.append(c[lo:hi])
    row_lengths = np.array([len(c) for c in rows_codes], dtype=np.int32)
    row_starts = np.concatenate(([0], np.cumsum(row_lengths)[:-1]))
    ref_pad = Lmax + 16
    flat = np.concatenate([np.zeros(ref_pad, np.int8), *rows_codes,
                           np.zeros(ref_pad + 32, np.int8)]).astype(np.uint32)
    words = np.zeros((len(flat) + 15) // 16 + 4, dtype=np.uint32)
    np.bitwise_or.at(words, np.arange(len(flat)) >> 4,
                     flat << ((np.arange(len(flat)) & 15) * 2).astype(np.uint32))
    reads = np.zeros((B, Lmax), dtype=np.int8)
    lens = rng.integers(k + 1, Lmax + 1, B).astype(np.int32)
    # reads from the uncut alleles, so a read may start before a cut row
    # starts or end after it ends (at pos0 in every allele's coordinates)
    pos0 = rng.integers(0, 400 - Lmax + 1, B)
    src = rng.integers(0, n_rows, B)
    for i in range(B):
        reads[i, :lens[i]] = alleles[src[i]][pos0[i]:pos0[i] + lens[i]]
        if rng.random() < 0.3:
            j = int(rng.integers(0, lens[i]))
            reads[i, j] = (reads[i, j] + 1) % 4
    anchor = rng.integers(0, lens - k + 1).astype(np.int64)
    rows = rng.integers(0, n_rows, (B, C))
    offs = (pos0[:, None] - np.array(cuts)[rows] + anchor[:, None])
    shift = rng.random((B, C)) < shift_rate
    offs = offs + shift * rng.choice([-3, -2, -1, 1, 2, 3], (B, C))
    live0 = rng.random((B, C)) < 0.8
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))  # noqa: E731,E501
    empty = torch.zeros(1, dtype=torch.int32)
    t = IndexTables(
        k=k, width=8, max_probe=1, bucket_mask=0, ref_pad=ref_pad,
        bkey_lo=empty, bkey_hi=empty, bkey_fp=empty, bstart=empty,
        bcount=empty, postings_row=empty, postings_off=empty,
        ref_codes_packed=torch.from_numpy(words.view(np.int32)),
        row_starts=i32(row_starts), row_lengths=i32(row_lengths))
    packed = torch.from_numpy(pack_reads(reads, lens, Lmax))
    return (packed, torch.from_numpy(anchor),
            torch.from_numpy(rows.astype(np.int64)),
            torch.from_numpy(offs.astype(np.int64)),
            torch.from_numpy(live0), t, Lmax)


@settings(max_examples=60, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**32 - 1), C=st.integers(1, 16),
       Lmax=st.sampled_from([32, 64, 90, 92, 96, 128, 150, 200]),
       k=st.sampled_from([12, 20, 30]),
       divergence=st.sampled_from([0.0, 0.01, 0.05, 0.2]),
       shift_rate=st.sampled_from([0.0, 0.1, 0.5]))
def test_event_walk_equals_the_step_walk(seed, C, Lmax, k, divergence,
                                         shift_rate):
    case = _allele_case(seed, C, Lmax, k, divergence, shift_rate)
    got, want = _model_vs_plain(*case)
    _assert_equal(got, want)
    assert (got[3] <= np.maximum(C - 1, 0)).all()  # an event drops a lane


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_event_walk_on_the_allele_family_library(seed):
    """``workload.allele_family`` (8 alleles, 1% apart, doubled), 256 reads
    of 90 bp probed at bucket 92 with c_max 8: most reads keep several
    candidates live, and the walk ends on events, not on the steps."""
    bucket, n = 92, 256
    _feats, doubled, mat = allele_family(n_reads=n, seed=seed)
    t = tables_from_bucketed_index(
        build_bucketed_index(build_index(doubled)), "cpu")
    lens = np.full(n, mat.shape[1], dtype=np.int32)
    packed = torch.from_numpy(pack_reads(mat, lens, bucket))
    cand = probe_candidates(packed, t, bucket=bucket, c_max=8)
    got, want = _model_vs_plain(cand.packed, cand.anchor, cand.rows,
                                cand.offs, cand.live0, t, bucket)
    _assert_equal(got, want)
    several = (cand.live0.sum(dim=1) >= 2).float().mean().item()
    assert several > 0.5, several
    assert (got[3] > 0).mean() > 0.3  # reads whose live set changes
    assert (got[3] <= 7).all()
