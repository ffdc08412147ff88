"""Synthetic workloads written to disk, made from a seed.

Shaped like ``bench.py``'s ``build_workload``: random features (the library
JSON doubles each with its reverse complement at load), reads sampled as
fragments of the doubled rows, ~20% with one substitution and ~5% replaced
by junk.  :func:`generate` draws the same library as ``build_workload`` for
the same seed, but not the same reads: its starts come from ``[0, feat_len
- span + 1)``, where ``build_workload`` draws them from ``[0, feat_len -
read_len)``, and its R2 mates are fragments further down the row, where
``bench.py --paired`` takes the reverse complement of each R1.  The bench's
exact arrays are ``nimble_tpu_torch.bench.build_workload`` (and
``bench.paired_mates``).  ``write_workload`` writes the library JSON and the
FASTQ file(s) that the CLI reads, so a run exercises the whole path from
parsing to the TSV.  ``write_bam_workload`` writes the same library with a
synthetic 10x BAM over it, the recipe of ``bench.py --bam``.
``write_multi_workload`` / ``write_multi_bam_workload`` write several
libraries (library i from seed ``seed + i``) and one input drawn from all of
them, the recipe of ``bench.py --libraries``.  :func:`allele_family` draws
a library of near-identical alleles, whose reads keep several candidates
live through the walk.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from nimble_tpu_torch.io.synth import make_synthetic_bam
from nimble_tpu_torch.utils.dna import encode_bases, revcomp

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclass(frozen=True)
class Workload:
    library: str                 # library JSON path
    inputs: List[str]            # the CLI's -i files: R1 (and R2), or the BAM


@dataclass(frozen=True)
class MultiWorkload:
    libraries: List[str]         # one library JSON path per library
    inputs: List[str]            # the CLI's -i files


def library_json(features: List[str]) -> list:
    """A library in the reference's two-element JSON layout, with the bench
    workload's filter settings."""
    names = [f"feature{i}" for i in range(len(features))]
    cfg = {
        "trim_target_length": 40, "trim_strictness": 0.9,
        "score_percent": 0.33, "score_filter": 25,
        "score_threshold": 50, "num_mismatches": 1,
        "discard_multiple_matches": False, "max_hits_to_report": 10,
        "intersect_level": 0, "group_on": "", "discard_multi_hits": 0,
        "require_valid_pair": False, "data_type": "DNA",
    }
    table = {"headers": ["sequence_name", "sequence"],
             "columns": [names, list(features)]}
    return [cfg, table]


def write_fastq(path: str, mat: np.ndarray) -> None:
    """(n, L) 2-bit codes -> FASTQ with headers @r<index> and quality I."""
    n, L = mat.shape
    digits = 9
    head = np.empty((n, 2 + digits + 1), dtype=np.uint8)
    head[:, 0], head[:, 1], head[:, -1] = ord("@"), ord("r"), ord("\n")
    idx = np.arange(n, dtype=np.int64)
    for d in range(digits):
        head[:, 2 + d] = ord("0") + (idx // 10 ** (digits - 1 - d)) % 10
    seq = _BASES[mat.astype(np.int64)]
    nl = np.full((n, 1), ord("\n"), dtype=np.uint8)
    plus = np.frombuffer(b"+\n", dtype=np.uint8)[None, :].repeat(n, axis=0)
    qual = np.full((n, L), ord("I"), dtype=np.uint8)
    rec = np.concatenate([head, seq, nl, plus, qual, nl], axis=1)
    with open(path, "wb") as f:
        f.write(rec.tobytes())


def _features(rng, n_features: int, feat_len: int) -> List[str]:
    return ["".join(rng.choice(list("ACGT"), size=feat_len))
            for _ in range(n_features)]


def generate(*, n_features=50, feat_len=500, read_len=90, n_reads=1 << 16,
             seed=0, paired=False, mate_gap: Optional[int] = None):
    """Features and reads from ``seed``.

    Returns (features, doubled rows, R1 codes (n_reads, read_len) int8, R2
    codes or None).  R2 is the reverse complement of a fragment
    ``mate_gap`` bases (default ``read_len``) downstream on the same row.
    The features are ``bench.py``'s ``build_workload``'s for the same seed;
    the reads are not (see the module docstring).
    """
    rng = np.random.default_rng(seed)
    feats = _features(rng, n_features, feat_len)
    doubled = [x for s in feats for x in (s, revcomp(s))]
    codes = np.stack([encode_bases(s) for s in doubled])
    gap = read_len if mate_gap is None else mate_gap
    span = read_len + (gap + read_len if paired else 0)
    if span > feat_len:
        raise ValueError("reads (and mates) must fit inside a feature")
    rows = rng.integers(0, len(doubled), n_reads)
    starts = rng.integers(0, feat_len - span + 1, n_reads)

    def sample(offset):
        return _sample_reads(rng, codes, rows, starts + offset, read_len)

    r1 = sample(0)
    r2 = np.ascontiguousarray((3 - sample(read_len + gap))[:, ::-1]) \
        if paired else None
    return feats, doubled, r1, r2


def _sample_reads(rng, codes: np.ndarray, rows: np.ndarray,
                  starts: np.ndarray, read_len: int) -> np.ndarray:
    """Fragments ``codes[rows, starts:starts + read_len]`` with the bench's
    error model: ~20% with one substitution, ~5% replaced by junk."""
    n_reads = len(rows)
    mat = codes[rows[:, None], starts[:, None] + np.arange(read_len)]
    mat = np.ascontiguousarray(mat, dtype=np.int8)
    mutate = rng.random(n_reads) < 0.2
    pos = rng.integers(0, read_len, n_reads)
    delta = rng.integers(1, 4, n_reads).astype(np.int8)
    mat[mutate, pos[mutate]] = (mat[mutate, pos[mutate]] + delta[mutate]) % 4
    junk = rng.random(n_reads) < 0.05
    mat[junk] = rng.integers(0, 4, (int(junk.sum()), read_len), dtype=np.int8)
    return mat


# the allele family's shape (KIR / MHC-like): alleles of one feature, its
# length, each later allele's share of substituted positions, read length
ALLELES = 8
ALLELE_LEN = 1500
ALLELE_DIVERGENCE = 0.01
ALLELE_READ_LEN = 90


def allele_family(*, n_reads=8192, seed=0):
    """An allele family from ``seed``, the shape of a KIR or MHC library:
    ALLELES variants of one random feature of ALLELE_LEN bases, each allele
    after the first differing from it at ``round(ALLELE_DIVERGENCE *
    ALLELE_LEN)`` positions (a substitution each), and ``n_reads`` reads of
    ALLELE_READ_LEN bases sampled from the doubled rows with
    :func:`generate`'s error model.  Most reads hold several live
    candidates (the alleles sharing their k-mers) that part where the
    alleles differ.  Returns (features, doubled rows, (n_reads,
    ALLELE_READ_LEN) int8 codes)."""
    rng = np.random.default_rng(seed)
    first = encode_bases(_features(rng, 1, ALLELE_LEN)[0])
    n_sites = int(round(ALLELE_DIVERGENCE * ALLELE_LEN))
    alleles = [first]
    for _ in range(ALLELES - 1):
        codes = first.copy()
        sites = rng.choice(ALLELE_LEN, n_sites, replace=False)
        codes[sites] = (codes[sites] + rng.integers(1, 4, n_sites)) % 4
        alleles.append(codes)
    feats = [_BASES[a.astype(np.int64)].tobytes().decode() for a in alleles]
    doubled = [x for s in feats for x in (s, revcomp(s))]
    codes = np.stack([encode_bases(s) for s in doubled])
    rows = rng.integers(0, len(doubled), n_reads)
    starts = rng.integers(0, ALLELE_LEN - ALLELE_READ_LEN + 1, n_reads)
    return feats, doubled, _sample_reads(rng, codes, rows, starts,
                                         ALLELE_READ_LEN)


def _write_library(path: str, feats: List[str]) -> str:
    with open(path, "w") as f:
        json.dump(library_json(feats), f)
    return path


def write_workload(out_dir: str, **kw) -> Workload:
    """Write :func:`generate`'s library JSON and FASTQ file(s) (same
    keyword arguments) into ``out_dir``."""
    feats, _doubled, r1, r2 = generate(**kw)
    os.makedirs(out_dir, exist_ok=True)
    lib = _write_library(os.path.join(out_dir, "library.json"), feats)
    fastqs = [os.path.join(out_dir, "reads_R1.fastq")]
    write_fastq(fastqs[0], r1)
    if r2 is not None:
        fastqs.append(os.path.join(out_dir, "reads_R2.fastq"))
        write_fastq(fastqs[1], r2)
    return Workload(library=lib, inputs=fastqs)


def write_bam_workload(out_dir: str, *, n_features=50, feat_len=500,
                       n_groups=16384, seed=0) -> Workload:
    """Write the library JSON of :func:`generate` (same ``n_features``,
    ``feat_len``, ``seed``) and a synthetic 10x BAM over its features:
    ``n_groups`` UMI groups of 4 read pairs, 90 bp, every 5th fragment with
    one substitution (``bench.py --bam``'s recipe; 8 records per group)."""
    feats = _features(np.random.default_rng(seed), n_features, feat_len)
    os.makedirs(out_dir, exist_ok=True)
    lib = _write_library(os.path.join(out_dir, "library.json"), feats)
    bam = os.path.join(out_dir, "reads.bam")
    make_synthetic_bam(bam, feats, n_groups=n_groups, pairs_per_group=4,
                       read_len=90, seed=seed + 1, mutate_every=5,
                       stream=True)
    return Workload(library=lib, inputs=[bam])


def write_multi_workload(out_dir: str, *,
                         libraries: Sequence[Tuple[int, int]],
                         read_len=90, n_reads=1 << 16,
                         seed=0) -> MultiWorkload:
    """Write one library JSON per ``(n_features, feat_len)`` of
    ``libraries`` (library i from :func:`generate` with seed ``seed + i``)
    and one FASTQ of ``n_reads // L`` reads from each library in turn:
    ``bench.py --libraries``'s mixed workload, each library's reads the
    first of the ``n_reads`` its generator draws."""
    os.makedirs(out_dir, exist_ok=True)
    per = n_reads // len(libraries)
    paths, mats = [], []
    for i, (n_features, feat_len) in enumerate(libraries):
        feats, _doubled, r1, _ = generate(
            n_features=n_features, feat_len=feat_len, read_len=read_len,
            n_reads=n_reads, seed=seed + i)
        paths.append(_write_library(
            os.path.join(out_dir, f"library{i}.json"), feats))
        mats.append(r1[:per])
    fastq = os.path.join(out_dir, "reads_R1.fastq")
    write_fastq(fastq, np.concatenate(mats))
    return MultiWorkload(libraries=paths, inputs=[fastq])


def write_multi_bam_workload(out_dir: str, *,
                             libraries: Sequence[Tuple[int, int]],
                             n_groups=16384, seed=0) -> MultiWorkload:
    """Write one library JSON per ``(n_features, feat_len)`` (library i's
    features from seed ``seed + i``, as :func:`write_bam_workload` draws
    them) and a synthetic 10x BAM (``write_bam_workload``'s recipe, seed
    ``seed + L``) whose fragments come from all libraries' features."""
    os.makedirs(out_dir, exist_ok=True)
    paths, all_feats = [], []
    for i, (n_features, feat_len) in enumerate(libraries):
        feats = _features(np.random.default_rng(seed + i), n_features,
                          feat_len)
        paths.append(_write_library(
            os.path.join(out_dir, f"library{i}.json"), feats))
        all_feats += feats
    bam = os.path.join(out_dir, "reads.bam")
    make_synthetic_bam(bam, all_feats, n_groups=n_groups, pairs_per_group=4,
                       read_len=90, seed=seed + len(libraries),
                       mutate_every=5, stream=True)
    return MultiWorkload(libraries=paths, inputs=[bam])
