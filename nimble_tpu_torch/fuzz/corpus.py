"""The campaigns' random corpora: libraries, reads, FASTQ files and BAM
record streams, biased toward the cases that break an engine.

Each generator is a copy of the JAX package's campaign scripts'
(``scripts/fuzz_differential.py``, ``scripts/fuzz_fastq.py``,
``scripts/fuzz_bam.py``) and draws from its ``numpy`` generator in exactly
their order, so that one child seed gives the same corpus in both packages.
A trial's draws are one ``draw_*_trial(rng)`` call: the library, the reads
or records and the ``AlignFilterConfig``, including the draws those scripts
make inline between their generator calls.  Only the draws matter for that
equality: one draw moved (a ``rng.random()`` hoisted out of a branch)
changes every later trial.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from nimble_tpu_torch.config import AlignFilterConfig, LibraryChemistry
from nimble_tpu_torch.io.bam import (
    FLAG_FIRST_IN_TEMPLATE,
    FLAG_LAST_IN_TEMPLATE,
    FLAG_MATE_REVERSE,
    FLAG_PAIRED,
    FLAG_REVERSE,
    BamHeader,
    BamRecord,
)
from nimble_tpu_torch.library import Reference
from nimble_tpu_torch.utils.dna import encode_bases, revcomp

BASES = np.array(list("ACGT"))
# the BAM campaign's header (one reference sequence, unsorted)
BAM_HEADER = BamHeader(
    text="@HD\tVN:1.6\tSO:unknown\n@SQ\tSN:chr1\tLN:1000000\n",
    references=[("chr1", 1_000_000)],
)


def rand_seq(rng, n):
    return "".join(rng.choice(BASES, size=n))


def _doubled(feats):
    return [x for f in feats for x in (f, revcomp(f))]


def _has_kmers(doubled) -> bool:
    """An index of ``doubled`` holds a k-mer (the loader rejects one that
    holds none)."""
    return any(len(f) >= 30 for f in doubled)


# --- the engine campaign (scripts/fuzz_differential.py) -------------------

def make_library(rng):
    """Random library shapes, biased toward the nasty cases."""
    style = int(rng.integers(0, 5))
    feats = []
    if style == 0:  # plain random
        for _ in range(int(rng.integers(2, 10))):
            feats.append(rand_seq(rng, int(rng.integers(35, 400))))
    elif style == 1:  # heavy shared k-mer blocks (anchor ties, c_max stress)
        block = rand_seq(rng, int(rng.integers(30, 60)))
        for _ in range(int(rng.integers(3, 14))):
            feats.append(
                rand_seq(rng, int(rng.integers(0, 40))) + block
                + rand_seq(rng, int(rng.integers(0, 40)))
            )
    elif style == 2:  # internal repeats (same k-mer at multiple offsets)
        unit = rand_seq(rng, int(rng.integers(31, 50)))
        feats.append(unit * int(rng.integers(2, 4)))
        feats.append(rand_seq(rng, 120))
    elif style == 3:  # short features (< k -> no k-mers) mixed with normal
        feats.append(rand_seq(rng, int(rng.integers(5, 29))))
        feats.append(rand_seq(rng, int(rng.integers(100, 250))))
        feats.append(rand_seq(rng, 30))  # exactly one k-mer
    else:  # low-complexity / homopolymer-rich
        feats.append("A" * int(rng.integers(60, 150)))
        feats.append(("AC" * 100)[: int(rng.integers(60, 150))])
        feats.append(rand_seq(rng, 150))
    return feats, _doubled(feats)


def make_reads(rng, feats, n_reads):
    """Encoded reads: clean and reverse-complemented fragments, mutations,
    chimeras, lengths around MIN_READ_LENGTH, low entropy, reads longer
    than every feature and junk."""
    reads = []
    pool = [f for f in feats if len(f) >= 35] or feats
    for _ in range(n_reads):
        kind = int(rng.integers(0, 8))
        f = pool[int(rng.integers(0, len(pool)))]
        if kind <= 1:  # clean fragment (sometimes revcomp)
            L = min(len(f), int(rng.integers(35, 130)))
            s = int(rng.integers(0, max(1, len(f) - L + 1)))
            seq = f[s : s + L]
            if kind == 1:
                seq = revcomp(seq)
        elif kind == 2:  # mutated fragment
            L = min(len(f), int(rng.integers(40, 130)))
            s = int(rng.integers(0, max(1, len(f) - L + 1)))
            seq = list(f[s : s + L])
            for _ in range(int(rng.integers(1, 6))):
                p = int(rng.integers(0, len(seq)))
                seq[p] = "ACGT"[int(rng.integers(0, 4))]
            seq = "".join(seq)
        elif kind == 3:  # chimera
            g = pool[int(rng.integers(0, len(pool)))]
            L = int(rng.integers(40, 120))
            seq = f[: L // 2] + g[: L - L // 2]
        elif kind == 4:  # boundary lengths: 39/40/41 around MIN_READ_LENGTH
            L = int(rng.choice([39, 40, 41, 30, 69, 70]))
            s = int(rng.integers(0, max(1, len(f) - min(L, len(f)) + 1)))
            seq = (f + rand_seq(rng, L))[s : s + L]
        elif kind == 5:  # entropy boundary: mostly-homopolymer with salt
            L = int(rng.integers(40, 90))
            seq = list("A" * L)
            for _ in range(int(rng.integers(0, 12))):
                seq[int(rng.integers(0, L))] = "ACGT"[int(rng.integers(0, 4))]
            seq = "".join(seq)
        elif kind == 6:  # read longer than every feature
            seq = f + rand_seq(rng, int(rng.integers(10, 80)))
        else:  # junk
            seq = rand_seq(rng, int(rng.integers(35, 130)))
        reads.append(encode_bases(seq))
    return reads


@dataclass
class DifferentialTrial:
    feats: List[str]
    doubled: List[str]
    reads: List[np.ndarray]  # int8 codes
    config: AlignFilterConfig


def draw_differential_trial(rng) -> Optional[DifferentialTrial]:
    """One trial of the engine campaign (``fuzz_differential.py:115-126``);
    None when the library holds no k-mer (the script skips the trial)."""
    feats, doubled = make_library(rng)
    if not _has_kmers(doubled):
        return None
    reads = make_reads(rng, feats, int(rng.integers(20, 80)))
    cfg = AlignFilterConfig(
        reference_genome_size=len(doubled),
        score_percent=float(rng.choice([0.05, 0.1, 0.33, 0.5, 0.9])),
        score_threshold=int(rng.choice([20, 30, 45, 60, 80])),
        num_mismatches=int(rng.integers(0, 5)),
        max_hits_to_report=int(rng.choice([1, 3, 10, 32])),
        discard_multiple_matches=bool(rng.integers(0, 2)),
    )
    return DifferentialTrial(feats, doubled, reads, cfg)


# --- the FASTQ campaign (scripts/fuzz_fastq.py) ---------------------------

def make_fastq_library(rng):
    """Random doubled library + Reference, sometimes with a group_on
    rollup column (the basic-cases group_by shape)."""
    style = int(rng.integers(0, 4))
    feats = []
    if style == 0:
        for _ in range(int(rng.integers(2, 8))):
            feats.append(rand_seq(rng, int(rng.integers(40, 300))))
    elif style == 1:  # shared-block features (eq-class ties, multi-hits)
        block = rand_seq(rng, int(rng.integers(30, 60)))
        for _ in range(int(rng.integers(3, 8))):
            feats.append(
                rand_seq(rng, int(rng.integers(0, 30))) + block
                + rand_seq(rng, int(rng.integers(0, 30)))
            )
    elif style == 2:  # palindromic-ish: feature contains its own revcomp
        core = rand_seq(rng, int(rng.integers(35, 70)))
        feats.append(core + revcomp(core))
        feats.append(rand_seq(rng, 150))
    else:  # mixed short / normal
        feats.append(rand_seq(rng, int(rng.integers(10, 29))))
        feats.append(rand_seq(rng, int(rng.integers(100, 220))))
        feats.append(rand_seq(rng, 31))
    doubled = _doubled(feats)
    names = []
    for i in range(len(feats)):
        names += [f"f{i:02d}", f"f{i:02d}§rev"]
    columns = [names, doubled]
    headers = ["sequence_name", "sequence"]
    group_on = 0
    if rng.random() < 0.4:  # group_on rollup column
        headers.append("family")
        n_groups = int(rng.integers(1, 4))
        fam = []
        for i in range(len(feats)):
            g = f"g{int(rng.integers(0, n_groups))}"
            fam += [g, g]
        columns.append(fam)
        group_on = 2
    ref = Reference(group_on=group_on, headers=headers, columns=columns,
                    sequence_name_idx=0, sequence_idx=1)
    return feats, doubled, ref


def make_fastq_reads(rng, feats, n_reads, paired):
    """(r1, r2|None) string lists; duplicate-heavy with revcomp/mutation/
    chimera/junk shapes, aimed at the counting and orientation tail (reads
    mostly hit)."""
    pool = [f for f in feats if len(f) >= 40] or feats
    r1s, r2s = [], []
    for _ in range(n_reads):
        f = pool[int(rng.integers(0, len(pool)))]
        kind = int(rng.integers(0, 10))
        L = min(len(f), int(rng.integers(40, 120)))
        s = int(rng.integers(0, max(1, len(f) - L + 1)))
        seq = f[s : s + L]
        if kind == 0:
            seq = revcomp(seq)
        elif kind == 1:  # mutated
            sl = list(seq)
            for _ in range(int(rng.integers(1, 4))):
                sl[int(rng.integers(0, len(sl)))] = (
                    "ACGT"[int(rng.integers(0, 4))])
            seq = "".join(sl)
        elif kind == 2:  # chimera across two features
            g = pool[int(rng.integers(0, len(pool)))]
            seq = seq[: L // 2] + g[: L - L // 2]
        elif kind == 3:  # junk
            seq = rand_seq(rng, L)
        r1s.append(seq)
        if paired:
            mk = int(rng.integers(0, 4))
            if mk == 0:
                r2s.append(revcomp(seq))        # proper mate
            elif mk == 1:
                g = pool[int(rng.integers(0, len(pool)))]
                L2 = min(len(g), int(rng.integers(40, 120)))
                s2 = int(rng.integers(0, max(1, len(g) - L2 + 1)))
                frag = g[s2 : s2 + L2]
                r2s.append(revcomp(frag) if rng.integers(0, 2) else frag)
            elif mk == 2:
                r2s.append(seq)                  # same-orientation mate
            else:
                r2s.append(rand_seq(rng, L))     # junk mate
    # duplicate-heavy: repeat a slice of the reads (pre-upload dedupe path;
    # the reference's score map counts duplicate pairs once)
    if n_reads >= 4 and rng.random() < 0.7:
        k = int(rng.integers(1, max(2, n_reads // 2)))
        idx = rng.integers(0, n_reads, size=k)
        for i in idx:
            r1s.append(r1s[int(i)])
            if paired:
                r2s.append(r2s[int(i)])
    return r1s, (r2s if paired else None)


def write_fastq(path, seqs, gz):
    op = gzip.open if gz else open
    with op(path, "wt") as f:
        for i, s in enumerate(seqs):
            f.write(f"@r{i:06d}\n{s}\n+\n{'I' * len(s)}\n")


@dataclass
class FastqLibrary:
    feats: List[str]
    doubled: List[str]
    reference: Reference
    config: AlignFilterConfig


@dataclass
class FastqTrial:
    libraries: List[FastqLibrary]  # two for a multi-library trial
    paired: bool
    r1s: List[str]
    r2s: Optional[List[str]]
    gz: bool
    use_mesh: bool


def draw_fastq_trial(rng) -> Optional[FastqTrial]:
    """One trial of the FASTQ campaign (``fuzz_fastq.py:174-234``); None
    when the library holds no k-mer (the script skips the trial)."""
    feats, doubled, ref = make_fastq_library(rng)
    if not _has_kmers(doubled):
        return None
    chem = LibraryChemistry(
        str(rng.choice(["none", "unstranded", "fiveprime", "threeprime"])))
    paired = bool(rng.integers(0, 2))
    cfg = AlignFilterConfig(
        reference_genome_size=len(doubled),
        score_percent=float(rng.choice([0.05, 0.1, 0.33, 0.5])),
        score_threshold=int(rng.choice([20, 30, 45, 60])),
        num_mismatches=int(rng.integers(0, 4)),
        max_hits_to_report=int(rng.choice([1, 3, 10])),
        discard_multiple_matches=bool(rng.random() < 0.2),
        require_valid_pair=bool(paired and rng.random() < 0.3),
        discard_multi_hits=int(rng.choice([0, 0, 0, 1, 2])),
        intersect_level=int(rng.choice([0, 1, 2])) if paired else 0,
        strand_filter=chem,
    )
    n_reads = int(rng.integers(6, 60))
    r1s, r2s = make_fastq_reads(rng, feats, n_reads, paired)
    gz = rng.random() < 0.3
    libraries = [FastqLibrary(feats, doubled, ref, cfg)]
    use_mesh = False
    multi_lib = rng.random() < 0.25
    if multi_lib:
        # second independent library: the multi-library single-pass
        # dispatcher must match per-library sequential slow runs
        feats2, doubled2, ref2 = make_fastq_library(rng)
        if not _has_kmers(doubled2):
            multi_lib = False
    if multi_lib:
        cfg2 = AlignFilterConfig(
            reference_genome_size=len(doubled2),
            score_percent=cfg.score_percent,
            score_threshold=cfg.score_threshold,
            num_mismatches=int(rng.integers(0, 4)),
            max_hits_to_report=cfg.max_hits_to_report,
            intersect_level=cfg.intersect_level,
            require_valid_pair=cfg.require_valid_pair,
            strand_filter=chem,
        )
        libraries.append(FastqLibrary(feats2, doubled2, ref2, cfg2))
    else:
        use_mesh = rng.random() < 0.12
    return FastqTrial(libraries, paired, r1s, r2s, gz, use_mesh)


# --- the BAM campaign (scripts/fuzz_bam.py) -------------------------------

def make_stream(rng, feats):
    """A randomized record stream grouped in UMI runs (stream order is
    semantic: consecutive same-UMI records form one SortedBamReader run)."""
    records = []
    qn = 0
    n_groups = int(rng.integers(2, 10))
    for g in range(n_groups):
        umi = ("AAAAAAAAAA" if rng.random() < 0.08
               else rand_seq(rng, 10))
        # several cell barcodes inside one UMI run (CB sort inside the run)
        cbs = [f"CB{int(rng.integers(0, 5)):04d}-1"
               for _ in range(int(rng.integers(1, 3)))]
        for _ in range(int(rng.integers(1, 6))):
            cb = cbs[int(rng.integers(0, len(cbs)))]
            kind = int(rng.integers(0, 10))
            f = feats[int(rng.integers(0, len(feats)))]
            L = int(rng.choice([50, 70, 90, 124]))
            s = int(rng.integers(0, max(1, len(f) - min(L, len(f)) + 1)))
            frag = (f + rand_seq(rng, L))[s : s + L]
            if rng.random() < 0.3:  # substitutions
                fl = list(frag)
                for _ in range(int(rng.integers(1, 4))):
                    fl[int(rng.integers(0, len(fl)))] = (
                        "ACGT"[int(rng.integers(0, 4))])
                frag = "".join(fl)

            def tag(r, missing_cb=False, ur_only=False, no_umi=False):
                if not missing_cb:
                    r.tags["CB"] = ("Z", cb)
                if not no_umi:
                    if ur_only:
                        r.tags["UR"] = ("Z", umi)
                    else:
                        r.tags["UB"] = ("Z", umi)
                        r.tags["UR"] = ("Z", umi)

            missing_cb = kind == 7  # skipped by the CB rule
            ur_only = kind == 8     # UB->UR fallback
            # rare: a kept record with NO UMI at all — both pipelines must
            # raise the same "Could not read UMI" after identical output
            no_umi = kind == 5 and rng.random() < 0.1
            if kind == 9:
                # unpaired read (dummy-pair injection downstream)
                r = BamRecord(
                    qname=f"q{qn:06d}", flag=0, pos=300, mpos=-1, tlen=0,
                    seq=frag, qual=bytes([30 + int(rng.integers(0, 10))]
                                         * len(frag)),
                    tid=0, mtid=-1, mapq=60,
                )
                qn += 1
                tag(r, missing_cb, ur_only, no_umi)
                records.append(r)
                continue
            rev1 = bool(rng.integers(0, 2))
            frag2 = revcomp(frag) if rng.random() < 0.5 else rand_seq(
                rng, len(frag))
            r1 = BamRecord(
                qname=f"q{qn:06d}",
                flag=(FLAG_PAIRED | FLAG_FIRST_IN_TEMPLATE
                      | (FLAG_REVERSE if rev1 else 0)
                      | (0 if rev1 else FLAG_MATE_REVERSE)),
                pos=100, mpos=200, tlen=150,
                seq=frag, qual=bytes([37] * len(frag)),
                tid=0, mtid=0, mapq=60,
            )
            r2 = BamRecord(
                qname=f"q{qn:06d}",
                flag=(FLAG_PAIRED | FLAG_LAST_IN_TEMPLATE
                      | (0 if rev1 else FLAG_REVERSE)
                      | (FLAG_MATE_REVERSE if rev1 else 0)),
                pos=200, mpos=100, tlen=-150,
                seq=frag2, qual=bytes([37] * len(frag2)),
                tid=0, mtid=0, mapq=60,
            )
            qn += 1
            tag(r1, missing_cb, ur_only, no_umi)
            tag(r2, missing_cb, ur_only, no_umi)
            if kind == 6 and rng.random() < 0.5:
                records.append(r1)  # orphan: mate never written
            else:
                records.extend([r1, r2])
    return records


@dataclass
class BamTrial:
    feats: List[str]
    doubled: List[str]
    reference: Reference
    config: AlignFilterConfig
    records: List[BamRecord]


def draw_bam_trial(rng) -> BamTrial:
    """One trial of the BAM campaign (``fuzz_bam.py:168-190``)."""
    feats = [rand_seq(rng, int(rng.integers(80, 300)))
             for _ in range(int(rng.integers(2, 6)))]
    doubled = _doubled(feats)
    names = []
    for i in range(len(feats)):
        names += [f"f{i}", f"f{i}§rev"]
    ref = Reference(
        group_on=0, headers=["sequence_name", "sequence"],
        columns=[names, doubled], sequence_name_idx=0,
        sequence_idx=1,
    )
    cfg = AlignFilterConfig(
        reference_genome_size=len(doubled),
        score_percent=float(rng.choice([0.1, 0.33, 0.5])),
        score_threshold=int(rng.choice([25, 45, 60])),
        num_mismatches=int(rng.integers(0, 4)),
        max_hits_to_report=10,
        require_valid_pair=bool(rng.integers(0, 2)),
    )
    return BamTrial(feats, doubled, ref, cfg, make_stream(rng, feats))
