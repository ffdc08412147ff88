"""Frozen copies of the port's plain host code: the calls after the walk.

The reference's per-read semantics after alignment are nimble's
(``src/align.rs``, ``src/process/bam.rs``), which the port's host modules
carry as plain Python.  This module holds a copy of those definitions,
taken whole from ``nimble_tpu_torch`` (each block names its source file;
only ``maxinfo_batch`` lost its columnar branch, which calls the program's
native library), so the check keeps judging the program by the same rules
when a later change edits the program's copies.  It imports nothing of the
program.  What the program runs on the card (the probe, the candidates,
the walk and its gates) the reference recomputes in
:mod:`portbench.reference.align` instead.
"""

from __future__ import annotations

import enum
import functools
import json
import math
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np

# --- frozen from nimble_tpu_torch/config.py -------------------------------

# Minimum post-trim read length accepted by the aligner (`src/align.rs:18`).
MIN_READ_LENGTH = 40


# Minimum Shannon entropy (bits) of a read's base composition (`src/align.rs:19`).
MIN_ENTROPY_SCORE = 1.75


# k-mer size used by the pseudoalignment index (`src/bin/main.rs:122`, Kmer30).
KMER_SIZE = 30


class IntersectLevel(enum.IntEnum):
    """How R1/R2 feature calls are merged into one callset (`src/align.rs:26-30`).

    JSON config encodes these as 0/1/2 (`src/reference_library.rs:61-66`).
    """

    NO_INTERSECT = 0
    INTERSECT_WITH_FALLBACK = 1
    FORCE_INTERSECT = 2


class LibraryChemistry(enum.Enum):
    """Library strandedness, driving orientation filters (`src/align.rs:97-103`).

    CLI values: unstranded (default) / fiveprime / threeprime / none
    (`src/bin/main.rs:40-47`).
    """

    UNSTRANDED = "unstranded"
    FIVE_PRIME = "fiveprime"
    THREE_PRIME = "threeprime"
    NONE = "none"

    @staticmethod
    def from_cli(value: str) -> "LibraryChemistry":
        try:
            return LibraryChemistry(value)
        except ValueError:
            raise ValueError("Could not parse strand_filter option.") from None


class FilterReason(enum.Enum):
    """Per-read filtration outcome (`src/align.rs:33-51`).

    ``str()`` yields the display strings used in the BAM forensic TSV,
    including the reference's quirks ("Low Entropy" for HIGH_ENTROPY and the
    "SKipped" typo) — `src/align.rs:53-77`.
    """

    SCORE_BELOW_THRESHOLD = "Score Below Threshold"
    DISCARDED_MULTIPLE_MATCH = "Discarded Multiple Match"
    DISCARDED_NONZERO_MISMATCH = "Discarded Nonzero Mismatch"
    NO_MATCH = "No Match"
    NO_MATCH_AND_SCORE_BELOW_THRESHOLD = "No Match and Score Below Threshold"
    DIFFERENT_FILTER_REASONS = "Different Filter Reasons"
    NOT_MATCHING_PAIR = "Required Valid Pair Not Matching"
    FORCE_INTERSECT_FAILURE = "Force Intersect Failure"
    SHORT_READ = "Short Read"
    MAX_HITS_EXCEEDED = "Max Hits Exceeded"
    # NB: the reference's variant is misnamed; it filters LOW-complexity reads
    # and displays "Low Entropy" (`src/align.rs:44,68`).
    HIGH_ENTROPY = "Low Entropy"
    SUCCESSFUL_MATCH = "Successful Match"
    STRAND_WAS_WRONG = "Strandedness Filtered"
    TRIAGE_EMPTY_EQUIVALENCE_CLASS = "Equivalence Class Empty After Filters"
    ABOVE_MISMATCH_THRESHOLD = "Above Mismatch Threshold"
    SKIPPED_ALIGN_DUE_TO_UNPAIRED_DUMMY = "SKipped Align Due To Unpaired Dummy Read"
    NONE = "None"

    def __str__(self) -> str:  # display parity with `src/align.rs:53-77`
        return self.value


# stable integer codes for FilterReason (columnar device/host interchange)
FILTER_REASONS = tuple(FilterReason)


FILTER_REASON_CODE = {r: i for i, r in enumerate(FILTER_REASONS)}


class AlignmentOrientation(enum.Enum):
    """Combined read-pair/feature orientation label (`src/align.rs:105-134`)."""

    FF = "FF"
    RR = "RR"
    UU = "UU"
    FR = "FR"
    FU = "FU"
    RF = "RF"
    RU = "RU"
    UF = "UF"
    UR = "UR"
    NONE = "None"

    def __str__(self) -> str:
        return self.value


class PairState(enum.Enum):
    """Which mates of a read pair produced a passing alignment (`src/align.rs:378-384`)."""

    FIRST = "First"
    SECOND = "Second"
    BOTH = "Both"
    NONE = "None"


@dataclass
class AlignFilterConfig:
    """The aligner's full configuration surface (`src/align.rs:79-95`).

    Field semantics (JSON keys parsed in `src/reference_library.rs:28-78`):
      reference_genome_size     — number of (doubled) library rows
      score_percent             — min normalized score (score/len) to keep a hit
      score_threshold           — min raw coverage score to keep a hit
      num_mismatches            — max tolerated mismatching bases per read
      discard_nonzero_mismatch  — hardcoded False from JSON (`reference_library.rs:116`)
      discard_multiple_matches  — drop hits whose equivalence class has >1 row
      score_filter              — parsed + validated but never used by the align
                                  path (dead knob, `reference_library.rs:33-35,118`)
      intersect_level           — R1/R2 callset merge strategy
      require_valid_pair        — drop pairs whose mates' eq classes differ
      discard_multi_hits        — post-rollup: drop callsets larger than this (0=off)
      max_hits_to_report        — drop read-pairs calling more features than this
      strand_filter             — library chemistry for orientation filtering
      trim_strictness / trim_target_length — MAXINFO quality-trimmer params
    """

    reference_genome_size: int = 0
    score_percent: float = 0.0
    score_threshold: int = 0
    num_mismatches: int = 0
    discard_nonzero_mismatch: bool = False
    discard_multiple_matches: bool = False
    score_filter: int = 0
    intersect_level: IntersectLevel = IntersectLevel.NO_INTERSECT
    require_valid_pair: bool = False
    discard_multi_hits: int = 0
    max_hits_to_report: int = 0
    strand_filter: LibraryChemistry = LibraryChemistry.NONE
    trim_strictness: float = 0.0
    trim_target_length: int = 0

    def sanity_check(self) -> None:
        """Range validation, parity with `src/reference_library.rs:209-226`."""
        if not (0.0 <= self.score_percent <= 1.0):
            raise ValueError("Error -- score_percent must be between 0 and 1")
        if self.score_filter < 0:
            raise ValueError("Error -- score_filter must be positive")
        if not (0.0 <= self.trim_strictness <= 1.0):
            raise ValueError("Error -- trim_strictness must be between 0 and 1")



# --- frozen from nimble_tpu_torch/utils/dna.py ----------------------------

# byte -> 2-bit code lookup (unknown -> 0, mirroring DnaString::from_acgt_bytes)
_ENCODE_LUT = np.zeros(256, dtype=np.int8)
for _ch, _code in (("A", 0), ("a", 0), ("C", 1), ("c", 1),
                   ("G", 2), ("g", 2), ("T", 3), ("t", 3)):
    _ENCODE_LUT[ord(_ch)] = _code


_DECODE_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def encode_bases(seq: str | bytes) -> np.ndarray:
    """Encode a DNA string to int8 codes (A=0 C=1 G=2 T=3, unknown->0)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _ENCODE_LUT[raw]


def decode_bases(codes: np.ndarray) -> str:
    """Decode int8 codes back to an uppercase ACGT string.

    Equivalent to `DnaString::to_string()` — the canonical read-key form used
    by the score map (`src/align.rs:576-579`).
    """
    return _DECODE_LUT[np.asarray(codes, dtype=np.int64)].tobytes().decode("ascii")


_REVCOMP_MAP = {
    "a": "t", "c": "g", "t": "a", "g": "c", "u": "a",
    "A": "T", "C": "G", "T": "A", "G": "C", "U": "A",
    "N": "N", "n": "N",
}


_VALID_BASES = set("AaCcGgTtUuNn")


# byte translation table for the fast path; 0 marks invalid characters
_REVCOMP_LUT = np.zeros(256, dtype=np.uint8)
for _bp, _c in _REVCOMP_MAP.items():
    _REVCOMP_LUT[ord(_bp)] = ord(_c)


def revcomp(sequence: str) -> str:
    """String-level reverse complement, parity with `src/utils.rs:61-94`.

    Case-preserving for ACGTU; N/n -> 'N'; raises on any other character
    (the reference panics: "Input sequence base is not DNA").
    """
    try:
        raw = np.frombuffer(sequence.encode("latin-1"), dtype=np.uint8)
    except UnicodeEncodeError:
        raw = np.zeros(1, dtype=np.uint8)  # non-latin char: certainly invalid
    out = _REVCOMP_LUT[raw[::-1]]
    if (out == 0).any():
        # find the first invalid character in the reference's scan order
        for bp in reversed(sequence):
            if bp not in _VALID_BASES:
                raise ValueError(f"Input sequence base is not DNA: {bp}")
    return out.tobytes().decode("latin-1")


def shannon_entropy_from_counts(n_a: int, n_t: int, n_c: int, n_g: int, total: int) -> float:
    """Entropy from precomputed base counts (device path helper).

    For 2-bit-coded reads every base is one of A/C/G/T, so
    ``total == n_a+n_t+n_c+n_g`` and this matches :func:`shannon_entropy` of the
    decoded string bit-for-bit (same f64 operation order: f*log2(f) summed in
    A,T,C,G order, negated).
    """
    if total == 0:
        return 0.0
    entropy = 0.0
    for c in (n_a, n_t, n_c, n_g):
        f = c / total
        if f > 0.0:
            entropy += f * math.log2(f)
    return -entropy



# --- frozen from nimble_tpu_torch/utils/natsort.py ------------------------

def natural_lexical_cmp(lhs: str, rhs: str) -> int:
    i = j = 0
    nl, nr = len(lhs), len(rhs)
    while i < nl and j < nr:
        a, b = lhs[i], rhs[j]
        if a.isdigit() and b.isdigit() and a.isascii() and b.isascii():
            # consume maximal digit runs
            i0, j0 = i, j
            while i < nl and lhs[i].isascii() and lhs[i].isdigit():
                i += 1
            while j < nr and rhs[j].isascii() and rhs[j].isdigit():
                j += 1
            va, vb = int(lhs[i0:i]), int(rhs[j0:j])
            if va != vb:
                return -1 if va < vb else 1
        else:
            la, lb = a.lower(), b.lower()
            if la != lb:
                return -1 if la < lb else 1
            i += 1
            j += 1
    if i < nl:
        return 1
    if j < nr:
        return -1
    # case-insensitive/numeric tie: deterministic case-sensitive tiebreak
    if lhs < rhs:
        return -1
    if lhs > rhs:
        return 1
    return 0


_KEY = functools.cmp_to_key(natural_lexical_cmp)


def natural_lexical_sort(items: Iterable[str]) -> List[str]:
    """Sort strings with :func:`natural_lexical_cmp` (parity: `src/align.rs:846`)."""
    return sorted(items, key=_KEY)



# --- frozen from nimble_tpu_torch/library.py ------------------------------

# `src/reference_library.rs:8`
SPECIAL_REVCOMP_FEATURE_NAME_SEPARATOR = "§"  # '§'


REV_SUFFIX = SPECIAL_REVCOMP_FEATURE_NAME_SEPARATOR + "rev"


@dataclass
class Reference:
    """Loaded (doubled) reference library table (`src/reference_library.rs:10-17`)."""

    group_on: int = 0                 # column index defining feature families
    headers: List[str] = field(default_factory=list)
    columns: List[List[str]] = field(default_factory=list)
    sequence_name_idx: int = 0
    sequence_idx: int = 0

    @property
    def names(self) -> List[str]:
        return self.columns[self.sequence_name_idx]

    @property
    def sequences(self) -> List[str]:
        return self.columns[self.sequence_idx]


def _get_column_index(headers: List[str], search: str) -> int | None:
    """First matching header index (`src/reference_library.rs:177-185`)."""
    for i, h in enumerate(headers):
        if h == search:
            return i
    return None


def _to_string_vec(value, array_name: str) -> List[str]:
    """Strict string-array conversion (`src/reference_library.rs:188-207`)."""
    if not isinstance(value, list):
        raise ValueError(f"Error -- could not parse {array_name} as array")
    out = []
    for item in value:
        if not isinstance(item, str):
            raise ValueError(
                f'Error -- could not parse {array_name} element "{item}" as a string'
            )
        out.append(item)
    return out


def _require_number(obj, key: str, kind: str):
    v = obj.get(key) if isinstance(obj, dict) else None
    if kind == "f64":
        # serde_json as_f64 accepts ints and floats
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            raise ValueError(f"Error -- could not parse {key} as f64")
        return float(v)
    if kind == "i64":
        if not isinstance(v, int) or isinstance(v, bool):
            raise ValueError(f"Error -- could not parse {key} as int64")
        return int(v)
    if kind == "bool":
        if not isinstance(v, bool):
            raise ValueError(f"Error -- could not parse {key} as boolean")
        return v
    if kind == "str":
        if not isinstance(v, str):
            raise ValueError(f"Error -- could not parse {key} as string")
        return v
    raise AssertionError(kind)


def load_reference_library(
    path: str, strand_filter: LibraryChemistry
) -> tuple[AlignFilterConfig, Reference]:
    """Load a nimble reference library JSON (`src/reference_library.rs:20-174`).

    Returns the aligner config and the doubled Reference table.
    """
    try:
        with open(path, "r", encoding="utf-8") as f:
            raw = f.read()
    except OSError as e:
        raise ValueError("Error -- could not read reference library") from e

    try:
        v = json.loads(raw)
    except json.JSONDecodeError as e:
        raise ValueError("Error -- could not parse reference library JSON") from e

    cfg_obj = v[0] if isinstance(v, list) and len(v) > 0 else {}
    ref_obj = v[1] if isinstance(v, list) and len(v) > 1 else {}

    score_percent = _require_number(cfg_obj, "score_percent", "f64")
    score_filter = _require_number(cfg_obj, "score_filter", "i64")
    score_threshold = _require_number(cfg_obj, "score_threshold", "i64")
    num_mismatches = _require_number(cfg_obj, "num_mismatches", "i64")
    discard_multiple_matches = _require_number(cfg_obj, "discard_multiple_matches", "bool")
    require_valid_pair = _require_number(cfg_obj, "require_valid_pair", "bool")
    discard_multi_hits = _require_number(cfg_obj, "discard_multi_hits", "i64")
    intersect_level_raw = _require_number(cfg_obj, "intersect_level", "i64")
    max_hits_to_report = _require_number(cfg_obj, "max_hits_to_report", "i64")
    group_on_name = _require_number(cfg_obj, "group_on", "str")
    trim_target_length = _require_number(cfg_obj, "trim_target_length", "i64")
    trim_strictness = _require_number(cfg_obj, "trim_strictness", "f64")

    if intersect_level_raw not in (0, 1, 2):
        raise ValueError(
            "Error -- invalid intersect level in config file. "
            "Please choose intersect level 0, 1, or 2."
        )
    intersect_level = IntersectLevel(intersect_level_raw)

    headers = _to_string_vec(ref_obj.get("headers") if isinstance(ref_obj, dict) else None,
                             "headers")
    sequence_name_idx = _get_column_index(headers, "sequence_name")
    if sequence_name_idx is None:
        raise ValueError("Could not find header sequence_name")

    if group_on_name == "":
        group_on = sequence_name_idx
    else:
        group_on = _get_column_index(headers, group_on_name)
        if group_on is None:
            raise ValueError(
                f"Error -- could not find column for group_on {group_on_name}"
            )

    sequence_idx = _get_column_index(headers, "sequence")
    if sequence_idx is None:
        raise ValueError("Error -- could not find sequences column")

    raw_columns = ref_obj.get("columns") if isinstance(ref_obj, dict) else None
    if not isinstance(raw_columns, list):
        raise ValueError("Error -- could not parse columns as array")
    columns = [_to_string_vec(col, "column") for col in raw_columns]

    align_config = AlignFilterConfig(
        reference_genome_size=len(columns[sequence_name_idx]),
        score_percent=score_percent,
        score_threshold=score_threshold,
        num_mismatches=num_mismatches,
        discard_nonzero_mismatch=False,  # hardcoded, `reference_library.rs:116`
        discard_multiple_matches=discard_multiple_matches,
        score_filter=score_filter,
        require_valid_pair=require_valid_pair,
        discard_multi_hits=discard_multi_hits,
        intersect_level=intersect_level,
        max_hits_to_report=max_hits_to_report,
        strand_filter=strand_filter,
        trim_target_length=trim_target_length,
        trim_strictness=trim_strictness,
    )

    # Double the library: forward row followed by its revcomp "§rev" twin
    # (`src/reference_library.rs:128-161`).
    num_rows = len(columns[0]) if columns else 0
    new_rows: List[List[str]] = []
    for row_idx in range(num_rows):
        row = []
        for col_idx, col in enumerate(columns):
            value = col[row_idx]
            if col_idx == sequence_idx:
                value = value.replace("U", "T").replace("u", "t")
            row.append(value)
        rc_row = list(row)
        rc_row[sequence_name_idx] = rc_row[sequence_name_idx] + REV_SUFFIX
        rc_row[sequence_idx] = revcomp(rc_row[sequence_idx])
        new_rows.append(row)
        new_rows.append(rc_row)

    final_columns: List[List[str]] = [[] for _ in columns]
    for row in new_rows:
        for i, val in enumerate(row):
            final_columns[i].append(val)

    reference = Reference(
        group_on=group_on,
        headers=headers,
        columns=final_columns,
        sequence_name_idx=sequence_name_idx,
        sequence_idx=sequence_idx,
    )

    align_config.sanity_check()
    return align_config, reference


def get_reference_sequence_data(reference: Reference) -> tuple[List[str], List[str]]:
    """(sequences, names) of the doubled library, for index construction.

    Parity with `src/utils.rs:7-24` (there DnaStrings; here raw strings —
    encoding happens in the index builder).
    """
    seqs = reference.columns[reference.sequence_idx]
    names = reference.columns[reference.sequence_name_idx]
    if len(names) < len(seqs):
        raise ValueError(
            "Error -- could not read library name after JSON parse, "
            "corrupted internal state."
        )
    return list(seqs), list(names[: len(seqs)])



# --- frozen from nimble_tpu_torch/core/features.py ------------------------

def process_equivalence_class_to_feature_list(
    equivalence_class: Sequence[int],
    reference: Reference,
    config: AlignFilterConfig,
    ignore_group_rollup: bool,
) -> List[str]:
    """Map row ids to feature names, optionally rolled up by the group_on
    column (`src/align.rs:802-849`).

    * group_on == sequence_name column (header "nt_sequence" check in the
      reference compares the group_on HEADER string): 1:1 name mapping, NO
      dedup — duplicate ids yield duplicate names;
    * otherwise: group_on column values, empty value falls back to the
      feature name, deduped preserving first-occurrence order;
    * if discard_multi_hits > 0 and the list is larger: returns [] (the whole
      alignment is dropped);
    * result is natural-lexically sorted for determinism.
    """
    if ignore_group_rollup or reference.headers[reference.group_on] == "nt_sequence":
        results = [
            reference.columns[reference.sequence_name_idx][idx]
            for idx in equivalence_class
        ]
    else:
        results = []
        for idx in equivalence_class:
            group = reference.columns[reference.group_on][idx]
            if group == "":
                group = reference.columns[reference.sequence_name_idx][idx]
            if group not in results:
                results.append(group)

    if (
        not ignore_group_rollup
        and config.discard_multi_hits > 0
        and len(results) > config.discard_multi_hits
    ):
        return []
    return natural_lexical_sort(results)


def unmap(feature_list: Sequence[str], reference: Reference) -> List[int]:
    """Feature names back to row ids (first occurrence), `src/align.rs:851-864`."""
    names = reference.columns[reference.sequence_name_idx]
    out = []
    for feature in feature_list:
        try:
            out.append(names.index(feature))
        except ValueError:
            raise ValueError("Feature not found in reference columns") from None
    return out



# --- frozen from nimble_tpu_torch/core/orientation.py ---------------------

# results accumulator value: [count, sequence_metadata, mate_sequence_metadata]
ResultsMap = Dict[Tuple[str, ...], list]


# read_key -> (reason, orientation)
TriageMap = Dict[str, Tuple[FilterReason, AlignmentOrientation]]


# (pair_state, Option[(eq_class, norm_score)], Option[(eq_class, norm_score)],
#  sequence_metadata, mate_sequence_metadata) — score_map value, src/align.rs:496-505
SequenceCall = Tuple[
    PairState,
    Optional[Tuple[List[int], float]],
    Optional[Tuple[List[int], float]],
    List[str],
    List[str],
]


def filter_read_calls_with_orientation(calls: List[str]) -> List[str]:
    """Remove features one mate hit in both orientations (`src/align.rs:144-171`).

    Any base name occurring more than once (any orientation combination) has
    ALL of its entries removed.
    """
    seen: set = set()
    to_remove: set = set()
    for feature in calls:
        base = feature[: -len(REV_SUFFIX)] if feature.endswith(REV_SUFFIX) else feature
        if base in seen:
            to_remove.add(base)
        else:
            seen.add(base)
    return [
        c
        for c in calls
        if (c[: -len(REV_SUFFIX)] if c.endswith(REV_SUFFIX) else c) not in to_remove
    ]


def parse_calls(calls: List[str]) -> List[Tuple[str, bool]]:
    """Split names into (base_feature, is_rev) (`src/align.rs:276-285`).

    Reproduces the reference quirks: the check is ``ends_with("rev")`` (no
    separator required), and stripping removes ALL trailing "rev" repetitions
    then ALL trailing separators.
    """
    out = []
    for call in calls:
        if call.endswith("rev"):
            base = call
            while base.endswith("rev"):
                base = base[: -3]
            while base.endswith("§"):
                base = base[: -1]
            out.append((base, True))
        else:
            out.append((call, False))
    return out


def filter_unstranded(
    sequence_calls: List[Tuple[str, bool]],
    mate_sequence_calls: List[Tuple[str, bool]],
) -> Tuple[List[Tuple[str, bool]], List[Tuple[str, bool]]]:
    """Drop (feature, orientation) pairs present in BOTH mates (`src/align.rs:287-309`)."""
    seq_set = set(sequence_calls)
    mate_set = set(mate_sequence_calls)
    seq_filtered = [c for c in sequence_calls if c not in mate_set]
    mate_filtered = [c for c in mate_sequence_calls if c not in seq_set]
    return seq_filtered, mate_filtered


def filter_five_prime(
    sequence_calls: List[Tuple[str, bool]],
    mate_sequence_calls: List[Tuple[str, bool]],
) -> Tuple[List[str], List[str]]:
    """5' chemistry orientation filter (`src/align.rs:311-342`)."""
    seq_u, mate_u = filter_unstranded(sequence_calls, mate_sequence_calls)
    seq_filtered: List[Tuple[str, bool]] = []
    mate_filtered = list(mate_u)
    for feat, rev in seq_u:
        if rev:
            # remove the first mate call with the same feature name (any orientation)
            for pos, (mate_feat, _) in enumerate(mate_filtered):
                if mate_feat == feat:
                    del mate_filtered[pos]
                    break
        else:
            seq_filtered.append((feat, rev))
    # forward-orientation mate calls survive only with a same-named sequence call
    mate_filtered = [
        (mf, mrev)
        for (mf, mrev) in mate_filtered
        if mrev or any(sf == mf for sf, _ in seq_filtered)
    ]
    return [f for f, _ in seq_filtered], [f for f, _ in mate_filtered]


def filter_three_prime(
    sequence_calls: List[Tuple[str, bool]],
    mate_sequence_calls: List[Tuple[str, bool]],
) -> Tuple[List[str], List[str]]:
    """3' chemistry orientation filter (`src/align.rs:344-375`)."""
    seq_u, mate_u = filter_unstranded(sequence_calls, mate_sequence_calls)
    seq_filtered: List[Tuple[str, bool]] = []
    mate_filtered = list(mate_u)
    for feat, rev in seq_u:
        if not rev:
            for pos, (mate_feat, _) in enumerate(mate_filtered):
                if mate_feat == feat:
                    del mate_filtered[pos]
                    break
        else:
            seq_filtered.append((feat, rev))
    # reverse-orientation mate calls survive only with a same-named sequence call
    mate_filtered = [
        (mf, mrev)
        for (mf, mrev) in mate_filtered
        if (not mrev) or any(sf == mf for sf, _ in seq_filtered)
    ]
    return [f for f, _ in seq_filtered], [f for f, _ in mate_filtered]


def filter_orientation_on_library_chemistry(
    sequence_calls: List[str],
    mate_sequence_calls: List[str],
    lib_type: LibraryChemistry,
) -> Tuple[List[str], List[str]]:
    """Dispatch by chemistry; returns rev-stripped names (`src/align.rs:255-274`)."""
    parsed_seq = parse_calls(sequence_calls)
    parsed_mate = parse_calls(mate_sequence_calls)
    if lib_type == LibraryChemistry.NONE:
        return [f for f, _ in parsed_seq], [f for f, _ in parsed_mate]
    if lib_type == LibraryChemistry.UNSTRANDED:
        calls, mate_calls = filter_unstranded(parsed_seq, parsed_mate)
        return [f for f, _ in calls], [f for f, _ in mate_calls]
    if lib_type == LibraryChemistry.FIVE_PRIME:
        return filter_five_prime(parsed_seq, parsed_mate)
    if lib_type == LibraryChemistry.THREE_PRIME:
        return filter_three_prime(parsed_seq, parsed_mate)
    raise AssertionError(lib_type)


def get_all_calls(sequence_call: List[str], mate_sequence_call: List[str]) -> List[str]:
    """Union merge (`src/align.rs:788-796`).

    NB: the reference calls array_tool's non-mutating ``unique()`` and discards
    the result (`src/align.rs:794`), so duplicates between the mates are KEPT.
    Reproduced for output parity.
    """
    return list(sequence_call) + list(mate_sequence_call)


def get_intersecting_reads(
    sequence_call: List[str],
    mate_sequence_call: List[str],
    fallback_on_intersect_fail: bool,
    read_key: str,
    filtered_keys: TriageMap,
) -> List[str]:
    """Intersect merge with optional fallback (`src/align.rs:763-785`).

    array_tool's ``intersect`` keeps elements of self present in other, deduped,
    in self order.
    """
    other = set(mate_sequence_call)
    cls: List[str] = []
    for x in sequence_call:
        if x in other and x not in cls:
            cls.append(x)
    if len(cls) == 0 and fallback_on_intersect_fail:
        return get_all_calls(sequence_call, mate_sequence_call)
    if len(cls) != 0:
        return cls
    filtered_keys[read_key] = (
        FilterReason.FORCE_INTERSECT_FAILURE,
        AlignmentOrientation.NONE,
    )
    return []


def filter_and_coerce_sequence_call_orientations(
    call: SequenceCall,
    results: ResultsMap,
    reference_metadata: Reference,
    config: AlignFilterConfig,
    read_key: str,
    filtered_keys: TriageMap,
) -> None:
    """Orientation pipeline for one read-pair's calls (`src/align.rs:178-252`)."""
    _, sequence_call_option, mate_sequence_call_option, seq_meta, mate_meta = call

    sequence_features: List[str] = []
    if sequence_call_option is not None:
        sequence_features = process_equivalence_class_to_feature_list(
            sequence_call_option[0], reference_metadata, config, True
        )
    mate_sequence_features: List[str] = []
    if mate_sequence_call_option is not None:
        mate_sequence_features = process_equivalence_class_to_feature_list(
            mate_sequence_call_option[0], reference_metadata, config, True
        )

    sequence_features = filter_read_calls_with_orientation(sequence_features)
    mate_sequence_features = filter_read_calls_with_orientation(mate_sequence_features)

    sequence_features, mate_sequence_features = filter_orientation_on_library_chemistry(
        sequence_features, mate_sequence_features, config.strand_filter
    )

    if config.intersect_level == IntersectLevel.NO_INTERSECT:
        final_callset = get_all_calls(sequence_features, mate_sequence_features)
    elif config.intersect_level == IntersectLevel.INTERSECT_WITH_FALLBACK:
        final_callset = get_intersecting_reads(
            sequence_features, mate_sequence_features, True, read_key, filtered_keys
        )
    else:  # FORCE_INTERSECT
        final_callset = get_intersecting_reads(
            sequence_features, mate_sequence_features, False, read_key, filtered_keys
        )

    final_ids = unmap(final_callset, reference_metadata)
    feature_callset = process_equivalence_class_to_feature_list(
        final_ids, reference_metadata, config, False
    )

    # max-hits cap runs AFTER rollup (`src/align.rs:232-236`)
    if len(feature_callset) > config.max_hits_to_report:
        filtered_keys[read_key] = (
            FilterReason.MAX_HITS_EXCEEDED,
            AlignmentOrientation.NONE,
        )
        return

    if len(feature_callset) == 0:
        filtered_keys[read_key] = (
            FilterReason.TRIAGE_EMPTY_EQUIVALENCE_CLASS,
            AlignmentOrientation.NONE,
        )
        return

    entry = results.setdefault(tuple(feature_callset), [0, [], []])
    entry[0] += 1
    entry[1] = seq_meta
    entry[2] = mate_meta



# --- frozen from nimble_tpu_torch/core/filters.py -------------------------

# (eq_class, normalized_score, score) — `AlignmentScore`, src/align.rs:22
AlignmentScore = Tuple[List[int], float, int]


# (reason, normalized_score, score) — `Filter`, src/align.rs:23
FilterRec = Tuple[FilterReason, float, int]


def filter_alignment_by_metrics(
    equivalence_class: List[int],
    score: int,
    normalized_score: float,
    score_threshold: int,
    normalized_score_threshold: float,
    discard_multiple_matches: bool,
    mismatch_threshold: int,
    mismatches: int,
) -> Tuple[Optional[AlignmentScore], Optional[FilterRec]]:
    """Threshold/ambiguity/mismatch filtering (`src/filter/align.rs:4-45`)."""
    if (
        score >= score_threshold
        and normalized_score >= normalized_score_threshold
        and len(equivalence_class) > 0
    ):
        if discard_multiple_matches and len(equivalence_class) > 1:
            return None, (FilterReason.DISCARDED_MULTIPLE_MATCH, normalized_score, score)
        if mismatches > mismatch_threshold:
            return None, (FilterReason.ABOVE_MISMATCH_THRESHOLD, normalized_score, score)
        return (equivalence_class, normalized_score, score), None
    return None, (FilterReason.SCORE_BELOW_THRESHOLD, normalized_score, score)



# --- frozen from nimble_tpu_torch/core/trim.py ----------------------------

LONGEST_READ = 1000  # `src/align.rs:874`


MAXQUAL = 60         # `src/align.rs:875`


_I64_MAX = (1 << 63) - 1


_I64_MIN = -(1 << 63)


def _rust_f64_as_i64(x: float) -> int:
    """Rust `as` cast f64 -> i64: truncate toward zero, saturate, NaN -> 0."""
    if math.isnan(x):
        return 0
    if x >= float(_I64_MAX):
        return _I64_MAX
    if x <= float(_I64_MIN):
        return _I64_MIN
    return int(x)  # Python int() truncates toward zero like Rust `as`


def _compute_norm_ratio(array: np.ndarray, margin: int) -> float:
    """`src/align.rs:927-938`: i64::MAX / (max_abs * margin)."""
    max_val = float(np.max(np.abs(array)))
    # IEEE f64 semantics like Rust: x/0.0 == inf (strictness extremes hit this)
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.float64(_I64_MAX) / np.float64(max_val * float(margin)))


@lru_cache(maxsize=32)
def _tables(target_length: int, strictness: float) -> Tuple[np.ndarray, np.ndarray]:
    """Precompute normalized i64 length-score and quality-probability tables.

    length_scores[i] = ln(1/(1+e^(target-i-1))) + ln(i+1)*(1-strictness)
    qual_probs[q]    = ln(1 - 10^(-(0.5+q)/10)) * strictness
    both scaled by a shared fixed-point ratio (`src/align.rs:877-897,893-897`).
    """
    i = np.arange(LONGEST_READ, dtype=np.float64)
    with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
        pow1 = np.exp(float(target_length) - i - 1.0)
        unique = np.log(1.0 / (1.0 + pow1))
        coverage = np.log(i + 1.0) * (1.0 - strictness)
        length_scores = unique + coverage

        q = np.arange(MAXQUAL + 1, dtype=np.float64)
        prob_correct = 1.0 - np.power(10.0, -((0.5 + q) / 10.0))
        qual_probs = np.log(prob_correct) * strictness

    norm_ratio = max(
        _compute_norm_ratio(length_scores, LONGEST_READ * 2),
        _compute_norm_ratio(qual_probs, LONGEST_READ * 2),
    )

    with np.errstate(over="ignore", invalid="ignore"):
        ls_i64 = np.array(
            [_rust_f64_as_i64(v * norm_ratio) for v in length_scores], dtype=np.int64
        )
        qp_i64 = np.array(
            [_rust_f64_as_i64(v * norm_ratio) for v in qual_probs], dtype=np.int64
        )
    return ls_i64, qp_i64


def maxinfo(quality: bytes | str, target_length: int, strictness: float) -> int:
    """Optimal prefix length for a quality string (`src/align.rs:873-925`).

    ``quality`` holds raw quality VALUES as bytes/chars (clamped to MAXQUAL).
    Returns 0 when no positive-scoring prefix exists.
    """
    if isinstance(quality, str):
        qvals = np.frombuffer(quality.encode("latin-1"), dtype=np.uint8)
    else:
        qvals = np.frombuffer(bytes(quality), dtype=np.uint8)
    n = len(qvals)
    if n == 0:
        return 0

    length_scores, qual_probs = _tables(int(target_length), float(strictness))

    q = np.minimum(qvals.astype(np.int64), MAXQUAL)
    accum = np.cumsum(qual_probs[q])  # i64 accumulation (wrapping like Rust +=)
    ls = np.zeros(n, dtype=np.int64)
    m = min(n, LONGEST_READ)
    ls[:m] = length_scores[:m]
    scores = ls + accum

    # argmax with `>=` (ties -> LAST max), compared in f64 against f64::MIN
    # then stored back as f64 (`src/align.rs:899-916`).
    scores_f64 = scores.astype(np.float64)
    max_score = float(scores_f64.max())
    # running ">=" keeps the LAST occurrence of the global max
    max_score_position = int(np.flatnonzero(scores_f64 == max_score).max()) + 1

    if max_score_position < 1 or max_score == 0.0:
        return 0
    if max_score_position < n:
        return max_score_position
    return n


def maxinfo_batch(
    quals: "list[str | bytes]", target_length: int, strictness: float
) -> np.ndarray:
    """Vectorized :func:`maxinfo` over many quality strings.

    Identical i64 fixed-point math per read (same tables, same accumulate/
    argmax semantics), batched across a padded matrix for throughput on the
    BAM path where every read is quality-trimmed.
    """
    # (the copy takes lists only: the columnar input and its native
    # branch are left out)
    n = len(quals)
    lens = np.fromiter((len(q) for q in quals), dtype=np.int64, count=n)
    flat = None
    out = np.zeros(n, dtype=np.int64)
    if n == 0:
        return out
    width = int(lens.max()) if n else 0
    if width == 0:
        return out

    length_scores, qual_probs = _tables(int(target_length), float(strictness))

    # vectorized padded fill from the concatenated quality bytes
    if flat is None:
        if quals and isinstance(quals[0], str):
            flat = np.frombuffer(
                "".join(quals).encode("latin-1"), dtype=np.uint8
            )
        else:
            flat = np.frombuffer(
                b"".join(bytes(q) for q in quals), dtype=np.uint8
            )
    qmat = np.zeros((n, width), dtype=np.uint8)
    qmat[np.arange(width)[None, :] < lens[:, None]] = flat

    q = np.minimum(qmat.astype(np.int64), MAXQUAL)
    accum = np.cumsum(qual_probs[q], axis=1)
    ls = np.zeros(width, dtype=np.int64)
    m = min(width, LONGEST_READ)
    ls[:m] = length_scores[:m]
    scores = (ls[None, :] + accum).astype(np.float64)

    # mask beyond each read's length, then last-argmax with ">=" semantics
    pos = np.arange(width)[None, :]
    valid = pos < lens[:, None]
    scores = np.where(valid, scores, -np.inf)
    gmax = scores.max(axis=1)
    # last occurrence of the max (running ">=" keeps the last)
    is_max = (scores == gmax[:, None]) & valid
    last_pos = width - 1 - np.argmax(is_max[:, ::-1], axis=1)
    max_score_position = last_pos + 1

    result = np.where(
        (max_score_position < 1) | (gmax == 0.0),
        0,
        np.minimum(max_score_position, lens),
    )
    return result.astype(np.int64)



# --- frozen from nimble_tpu_torch/core/calls.py ---------------------------

# filter_reasons value: ((reason, score), (mate_reason, mate_score))
FilterReasons = Dict[str, Tuple[Tuple[FilterReason, int], Tuple[FilterReason, int]]]


# final merged forensic record (get_calls 3rd return, `src/align.rs:408`)
FinalFilterReasons = Dict[
    str,
    Tuple[
        Tuple[FilterReason, int],
        Tuple[FilterReason, int],
        Tuple[FilterReason, int],
        Tuple[FilterReason, int],
        FilterReason,
        AlignmentOrientation,
    ],
]


# read_matches entry: (feature_list, read_str, norm_score, score, read_key)
ReadMatch = Tuple[List[str], str, float, int, str]


class AlignEngine(Protocol):
    """Batched alignment interface: trimmed coded reads -> per-read results.

    Entries may be None (skipped reads); their result must be (None, None).
    Each result mirrors `pseudoalign`'s (AlignmentScore?, Filter?) pair.
    """

    def align_batch(
        self, seqs: Sequence[Optional[np.ndarray]]
    ) -> List[Tuple[Optional[AlignmentScore], Optional[FilterRec]]]: ...


def prepare_trimmed(
    reads: Sequence[np.ndarray],
    mate_reads: Optional[Sequence[np.ndarray]],
    metadata: Sequence[List[str]],
    config: AlignFilterConfig,
) -> Tuple[List[Optional[np.ndarray]], List[Optional[np.ndarray]]]:
    """Stage 1 of score_sequences: quality trim + dummy-skip flags
    (`src/align.rs:514-558`).  Skipped (dummy) reads become None entries.

    Factored out so batching callers (e.g. the BAM consumer) can pre-align
    many groups' reads in one engine call with identical inputs.
    """

    def meta_at(i: int) -> List[str]:
        return metadata[i] if i < len(metadata) else []

    # batch the MAXINFO trims (one vectorized pass instead of per-read)
    quals: List[str] = []
    qual_slots: List[Tuple[int, int]] = []  # (read index, mate side)
    for i in range(len(reads)):
        if meta_at(2 * i):
            quals.append(meta_at(2 * i)[1])
            qual_slots.append((i, 0))
        if mate_reads is not None and meta_at(2 * i + 1):
            quals.append(meta_at(2 * i + 1)[1])
            qual_slots.append((i, 1))
    trim_lens: dict = {}
    if quals:
        lengths = maxinfo_batch(
            quals, config.trim_target_length, config.trim_strictness
        )
        for (slot, L) in zip(qual_slots, lengths):
            trim_lens[slot] = int(L)

    trimmed_r1: List[Optional[np.ndarray]] = []
    trimmed_r2: List[Optional[np.ndarray]] = []
    for i in range(len(reads)):
        m1, m2 = meta_at(2 * i), meta_at(2 * i + 1)
        r1 = reads[i]
        t1 = r1[: trim_lens[(i, 0)]] if m1 else r1
        trimmed_r1.append(None if (m1 and m1[37] == "TRUE") else t1)
        if mate_reads is not None:
            r2 = mate_reads[i]
            t2 = r2[: trim_lens[(i, 1)]] if m2 else r2
            trimmed_r2.append(None if (m2 and m2[37] == "TRUE") else t2)
    return trimmed_r1, trimmed_r2


class PrecomputedEngine:
    """Serves pre-aligned results in align_batch call order.

    Used by batching callers that aligned several groups' reads in one bulk
    engine call: per group, score_sequences issues exactly one align_batch
    for R1 and (for paired data) one for R2 — this engine replays the
    precomputed slices in that order.
    """

    def __init__(self, *result_slices):
        self._slices = list(result_slices)

    def align_batch(self, seqs):
        results = self._slices.pop(0)
        assert len(results) == len(seqs)
        return results


def filter_pair(
    sequence_equivalence_class: List[int],
    mate_sequence_equivalence_class: List[int],
) -> bool:
    """True => the pair is invalid (eq classes differ), `src/align.rs:732-760`."""
    if sequence_equivalence_class and mate_sequence_equivalence_class:
        return sorted(sequence_equivalence_class) != sorted(
            mate_sequence_equivalence_class
        )
    return True


def score_sequences(
    reads: Sequence[np.ndarray],
    mate_reads: Optional[Sequence[np.ndarray]],
    sequence_metadata: Sequence[List[str]],
    engine: AlignEngine,
    reference: Reference,
    config: AlignFilterConfig,
    filter_reasons: FilterReasons,
) -> Tuple[Dict[str, SequenceCall], List[ReadMatch]]:
    """Score all reads/pairs and build the score map (`src/align.rs:475-729`).

    ``reads`` / ``mate_reads`` are coded, already orientation-corrected
    sequences; ``sequence_metadata`` holds two rows per read pair (BAM path)
    or is empty (FASTQ path).  Metadata row layout follows
    `BAM_FIELDS_TO_REPORT` (`src/parse/bam.rs:9-49`): [1]=QUAL, [37]=SKIP_ALIGN.
    """
    if mate_reads is not None and len(mate_reads) < len(reads):
        raise ValueError(
            "Error -- read and reverse read files do not have matching lengths: "
        )

    n = len(reads)
    meta = list(sequence_metadata)

    def meta_at(i: int) -> List[str]:
        return meta[i] if i < len(meta) else []

    trimmed_r1, trimmed_r2 = prepare_trimmed(reads, mate_reads, meta, config)
    results_r1 = engine.align_batch(trimmed_r1)
    results_r2 = engine.align_batch(trimmed_r2) if mate_reads is not None else None

    score_map: Dict[str, SequenceCall] = {}
    read_matches: List[ReadMatch] = []

    # Stage 2: per-pair packaging (`src/align.rs:560-726`).
    for i in range(n):
        m1, m2 = meta_at(2 * i), meta_at(2 * i + 1)
        skip1 = bool(m1) and m1[37] == "TRUE"
        seq_alignment, seq_filter = results_r1[i]
        if skip1:
            seq_filter = (FilterReason.SKIPPED_ALIGN_DUE_TO_UNPAIRED_DUMMY, 0.0, 0)

        mate_alignment: Optional[AlignmentScore] = None
        mate_filter: Optional[FilterRec] = None
        read_rev: Optional[np.ndarray] = None
        if mate_reads is not None:
            read_rev = mate_reads[i]
            skip2 = bool(m2) and m2[37] == "TRUE"
            mate_alignment, mate_filter = results_r2[i]
            if skip2:
                mate_filter = (FilterReason.SKIPPED_ALIGN_DUE_TO_UNPAIRED_DUMMY, 0.0, 0)

        if seq_alignment is not None:
            seq_eq, seq_norm, seq_score = seq_alignment
        else:
            seq_eq, seq_norm, seq_score = [], 0.0, 0
        if mate_alignment is not None:
            mate_eq, mate_norm, mate_score = mate_alignment
        else:
            mate_eq, mate_norm, mate_score = [], 0.0, 0

        read_str = decode_bases(reads[i])
        read_key = read_str + decode_bases(read_rev) if read_rev is not None else read_str

        if (
            mate_reads is not None
            and config.require_valid_pair
            and filter_pair(seq_eq, mate_eq)
        ):
            filter_reasons[read_key] = (
                (FilterReason.NOT_MATCHING_PAIR, seq_score),
                (FilterReason.NOT_MATCHING_PAIR, mate_score),
            )
            continue

        filter_reasons[read_key] = (
            (seq_filter[0] if seq_filter is not None else FilterReason.SUCCESSFUL_MATCH,
             seq_score),
            (mate_filter[0] if mate_filter is not None else FilterReason.SUCCESSFUL_MATCH,
             mate_score),
        )

        if seq_eq or mate_eq:
            if seq_eq:
                feature_list = process_equivalence_class_to_feature_list(
                    seq_eq, reference, config, False
                )
            elif mate_eq:
                feature_list = process_equivalence_class_to_feature_list(
                    mate_eq, reference, config, False
                )
            else:
                feature_list = []

            if seq_eq and mate_eq:
                pair_score: SequenceCall = (
                    PairState.BOTH,
                    (seq_eq, seq_norm),
                    (mate_eq, mate_norm),
                    m1,
                    m2,
                )
                rm_norm, rm_score = seq_norm, seq_score
            elif seq_eq:
                pair_score = (PairState.FIRST, (seq_eq, seq_norm), None, m1, m2)
                rm_norm, rm_score = seq_norm, seq_score
            else:
                pair_score = (PairState.SECOND, None, (mate_eq, mate_norm), m1, m2)
                rm_norm, rm_score = mate_norm, mate_score

            if pair_score[0] in (PairState.FIRST, PairState.BOTH):
                read_matches.append(
                    (list(feature_list), read_str, rm_norm, rm_score, read_key)
                )
            elif pair_score[0] == PairState.SECOND and read_rev is not None:
                read_matches.append(
                    (list(feature_list), decode_bases(read_rev), rm_norm, rm_score, read_key)
                )

            score_map[read_key] = pair_score
        else:
            # Both empty: report the failed alignment (`src/align.rs:687-725`).
            if mate_reads is not None:
                if seq_filter is not None and mate_filter is not None:
                    _, s, ns = seq_filter
                    _, r, nr = mate_filter
                    # all arms reduce to picking the larger normalized score
                    # (`src/align.rs:690-705`)
                    if seq_filter[0] == mate_filter[0]:
                        failed_score, failed_raw = s, ns
                    else:
                        failed_score, failed_raw = (s, ns) if s > r else (r, nr)
                elif mate_filter is not None:
                    failed_score, failed_raw = mate_filter[1], mate_filter[2]
                elif seq_filter is not None:
                    failed_score, failed_raw = seq_filter[1], seq_filter[2]
                else:
                    failed_score, failed_raw = 0.0, 0
            else:
                if seq_filter is not None:
                    failed_score, failed_raw = seq_filter[1], seq_filter[2]
                else:
                    failed_score, failed_raw = 0.0, 0

            read_matches.append(([], read_str, failed_score, failed_raw, ""))

    return score_map, read_matches


def get_calls(
    reads: Sequence[np.ndarray],
    mate_reads: Optional[Sequence[np.ndarray]],
    sequence_metadata: Sequence[List[str]],
    engine: AlignEngine,
    reference: Reference,
    config: AlignFilterConfig,
) -> Tuple[
    List[Tuple[List[str], Tuple[int, List[str], List[str]]]],
    List[ReadMatch],
    FinalFilterReasons,
]:
    """Full call pipeline for a batch of reads (`src/align.rs:392-467`)."""
    filter_reasons: FilterReasons = {}
    post_triaged_keys: TriageMap = {}

    score_map, read_matches = score_sequences(
        reads, mate_reads, sequence_metadata, engine, reference, config, filter_reasons
    )

    results: ResultsMap = {}
    for read_pair_key, call in score_map.items():
        filter_and_coerce_sequence_call_orientations(
            call, results, reference, config, read_pair_key, post_triaged_keys
        )

    final_filter_reasons: FinalFilterReasons = {}
    none_rec = (FilterReason.NONE, 0)
    for key, value in filter_reasons.items():
        triage = post_triaged_keys.get(key)
        if triage is not None:
            final_filter_reasons[key] = (
                value[0], value[1], none_rec, none_rec, triage[0], triage[1]
            )
        else:
            final_filter_reasons[key] = (
                value[0], value[1], none_rec, none_rec,
                FilterReason.NONE, AlignmentOrientation.NONE,
            )

    ret = [
        (list(callset), (entry[0], entry[1], entry[2]))
        for callset, entry in results.items()
    ]
    return ret, read_matches, final_filter_reasons


def sort_score_vector(scores):
    """Sort results by feature-callset (`src/utils.rs:54-59`): Vec<String> order
    == Python list-of-str lexicographic order."""
    return sorted(scores, key=lambda x: x[0])


def call(
    reads: Sequence[np.ndarray],
    mate_reads: Optional[Sequence[np.ndarray]],
    per_sequence_metadata: Sequence[List[str]],
    engine: AlignEngine,
    reference: Reference,
    config: AlignFilterConfig,
):
    """Scoring facade (`src/score.rs:14-46`): get_calls + name-sort."""
    reference_scores, alignment_metadata, filter_reasons = get_calls(
        reads, mate_reads, per_sequence_metadata, engine, reference, config
    )
    return sort_score_vector(reference_scores), alignment_metadata, filter_reasons



# --- frozen from nimble_tpu_torch/io/umi.py -------------------------------

CLIP_LENGTH = 13


# `src/parse/bam.rs:9-49`; indices matter: 0=QNAME, 1=QUAL, 2=REVERSE,
# 15=SEQ, 37=SKIP_ALIGN.
BAM_FIELDS_TO_REPORT = [
    "QNAME", "QUAL", "REVERSE", "MATE_REVERSE", "PAIRED", "PROPER_PAIRED",
    "PAIR_ORIENTATION", "UNMAPPED", "MATE_UNMAPPED", "FIRST_IN_TEMPLATE",
    "LAST_IN_TEMPLATE", "STRAND", "MAPQ", "POS", "MATE_POS", "SEQ", "SEQ_LEN",
    "INSERT_SIZE", "QUALITY_FAILED", "SECONDARY", "DUPLICATE", "SUPPLEMENTARY",
    "NH", "HI", "AS", "GN", "TX", "AN", "nM", "fx", "RE", "CR", "CY", "CB",
    "UR", "UY", "UB", "SKIP_ALIGN",
]


def _rust_bool(b: bool) -> str:
    return "true" if b else "false"


def strip_nonbio_regions(seq: str, rev_comp: bool) -> str:
    """Clip 13 bases of 10x non-biological sequence from 124bp reads
    (`src/parse/bam.rs:258-268`)."""
    if len(seq) == 124:
        if rev_comp:
            return seq[: len(seq) - CLIP_LENGTH]
        return seq[CLIP_LENGTH:]
    return seq


def strip_nonbio_regions_qual(qual: str, rev_comp: bool) -> str:
    """Same for quality strings; reversed for reverse reads
    (`src/parse/bam.rs:271-287`)."""
    if len(qual) == 124:
        trimmed = qual[: len(qual) - CLIP_LENGTH] if rev_comp else qual[CLIP_LENGTH:]
    else:
        trimmed = qual
    return trimmed[::-1] if rev_comp else trimmed



# --- frozen from nimble_tpu_torch/pipeline/bam_pipeline.py ----------------

_NONE_REC = (FilterReason.NONE, 0)


def bam_data_values(bam_data: List[str]) -> str:
    """Metadata row minus QUAL (1) and SEQ (15), tab-joined (`:22-31`)."""
    return "\t".join(
        v for i, v in enumerate(bam_data) if i != 1 and i != 15
    )


def bam_data_header(prefix: str) -> str:
    """Header for a metadata block (`:33-42`)."""
    return "\t".join(
        f"{prefix}_{f}"
        for i, f in enumerate(BAM_FIELDS_TO_REPORT)
        if i != 1 and i != 15
    )


FILTER_HEADER = (
    "r1_filter_forward\tr1_forward_score\tr1_filter_reverse\tr1_reverse_score\t"
    "r2_filter_forward\tr2_forward_score\tr2_filter_reverse\tr2_reverse_score\t"
    "triage_reason\taligndirection"
)


def parse_str_as_bool(v: str) -> bool:
    """`src/process/bam.rs:417-423`."""
    if v == "true":
        return True
    if v == "false":
        return False
    raise ValueError(f'Could not parse revcomp field "{v}" as boolean')


def reverse_comp_if_needed(seq: str, rev: bool) -> str:
    """`src/process/bam.rs:407-415`."""
    return revcomp(seq) if rev else seq


def align_umi_to_libraries(
    umi_seqs: List[str],
    umi_metadata: List[List[str]],
    engines: Sequence[AlignEngine],
    references: Sequence[Reference],
    aligner_configs: Sequence[AlignFilterConfig],
):
    """Score one UMI group against every library (`src/process/bam.rs:305-405`).

    Returns, per library, a list of
    (features, (count, r1_meta, r2_meta, v0, v1, v2, v3, triage, orientation)).
    """
    results = []
    reverse_flags = [parse_str_as_bool(m[2]) for m in umi_metadata]
    oriented = [
        encode_bases(reverse_comp_if_needed(s, r))
        for s, r in zip(umi_seqs, reverse_flags)
    ]
    r1_reads = oriented[0::2]
    r2_reads = oriented[1::2]

    for i, engine in enumerate(engines):
        s, _, filter_reasons = call(
            r1_reads, r2_reads, umi_metadata, engine, references[i],
            aligner_configs[i],
        )

        if len(s) == 0:
            results.append([])
            continue

        # qname of each distinct callset's LAST-written pair (`:335-338`)
        scored_qnames = [entry[1][0] for _, entry in s]

        non_matching = []
        for j in range(0, len(umi_metadata), 2):
            if j + 1 < len(umi_metadata):
                pair = (umi_metadata[j], umi_metadata[j + 1])
                qname = pair[1][0]
                if qname in scored_qnames:
                    continue
                non_matching.append(([], (0, pair[0], pair[1])))
        s = list(s) + non_matching

        transformed = []
        for features, entry in s:
            count, m1, m2 = entry[0], entry[1], entry[2]
            r1_key = reverse_comp_if_needed(m1[15], parse_str_as_bool(m1[2]))
            r2_key = reverse_comp_if_needed(m2[15], parse_str_as_bool(m2[2]))
            v = filter_reasons.get(r1_key + r2_key)
            if v is not None:
                rec = (count, m1, m2, v[0], v[1], v[2], v[3], v[4], v[5])
            else:
                rec = (
                    count, m1, m2,
                    _NONE_REC, _NONE_REC, _NONE_REC, _NONE_REC,
                    FilterReason.NONE, AlignmentOrientation.NONE,
                )
            transformed.append((features, rec))
        results.append(transformed)

    return results


def format_log_row(features: List[str], rec) -> str:
    """One forensic TSV row, incl. the r1/r2 swap quirk (`:103-120`)."""
    count, m1, m2, v0, v1, v2, v3, triage, orientation = rec
    return "\t".join(
        [
            ",".join(features),
            str(count),
            bam_data_values(m2),   # "r1 bam data" block <- mate metadata (quirk)
            bam_data_values(m1),   # "r2 bam data" block <- r1 metadata (quirk)
            str(v1[0]), str(v1[1]),  # r1_filter_forward <- R2 filter record (quirk)
            str(v3[0]), str(v3[1]),  # r1_filter_reverse <- placeholder
            str(v0[0]), str(v0[1]),  # r2_filter_forward <- R1 filter record (quirk)
            str(v2[0]), str(v2[1]),  # r2_filter_reverse <- placeholder
            str(triage),
            str(orientation),
        ]
    )


def log_header() -> str:
    return (
        "nimble_features\tnimble_score\t"
        + bam_data_header("r1")
        + "\t"
        + bam_data_header("r2")
        + "\t"
        + FILTER_HEADER
    )


