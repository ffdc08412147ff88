"""The 10x 5′ BAM job of the benchmark's ``basic_fiveprime_bam_tenx5p`` cell on
the CPU: nimble's ``-f fiveprime`` job over 124-base R1s and 150-base R2s
against the published ``basic`` library, through the CLI's
``bam_fast.process_fast``.

For seeded BAMs drawn by the benchmark's own generator
(``portbench/fiveprime.py``) at a small size, the decompressed output must
equal, byte for byte,

- the plain 5′ reference (``portbench.reference.fiveprime.bam_tsv``: the
  10x clip from nimble's reader, then ``expected.bam_tsv``'s flow) under
  each strand filter, ``fiveprime``, ``threeprime``, ``unstranded`` and
  ``none``, each of the others changing ``fiveprime``'s output; and
- the JAX package's ``bam_fast.process_fast`` on the same BAM.

A traced pass counts every R1 record as clipped and as many pairs oriented
out as the reference works out, and opens ``bam.orient``.
"""

import contextlib
import gzip
import io
import os

import pytest

from nimble_tpu.models.aligner import DeviceAlignEngine
from nimble_tpu_torch.utils.metrics import RECORDER
from portbench import spec
from portbench.paths import bam_fiveprime
from portbench.reference import fiveprime as reference

from torch_sides import JAX, PORT

CELL = "basic_fiveprime_bam_tenx5p"
SEEDS = (3, 2**31 + 7, 2**44 + 9)
GROUPS = 240   # UMI groups: 1,920 records, 12 on the library
BATCH = 512    # records a batch: several batches, the last one short
FILTERS = ("fiveprime", "threeprime", "unstranded", "none")


@pytest.fixture(scope="module", autouse=True)
def native_libraries():
    from test_torch_bam import ensure_native_libraries

    ensure_native_libraries()


def _process(side, inputs, strand_filter, out):
    """``side``'s ``process_fast`` (one consumer) over the BAM under
    ``strand_filter`` (the CLI's ``-f``; the library file states none); the
    decompressed output."""
    cfg, ref = side.load_reference_library(
        inputs["library"], side.LibraryChemistry.from_cli(strand_filter))
    index = side.build_index(side.get_reference_sequence_data(ref)[0])
    if side is JAX:
        engine = DeviceAlignEngine(index, cfg)
    else:
        from nimble_tpu_torch.models.aligner import TorchAlignEngine

        engine = TorchAlignEngine(index, cfg, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        side.bam_fast.process_fast([inputs["input"]], [engine], [ref], [cfg],
                                   [out], 2, False, batch_records=BATCH)
    with gzip.open(out, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def drawn(tmp_path_factory):
    """The cell's inputs at ``GROUPS`` groups, a seed."""
    done = {}

    def get(seed):
        if seed not in done:
            cell = dict(spec.load_cell(CELL, spec.benchmark()))
            cell["groups_per_pass"] = GROUPS
            work = str(tmp_path_factory.mktemp(f"fiveprime{seed}"))
            done[seed] = bam_fiveprime.make_inputs(cell, seed, work)
        return done[seed]

    return get


@pytest.fixture(scope="module")
def jobs(drawn, tmp_path_factory):
    """(the program's output, the reference's, its oriented-out pairs) of a
    seed under a strand filter."""
    done = {}

    def get(seed, strand_filter):
        if (seed, strand_filter) not in done:
            inputs = drawn(seed)
            work = str(tmp_path_factory.mktemp(f"{strand_filter}{seed}"))
            got = _process(PORT, inputs, strand_filter,
                           os.path.join(work, "out.tsv.gz"))
            want, out = reference.bam_tsv(inputs["library"], strand_filter,
                                          inputs["records"], "cpu")
            done[seed, strand_filter] = got, want, out
        return done[seed, strand_filter]

    return get


@pytest.mark.parametrize("strand_filter", FILTERS)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_5p_job_equals_the_reference(jobs, seed, strand_filter):
    got, want, _ = jobs(seed, strand_filter)
    assert got == want
    rows = got.splitlines()[1:]
    assert sum(r.split(b"\t")[0] != b"" for r in rows) > 0  # calls
    if strand_filter != "fiveprime":  # each filter changes the 5′ output
        assert got != jobs(seed, "fiveprime")[0]


@pytest.mark.parametrize("seed", SEEDS)
def test_the_stranded_filters_write_outputs_of_their_own(jobs, seed):
    """``fiveprime``, ``threeprime`` and ``unstranded`` each write their own
    output.  ``none`` writes ``unstranded``'s: all that ``unstranded`` drops
    is a feature both mates call in one orientation, which a pair read off
    both strands of a molecule never does."""
    got = {f: jobs(seed, f)[0] for f in FILTERS}
    assert len({got["fiveprime"], got["threeprime"], got["unstranded"]}) == 3
    assert got["none"] == got["unstranded"]


def test_the_5p_rows_carry_both_mates_stored_lengths_and_strands(jobs):
    """Every forensic row's R1 block gives the stored 124 bases and its R2
    block 150 (the clipped SEQ and QUAL key the filter columns and the
    trim, and no row prints them); R1 is REVERSE on some rows and forward
    on others, R2 the opposite."""
    got, _, _ = jobs(SEEDS[1], "fiveprime")
    header, *rows = got.decode().splitlines()
    names = header.split("\t")
    assert rows
    strands = set()
    for row in rows:
        fields = dict(zip(names, row.split("\t")))
        # the r1/r2 swap quirk: the "r1" block holds the mate's metadata
        assert (fields["r2_SEQ_LEN"], fields["r1_SEQ_LEN"]) == ("124", "150")
        assert fields["r2_REVERSE"] != fields["r1_REVERSE"]
        strands.add(fields["r2_REVERSE"])
    assert strands == {"true", "false"}


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_the_5p_job_equals_the_jax_package(drawn, jobs, tmp_path, seed):
    want = _process(JAX, drawn(seed), "fiveprime",
                    str(tmp_path / "jax.tsv.gz"))
    assert jobs(seed, "fiveprime")[0] == want


def test_a_traced_5p_pass_counts_the_clip_and_the_oriented_out_pairs(
        drawn, jobs, tmp_path, monkeypatch):
    inputs = drawn(SEEDS[2])
    _, _, out = jobs(SEEDS[2], "fiveprime")
    monkeypatch.setenv("NIMBLE_TIMING", "1")
    RECORDER.clear()
    with contextlib.redirect_stderr(io.StringIO()):
        _process(PORT, inputs, "fiveprime", str(tmp_path / "out.tsv.gz"))
    c = RECORDER.counters
    records = 8 * (GROUPS - 1)  # the last group dropped
    assert c["bam.records_in"] == records
    assert c["bam.records_clipped"] == records // 2
    assert c["bam.pairs_oriented_out"] == out > 0
    assert any(s.name == "bam.orient" for s in RECORDER.spans)
