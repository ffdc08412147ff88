"""The 10x 5′ BAM cell (``basic_fiveprime_bam_tenx5p``): the draw of its
records, its BAM, its readers, the control, and runs on the CPU of a tiny
copy of the cell."""

import gzip
import json

import numpy as np
import pytest

from portbench import control, fiveprime, generate, run, spec, strands
from portbench.paths import bam_fiveprime
from portbench.reference import fiveprime as reference

BENCH = spec.benchmark()
CELL = "basic_fiveprime_bam_tenx5p"
SEEDS = (7, 2**31 + 5, 2**45 + 1)
TINY = {"config": "basic_fiveprime", "traffic": "tenx5p",
        "path": "bam_fiveprime", "groups_per_pass": 384}
NEW = ("bam_5p.clipped_pct", "bam_5p.oriented_out_pct",
       "bam_5p.orient_us_per_rec")
STACKED = ("bam.stacked_rows_pct", "bam.library_collect_us_per_rec",
           "bam.stack_us_per_rec")
TSO = "TTTCTTATATGGG"


@pytest.fixture
def tiny_fiveprime(tiny):
    """The ``tiny`` cells and a tiny copy of the 5′ cell, which reports
    every metric of the cell it copies."""
    bench = tiny
    name = "tiny_basic_fiveprime_bam"
    (spec.CELLS / f"{name}.json").write_text(json.dumps(dict(name=name,
                                                             **TINY)))
    bench["workloads"].append({"name": name, "config": TINY["config"],
                               "traffic": TINY["traffic"], "chips": 1,
                               "why": "test"})
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            if CELL in m.get("workloads", ()) and name not in m["workloads"]:
                m["workloads"].append(name)
    return name


def _draw(n_groups, seed, **changes):
    c = spec.load_cell(CELL, BENCH)
    lib = generate.library(c["config_file"])
    return lib, fiveprime.records(lib, dict(c["traffic_file"], **changes),
                                  n_groups, seed)


def _reads(recs):
    """Each record as sequenced: the stored sequence, reverse-complemented
    back where the record is REVERSE."""
    out = []
    for i in range(recs.n_records):
        s = recs.seq(i)
        out.append(generate.decode(generate.revcomp_codes(s)
                                   if recs.flag[i] & 0x10 else s))
    return out


def test_every_seed_draws_the_same_counts():
    counts = []
    for seed in SEEDS:
        _lib, r = _draw(4000, seed)
        assert r.r1.shape == (16000, 124) and r.r2.shape == (16000, 150)
        on = r.on_library
        counts.append((int(on.sum()), int(r.antisense.sum()),
                       int(r.minus.sum()),
                       tuple(np.bincount(r.row[on], minlength=5)),
                       tuple(np.bincount(r.edited, minlength=3)),
                       int(((r.flag & 0x10) != 0).sum())))
        assert 200 <= r.length.min() and r.length.max() <= 400
        assert len(set(r.ub)) == 4000 and "A" * 10 not in r.ub
        assert {len(u) for u in r.ub} == {10}
    assert counts[0] == counts[1] == counts[2]
    n_on, antisense, minus, per_row, edited, reverse = counts[0]
    assert n_on == 200 and antisense == 20 and minus == 2000
    assert max(per_row) - min(per_row) <= 1
    assert edited == (32000 - 6400 - 1600, 6400, 1600)
    assert reverse == 16000  # one mate of every pair
    again = _draw(4000, SEEDS[0])[1]
    assert np.array_equal(again.r1, _draw(4000, SEEDS[0])[1].r1)
    assert not np.array_equal(again.r1, _draw(4000, SEEDS[1])[1].r1)


def test_r1_stores_the_tso_at_its_5p_end_and_r2_the_fragments_end():
    """Clean records: R1 as sequenced is the TSO then the molecule's first
    111 bases, stored as is with R2 REVERSE, or reverse-complemented with
    the TSO at the stored 3′ end under REVERSE; R2 the reverse complement
    of the fragment's last 150; a UMI's four R1s are equal."""
    lib, r = _draw(2000, SEEDS[1], substitution_share=0.0, junk_share=0.0)
    reads = _reads(r)
    flank = 400
    tso_rc = generate.decode(generate.revcomp_codes(
        generate._CODE[np.frombuffer(TSO.encode(), np.uint8)]))
    for p in range(len(r.r1)):
        g = p // 4
        stored1 = generate.decode(r.r1[p])
        if r.minus[g]:
            assert stored1.endswith(tso_rc)
            assert r.flag[2 * p] & 0x10 and not r.flag[2 * p + 1] & 0x10
        else:
            assert stored1.startswith(TSO)
            assert r.flag[2 * p + 1] & 0x10 and not r.flag[2 * p] & 0x10
        r1, r2 = reads[2 * p], reads[2 * p + 1]
        assert r1.startswith(TSO) and len(r1) == 124 and len(r2) == 150
        assert r1 == reads[8 * g]
        if r.on_library[g]:
            row = generate.decode(lib.codes[r.row[g]])
            if r.antisense[g]:
                row = generate.decode(generate.revcomp_codes(lib.codes[
                    r.row[g]]))
            cdna = r1[13:]
            at = r.start[g] - flank  # on the row's strand
            overlap = min(at + 111, 180) - max(at, 0)
            assert overlap >= 30
            lo = max(at, 0)
            assert cdna[lo - at: lo - at + overlap] == row[lo: lo + overlap]
    # R2 ends the fragment: its reverse complement starts length - 150
    # after R1's cDNA start on the molecule
    for p in range(0, len(r.r1), 97):
        r1, r2 = reads[2 * p], reads[2 * p + 1]
        mate = generate.decode(generate.revcomp_codes(
            generate._CODE[np.frombuffer(r2.encode(), np.uint8)]))
        shift = r.length[p] - 150
        if shift < 111:
            assert r1[13 + shift:] == mate[: 111 - shift]


def test_the_bam_holds_both_lengths_in_file_order(tmp_path):
    """The written BAM: R1 then R2 of each pair, 124 and 150 bases, the
    flags and the group's tags as drawn."""
    from nimble_tpu_torch.io.bam import BamReader

    _lib, r = _draw(30, SEEDS[2])
    path = str(tmp_path / "r.bam")
    fiveprime.write_bam(path, r)
    reader = BamReader(path)
    try:
        got = list(reader)
    finally:
        reader.close()
    assert len(got) == r.n_records
    for i, rec in enumerate(got):
        assert rec.flag == r.flag[i] and rec.pos == r.pos[i]
        assert rec.seq == generate.decode(r.seq(i))
        assert len(rec.seq) == (150 if i % 2 else 124)
        assert rec.tags["CB"][1] == r.cb[i // 8]
        assert rec.tags["UB"][1] == r.ub[i // 8]
    with gzip.open(path, "rb") as f:
        assert f.read() == fiveprime.bam_bytes(r)


def test_the_clip_follows_nimbles_reader():
    assert reference.clip("A" * 13 + "C" * 111, "(" * 13 + ")" * 111,
                          False) == ("C" * 111, ")" * 111)
    assert reference.clip("C" * 111 + "A" * 13, ")" * 111 + "(" * 13,
                          True) == ("C" * 111, ")" * 111)
    assert reference.clip("AC" * 62, "()" * 62, True) == (
        ("AC" * 62)[:111], ("()" * 62)[:111][::-1])
    assert reference.clip("G" * 150, "(" * 149 + ")", True) == (
        "G" * 150, ")" + "(" * 149)


def test_the_path_refuses_another_strand_filter():
    cell = spec.load_cell(CELL, BENCH)
    other = dict(cell, config="basic", config_file=spec.load_cell(
        "basic_bam_10x", BENCH)["config_file"])
    with pytest.raises(SystemExit, match="not fiveprime"):
        bam_fiveprime.make_inputs(other, 7, "unused")


def test_the_configuration_is_the_published_basic_library_under_fiveprime():
    body = json.loads((spec.HERE / "configs" / "basic_fiveprime.json")
                      .read_text())
    data = spec.ROOT / "tests" / "data" / "libraries" / "basic.json"
    assert body["library"] == json.loads(data.read_text())
    assert body["strand_filter"] == "fiveprime"
    entry = next(c for c in BENCH["configs"] if c["name"] == "basic_fiveprime")
    assert entry["reduced"] == [] and len(entry["source"]) <= 200


def test_the_control_is_not_correct(tiny_fiveprime, tmp_path):
    got = control.readings(spec.load_cell(tiny_fiveprime, spec.benchmark()),
                           2**31 + 9, "cpu", str(tmp_path))
    assert got["passes_wrong"] == 1, got


def _run(capsys, *argv):
    rc = run.main(list(argv), device="cpu")
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_a_run_is_correct_and_its_trace_reads_the_5p_pass(tiny_fiveprime,
                                                          capsys):
    rc, line = _run(capsys, "--workload", tiny_fiveprime, "--seed",
                    str(2**33 + 3), "--seconds", "0.01", "--trace", "0")
    assert rc == 0 and line["correct"] is True, line["checks"]
    assert line["attempted"] % (8 * TINY["groups_per_pass"]) == 0
    assert set(line["metrics"]) == {"bam_records_per_s", "setup_s"}
    rc, line = _run(capsys, "--workload", tiny_fiveprime, "--seed", "43",
                    "--seconds", "0.01", "--trace", "1")
    assert rc == 0 and line["correct"] is True
    metrics = line["metrics"]
    assert metrics["bam_5p.clipped_pct"]["value"] == 50.0
    assert 0 < metrics["bam_5p.oriented_out_pct"]["value"] < 100
    assert metrics["bam_5p.orient_us_per_rec"]["value"] > 0
    listed = {m["name"] for m in BENCH["per_layer"]
              if CELL in m["workloads"]
              and m["source"] in ("program_span", "program_counter")
              and m["name"] not in ("setup.device_open_s",
                                    "setup.kernel_load_s")}
    assert listed <= set(metrics)  # the card's set-up spans: on the card


def test_the_pass_counts_the_references_oriented_out_pairs(tmp_path):
    """A traced pass's ``bam.pairs_oriented_out`` equals the reference's
    count of such pairs."""
    import contextlib
    import io
    import os

    from nimble_tpu_torch.utils.metrics import RECORDER

    cell = dict(spec.load_cell(CELL, BENCH), groups_per_pass=300)
    inputs = bam_fiveprime.make_inputs(cell, SEEDS[1], str(tmp_path))
    state = bam_fiveprime.setup(inputs, "cpu")
    os.environ["NIMBLE_TIMING"] = "1"
    RECORDER.clear()
    try:
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            bam_fiveprime.run_pass(state, inputs, inputs["output"])
    finally:
        os.environ.pop("NIMBLE_TIMING", None)
    want = bam_fiveprime.check(inputs, "cpu")
    assert bam_fiveprime.compare(inputs, inputs["output"], want) == [
        ("tsv_lines_differing", 0)]
    assert RECORDER.counters["bam.pairs_oriented_out"] == \
        want["pairs_oriented_out"] > 0


def test_a_program_without_the_5p_counters_reads_nothing(monkeypatch):
    from nimble_tpu_torch.pipeline import bam_fast

    monkeypatch.setattr(bam_fast, "COUNTERS", tuple(
        c for c in bam_fast.COUNTERS if c not in strands.COUNTERS))
    ctx = {"items": 10}
    assert strands.recorded() is None
    for name in NEW:
        assert spec.metric_reader(name).read(ctx) is None


def test_the_benchmark_entries_are_appended_only():
    """The cell is in the BAM rate, in every ``bam.*`` metric but the
    stacked pass's three and in the set-up metrics; the new metrics list
    it alone."""
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "basic_fiveprime", "tenx5p", 1)
    assert len(cell["why"]) <= 200
    assert spec.load_cell(CELL, BENCH)["groups_per_pass"] == 16384
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["bam_records_per_s"]["workloads"][-1] == CELL
    assert CELL not in e2e["fastq_reads_per_s"]["workloads"]
    for m in BENCH["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == [CELL]
        elif m["name"] in STACKED or m["name"].startswith("fastq"):
            assert CELL not in m["workloads"], m["name"]
        elif m["name"].startswith(("bam.", "setup.")):
            assert m["workloads"][-1] == CELL, m["name"]
    assert [m["name"] for m in BENCH["per_layer"][-3:]] == list(NEW)
