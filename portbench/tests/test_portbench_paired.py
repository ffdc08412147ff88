"""The paired-end cell (``basic_fastq_paired150``): the draw of its pairs, the
frozen count at its bucket, its readers, the control, and runs on the CPU
of a tiny copy of the cell."""

import json

import numpy as np
import pytest
import torch

from portbench import control, generate, mates, paired, roofline, run, spec
from portbench.paths import fastq_paired

BENCH = spec.benchmark()
CELL = "basic_fastq_paired150"
SEEDS = (7, 2**31 + 5, 2**45 + 1)
TINY = {"config": "basic_paired", "traffic": "paired150", "path": "fastq_paired",
        "pairs_per_pass": 1024}
NEW = ("fastq_pair.mate_wait_us_per_read",
       "fastq_pair.stack_pair_us_per_read", "fastq_pair.pairs_both_pct")


@pytest.fixture
def tiny_paired(tiny):
    """The ``tiny`` cells and a tiny copy of the paired cell, which reports
    every metric of the cell it copies."""
    bench = tiny
    name = "tiny_basic_fastq_paired"
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


def _draw(n_pairs, seed, **changes):
    c = spec.load_cell(CELL, BENCH)
    lib = generate.library(c["config_file"])
    return lib, paired.fastq_pairs(lib, dict(c["traffic_file"], **changes),
                                   n_pairs, seed)


def _fragments(p):
    """Each fragment as drawn, before errors: (fragments, length) codes,
    padded with -1, off the reverse complement where it was read so."""
    out = np.full((len(p.row), p.length.max()), -1, dtype=np.int64)
    for f in range(len(p.row)):
        frag = p.transcripts[p.row[f], p.start[f]: p.start[f] + p.length[f]]
        out[f, : p.length[f]] = (generate.revcomp_codes(frag)
                                 if p.reverse[f] else frag)
    return out


def test_every_seed_draws_the_same_counts():
    counts = []
    for seed in SEEDS:
        lib, p = _draw(5000, seed)
        assert p.r1.shape == p.r2.shape == (5000, 150)
        n_frag = len(p.row)
        counts.append((n_frag, tuple(np.bincount(p.row, minlength=5)),
                       int(p.reverse.sum()), int((p.substituted == 1).sum()),
                       int((p.substituted == 2).sum()), int(p.junk.sum()),
                       tuple(np.bincount(np.bincount(p.fragment)))))
        assert 200 <= p.length.min() and p.length.max() <= 400
    assert counts[0] == counts[1] == counts[2]
    n_frag, per_row, reverse = counts[0][:3]
    assert n_frag == 2000 and max(per_row) - min(per_row) <= 1
    assert reverse == n_frag // 2
    again = _draw(5000, SEEDS[0])[1]
    assert np.array_equal(again.r1, _draw(5000, SEEDS[0])[1].r1)
    assert not np.array_equal(again.r1, _draw(5000, SEEDS[1])[1].r1)


def test_mates_are_fr():
    """Clean pairs: R1 the fragment's first 150 bases, R2 the reverse
    complement of its last 150; on the transcript's strand R2 lies
    downstream of R1, both found where the fragment's ends are."""
    _lib, p = _draw(3000, SEEDS[1], substitution_share=0.0, junk_share=0.0)
    frags = _fragments(p)
    for i in range(len(p.r1)):
        f = p.fragment[i]
        n = p.length[f]
        assert np.array_equal(p.r1[i], frags[f, :150])
        assert np.array_equal(p.r2[i],
                              generate.revcomp_codes(frags[f, n - 150: n]))
        tx = p.transcripts[p.row[f]]
        strand = generate.revcomp_codes(tx) if p.reverse[f] else tx
        text = generate.decode(strand)
        a = text.find(generate.decode(p.r1[i]))
        b = text.find(generate.decode(generate.revcomp_codes(p.r2[i])))
        assert a >= 0 and b - a == n - 150


def test_every_fragment_overlaps_its_row_by_a_kmer():
    lib, p = _draw(20000, SEEDS[2])
    row_len = len(lib.codes[0])
    end = p.start + p.length
    overlap = (np.minimum(end, p.flank + row_len)
               - np.maximum(p.start, p.flank))
    assert overlap.min() == 30
    # a share of mates carry only flank
    r1_end = p.start + 150
    r2_start = end - 150
    only_flank = (r1_end <= p.flank) | (r2_start >= p.flank + row_len)
    assert 0 < only_flank.mean() < 1


def test_substitution_and_junk_pairs_come_to_exact_shares():
    for seed in SEEDS:
        _lib, p = _draw(5000, seed)
        n_frag = len(p.row)
        frags = _fragments(p)
        first = np.unique(p.fragment, return_index=True)[1]
        f = p.fragment[first]
        n = p.length[f][:, None]
        clean1 = frags[f, :150]
        clean2 = 3 - np.take_along_axis(frags[f], n - 1 - np.arange(150), 1)
        d1 = (p.r1[first] != clean1).sum(1)
        d2 = (p.r2[first] != clean2).sum(1)
        junk = p.junk[f]
        one = ((d1 + d2) == 1) & ~junk
        assert len(first) == n_frag
        assert one.sum() == round(0.2 * n_frag)
        assert (d1 == 1).sum() == (d2 == 1).sum() == round(0.1 * n_frag)
        assert junk.sum() == round(0.05 * n_frag)
        assert ((d1 + d2)[~one & ~junk] == 0).all()
        # a duplicate repeats both mates exactly
        for f in np.flatnonzero(np.bincount(p.fragment) > 1)[:50]:
            rows = np.flatnonzero(p.fragment == f)
            assert (p.r1[rows] == p.r1[rows[0]]).all()
            assert (p.r2[rows] == p.r2[rows[0]]).all()


def test_the_replay_launches_at_bucket_160_and_its_count_is_chip_smokes(
        tmp_path):
    """150 bp rows go to bucket 160 (``DEFAULT_BUCKETS``); there the
    frozen count equals ``chip_smoke._probe_walk_work`` and the packed rows
    the program's."""
    import chip_smoke
    from nimble_tpu_torch.models.aligner import pack_reads

    cell = dict(spec.load_cell(CELL, BENCH), pairs_per_pass=12000)
    inputs = fastq_paired.make_inputs(cell, SEEDS[0], str(tmp_path))
    state = fastq_paired.setup(inputs, "cpu")
    engine = state["engine"]
    work = fastq_paired.replay(state, inputs)
    assert work["bucket"] == 160 and work["launches"] == 1
    rows = fastq_paired.stacked_rows(inputs)[: engine.launch_batch]
    lens = np.full(len(rows), 150, dtype=np.int32)
    mine = roofline.pack_reads(rows, lens, 160)
    assert (mine == pack_reads(rows, lens, 160)).all()
    packed = torch.from_numpy(mine)
    want = chip_smoke._probe_walk_work(packed, engine.tables, 160,
                                       engine.c_max, False)
    assert (work["bytes"], work["ops"]) == want
    assert roofline.probe_walk_work(packed, engine.tables, 160, engine.c_max,
                                    True) == chip_smoke._probe_walk_work(
        packed, engine.tables, 160, engine.c_max, True)


@pytest.mark.parametrize("overrides", [
    None, {"require_valid_pair": True}, {"intersect_level": 1},
    {"intersect_level": 2}, {"num_mismatches": 1}])
def test_the_reference_equals_get_calls_over_every_distinct_pair(
        tmp_path, overrides):
    """The reference runs ``get_calls`` once a group of pairs with the same
    two eq classes; over every distinct pair at once it counts the same."""
    from portbench.reference import align, expected, host
    from portbench.reference import paired as reference

    lib, p = _draw(3000, SEEDS[2])
    path = str(tmp_path / "library.json")
    generate.write_library(path, lib)
    got = reference.fastq_pair_tsv(path, "unstranded", p.r1, p.r2, "cpu",
                                   overrides)
    cfg, ref = expected.load(path, "unstranded", overrides)
    uniq = np.unique(np.concatenate([p.r1, p.r2], axis=1), axis=0)
    m1, m2 = list(uniq[:, :150]), list(uniq[:, 150:])
    index = expected.index_of(ref, "cpu")
    engine = host.PrecomputedEngine(align.align(index, m1, cfg),
                                    align.align(index, m2, cfg))
    results, _, _ = host.call(m1, m2, [], engine, ref, cfg)
    want = "feature\tscore\n" + "".join(
        "\t".join(f) + f"\t{entry[0]}\n" for f, entry in results)
    assert got == want.encode("utf-8")


def test_the_control_is_not_correct(tiny_paired, tmp_path):
    got = control.readings(spec.load_cell(tiny_paired, spec.benchmark()),
                           2**31 + 9, "cpu", str(tmp_path))
    assert got["passes_wrong"] == 1, got


def _run(capsys, *argv):
    rc = run.main(list(argv), device="cpu")
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_a_run_is_correct_and_its_trace_reads_the_pair(tiny_paired, capsys):
    rc, line = _run(capsys, "--workload", tiny_paired, "--seed",
                    str(2**33 + 3), "--seconds", "0.01", "--trace", "0")
    assert rc == 0 and line["correct"] is True, line["checks"]
    assert line["attempted"] == 2 * TINY["pairs_per_pass"]
    assert set(line["metrics"]) == {"fastq_reads_per_s", "setup_s"}
    rc, line = _run(capsys, "--workload", tiny_paired, "--seed", "43",
                    "--seconds", "0.01", "--trace", "1")
    assert rc == 0 and line["correct"] is True
    metrics = line["metrics"]
    for name in NEW[:2]:
        assert metrics[name]["value"] > 0, name
    assert 0 < metrics["fastq_pair.pairs_both_pct"]["value"] < 100
    assert 0 < metrics["fastq.distinct_rows_pct"]["value"] <= 100
    listed = {m["name"] for m in BENCH["per_layer"]
              if CELL in m["workloads"]
              and m["source"] in ("program_span", "program_counter")
              and m["name"] not in ("setup.device_open_s",
                                    "setup.kernel_load_s")}
    assert listed <= set(metrics)  # the card's set-up spans: on the card


def test_a_single_end_run_reads_no_pair(tiny, capsys):
    rc, line = _run(capsys, "--workload", "tiny_basic_fastq", "--seed", "3",
                    "--seconds", "0.01", "--trace", "1")
    assert rc == 0
    metrics = line["metrics"]
    assert metrics["fastq_pair.mate_wait_us_per_read"]["value"] == 0.0
    assert metrics["fastq_pair.stack_pair_us_per_read"]["value"] == 0.0
    assert "fastq_pair.pairs_both_pct" not in metrics


def test_a_program_without_the_pair_counters_reads_nothing(monkeypatch):
    from nimble_tpu_torch.pipeline import fastq_pipeline

    monkeypatch.setattr(fastq_pipeline, "COUNTERS", tuple(
        c for c in fastq_pipeline.COUNTERS if not c.startswith("fastq.pair")))
    ctx = {"items": 10}
    assert mates.recorded() is None
    for name in NEW:
        assert spec.metric_reader(name).read(ctx) is None


def test_the_benchmark_entries_are_appended_only():
    """The cell is in the FASTQ rate and the FASTQ metrics that mean the
    same on it, not in the stacked pass's; the new metrics list it alone."""
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert BENCH["workloads"][-1] is cell
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "basic_paired", "paired150", 1)
    assert BENCH["configs"][-1]["name"] == "basic_paired"
    assert spec.load_cell(CELL, BENCH)["pairs_per_pass"] == 262144
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["fastq_reads_per_s"]["workloads"][-1] == CELL
    for m in BENCH["per_layer"]:
        stacked = m["layer"] == "models.multi_aligner"
        if m["name"].startswith(("fastq.", "setup.")) and not stacked:
            assert m["workloads"][-1] == CELL, m["name"]
        elif m["name"] in NEW:
            assert m["workloads"] == [CELL]
        else:
            assert CELL not in m["workloads"], m["name"]
    assert [m["name"] for m in BENCH["per_layer"][-3:]] == list(NEW)


def test_the_paired_job_runs_the_published_basic_library_unchanged():
    """The configuration is ``basic``'s library and strand filter in a job of
    two files; a configuration of one file is no paired job."""
    paired_job, single = (json.loads((spec.HERE / "configs" / f"{name}.json")
                                     .read_text()) for name in
                          ("basic_paired", "basic"))
    assert paired_job["input"] == "paired" and "input" not in single
    for key in ("library", "strand_filter"):
        assert paired_job[key] == single[key], key
    cell = dict(spec.load_cell(CELL, BENCH), config="basic",
                config_file=single)
    with pytest.raises(SystemExit, match="no paired job"):
        fastq_paired.make_inputs(cell, 7, "unused")
