"""The port's BAM forensic path: process_fast on TorchAlignEngine, byte for byte.

``pipeline.bam_fast.process_fast`` driven by ``TorchAlignEngine(device=
"cpu")`` must write the golden forensic TSVs (``tests/data/golden``) in both
quirk modes and both walk modes, and the same bytes as ``process_fast``
driven by ``DeviceAlignEngine`` on a synthetic 10x BAM whose reads repeat
and whose quality tails are trimmed.  The port's CLI runs the BAM branch
with one and with three consumer threads, with several libraries in one
call (one stacked pass when their trim settings agree, per-library launches
when they differ; each library's TSV equal to its single-library run),
refuses BAM input without the native host library and leaves the
interpreter's switch interval as it found it.  Outputs are compared as
decompressed bytes: exact equality.
"""

import contextlib
import gzip
import io
import sys
import time

import numpy as np
import pytest

from nimble_tpu import native
from nimble_tpu.config import AlignFilterConfig
from nimble_tpu.index.build import build_index
from nimble_tpu.io.bam import (
    FLAG_FIRST_IN_TEMPLATE,
    FLAG_LAST_IN_TEMPLATE,
    FLAG_MATE_REVERSE,
    FLAG_PAIRED,
    FLAG_REVERSE,
    BamHeader,
    BamRecord,
    write_bam,
)
from nimble_tpu.library import Reference
from nimble_tpu.models.aligner import DeviceAlignEngine
from nimble_tpu.pipeline.bam_fast import process_fast
from nimble_tpu.utils.dna import revcomp
from nimble_tpu_torch.cli import main
from nimble_tpu_torch.models.aligner import TorchAlignEngine
from nimble_tpu_torch.models import multi_aligner
from nimble_tpu_torch.workload import (
    write_bam_workload,
    write_multi_bam_workload,
)

from conftest import library_path
from test_golden_forensic import BAM as GOLDEN_BAM
from test_golden_forensic import _expected, _workload


@pytest.fixture(scope="module", autouse=True)
def native_library():
    """The columnar BAM path needs the native host library, which g++
    builds on first use next to its source.  Test processes that start at
    once may each build it; one of them can then load a half-written file,
    and the loader keeps that failure for the life of the process.  Retry
    the load here until the file is whole."""
    for _ in range(60):
        if native.available():
            return
        time.sleep(1.0)
        native._tried = False  # the loader's one-shot flag: load again
    pytest.fail("the native host library (native/nimble_host.cpp) failed "
                "to build or load")


def _run(engine, reference, cfg, bam, out, *, quirks=True, cores=2):
    with contextlib.redirect_stdout(io.StringIO()):
        process_fast([str(bam)], [engine], [reference], [cfg], [str(out)],
                     cores, False, parity_quirks=quirks)
    with gzip.open(out, "rb") as f:
        return f.read()


@pytest.mark.parametrize("walk", ["fused", "double"])
@pytest.mark.parametrize("quirks", [True, False])
def test_golden_forensic_tsv_bytes(tmp_path, quirks, walk):
    reference, index, cfg = _workload()
    engine = TorchAlignEngine(index, cfg, device="cpu", walk=walk)
    got = _run(engine, reference, cfg, GOLDEN_BAM, tmp_path / "o.tsv.gz",
               quirks=quirks)
    assert got == _expected(quirks)


def _trimmed_duplicate_bam(path, feats, seed):
    """A 10x-style BAM whose fragments repeat across pairs and groups (a
    pool of 24), every 4th with a substitution, and whose quality strings
    end in low-quality tails of 0..35 bases that the trim cuts off; R2 is
    stored reverse-complemented with the REVERSE flag."""
    rng = np.random.default_rng(seed)
    pool = []
    for i in range(24):
        src = feats[int(rng.integers(0, len(feats)))]
        L = int(rng.integers(60, 101))
        s = int(rng.integers(0, len(src) - L + 1))
        frag = list(src[s : s + L])
        if i % 4 == 3:
            p = int(rng.integers(0, L))
            frag[p] = "ACGT"[("ACGT".index(frag[p]) + 1) % 4]
        pool.append("".join(frag))
    records = []
    for g in range(60):
        umi = "".join(rng.choice(list("ACGT"), size=10))
        for p in range(3):
            qn = f"q{g:03d}_{p}"
            f1 = pool[int(rng.integers(0, len(pool)))]
            f2 = pool[int(rng.integers(0, len(pool)))]
            pair = []
            for frag, flag in (
                    (f1, FLAG_PAIRED | FLAG_FIRST_IN_TEMPLATE
                     | FLAG_MATE_REVERSE),
                    (revcomp(f2), FLAG_PAIRED | FLAG_LAST_IN_TEMPLATE
                     | FLAG_REVERSE)):
                tail = int(rng.integers(0, 36))
                qual = bytes([38] * (len(frag) - tail) + [2] * tail)
                r = BamRecord(qname=qn, flag=flag, pos=100 + p, mpos=200 + p,
                              tlen=150, seq=frag, qual=qual, tid=0, mtid=0,
                              mapq=60)
                r.tags["CB"] = ("Z", f"CB{g % 7:04d}-1")
                r.tags["UB"] = ("Z", umi)
                pair.append(r)
            records += pair
    header = BamHeader(text="@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:1000000\n",
                       references=[("chr1", 1_000_000)])
    write_bam(str(path), header, records)


@pytest.mark.parametrize("walk", ["fused", "double"])
def test_synthetic_bam_matches_device_engine(tmp_path, walk):
    rng = np.random.default_rng(77)
    feats = ["".join(rng.choice(list("ACGT"), size=220)) for _ in range(4)]
    doubled = [x for f in feats for x in (f, revcomp(f))]
    names = [n for i in range(4) for n in (f"g{i}", f"g{i}§rev")]
    reference = Reference(group_on=0, headers=["sequence_name", "sequence"],
                          columns=[names, doubled], sequence_name_idx=0,
                          sequence_idx=1)
    cfg = AlignFilterConfig(reference_genome_size=8, score_percent=0.3,
                            score_threshold=35, num_mismatches=1,
                            max_hits_to_report=8, trim_target_length=50,
                            trim_strictness=0.9)
    bam = tmp_path / "trim_dup.bam"
    _trimmed_duplicate_bam(bam, feats, seed=3)
    index = build_index(doubled)
    want = _run(DeviceAlignEngine(index, cfg), reference, cfg, bam,
                tmp_path / "jax.tsv.gz")
    got = _run(TorchAlignEngine(index, cfg, device="cpu", walk=walk),
               reference, cfg, bam, tmp_path / "torch.tsv.gz")
    assert got == want
    rows = got.splitlines()[1:]
    assert len(rows) > 100
    assert sum(r.split(b"\t")[0] != b"" for r in rows) > 20


def test_cli_bam_cpu_one_and_three_consumers(tmp_path):
    """The BAM branch of the port's CLI over a two-batch BAM: one consumer
    thread (-c 2) and three (-c 4) write the same bytes, with both walks."""
    wl = write_bam_workload(str(tmp_path / "wl"), n_features=6, feat_len=300,
                            n_groups=2600, seed=4)
    outs = {}
    for cores, walk in (("2", "fused"), ("4", "fused"), ("4", "double")):
        out = str(tmp_path / f"c{cores}_{walk}.tsv.gz")
        with contextlib.redirect_stdout(io.StringIO()) as log:
            rc = main(["-r", wl.library, "-i", wl.inputs[0], "-o", out,
                       "--device", "cpu", "-c", cores, "--walk", walk])
        assert rc == 0
        assert "Processing as BAM file" in log.getvalue()
        assert log.getvalue().count("Spawning consumer thread") == \
            int(cores) - 1
        with gzip.open(out, "rb") as f:
            outs[(cores, walk)] = f.read()
    first = outs[("2", "fused")]
    assert all(v == first for v in outs.values())
    assert first.count(b"\n") > 10000


def test_cli_bam_restores_switch_interval(tmp_path):
    reference_json = library_path("basic.json")
    before = sys.getswitchinterval()
    sys.setswitchinterval(0.0123)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = main(["-r", reference_json, "-i", GOLDEN_BAM, "-o",
                       str(tmp_path / "o.tsv.gz"), "--device", "cpu"])
        assert rc == 0
        assert sys.getswitchinterval() == pytest.approx(0.0123)
    finally:
        sys.setswitchinterval(before)


@pytest.mark.parametrize("trim", [None, "40:0.9,30:0.5,40:0.9"])
def test_cli_bam_two_libraries(tmp_path, monkeypatch, trim):
    """Three libraries over one BAM in one CLI call, equal to each
    library's single-library run: uniform trim takes one stacked pass per
    batch, per-library trim takes per-engine launches."""
    wl = write_multi_bam_workload(str(tmp_path / "wl"),
                                  libraries=[(5, 300), (4, 250), (6, 200)],
                                  n_groups=700, seed=8)
    stacked = []
    real = multi_aligner.probe_walk_full_multi
    monkeypatch.setattr(multi_aligner, "probe_walk_full_multi",
                        lambda packed, **kw: stacked.append(1)
                        or real(packed, **kw))
    trims = ["40:0.9", "30:0.5", "40:0.9"] if trim else [None] * 3
    outs = [str(tmp_path / f"m{i}.tsv.gz") for i in range(3)]
    argv = [a for lib, out in zip(wl.libraries, outs)
            for a in ("-r", lib, "-o", out)]
    with contextlib.redirect_stdout(io.StringIO()):
        rc = main([*argv, "-i", wl.inputs[0], "--device", "cpu", "-c", "4",
                   *(["-t", trim] if trim else [])])
    assert rc == 0
    assert bool(stacked) == (trim is None)
    for i, (lib, out) in enumerate(zip(wl.libraries, outs)):
        single = str(tmp_path / f"s{i}.tsv.gz")
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(["-r", lib, "-i", wl.inputs[0], "-o", single,
                         "--device", "cpu", "-c", "4",
                         *(["-t", trims[i]] if trim else [])]) == 0
        with gzip.open(out, "rb") as f, gzip.open(single, "rb") as g:
            got = f.read()
            assert got == g.read()
        assert got.count(b"\n") > 600


@pytest.mark.parametrize("case", ["no_native"])
def test_cli_bam_refusals(tmp_path, monkeypatch, case):
    args = ["-r", library_path("basic.json"), "-i", GOLDEN_BAM, "-o",
            str(tmp_path / "a.tsv.gz"), "--device", "cpu"]
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(SystemExit, match="native host library"):
        main(args)
    assert not (tmp_path / "a.tsv.gz").exists()
