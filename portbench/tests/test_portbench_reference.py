"""The plain reference against the port's own CPU oracle, read by read, and
the frozen byte count against chip_smoke's."""

import numpy as np
import pytest
import torch

from portbench import generate, roofline, spec
from portbench.reference import align, host

BENCH = spec.benchmark()


def _alleles(seed: int) -> generate.Library:
    """A test library beside the configurations: 12 families of 2-20
    alleles, 1,100 bp, 22 substitutions from the family's first, with
    num_mismatches 1, so that anchors have more postings than the program's
    c_max and mismatched walks are called."""
    rng = np.random.default_rng(seed)
    codes = []
    for size in np.linspace(2, 20, 12).astype(int):
        first = rng.integers(0, 4, 1100, dtype=np.int8)
        for a in range(size):
            allele = first.copy()
            if a:
                sites = rng.choice(1100, 22, replace=False)
                allele[sites] = (allele[sites] + rng.integers(1, 4, 22)) % 4
            codes.append(allele)
    filters = dict(spec.load_cell("basic_fastq_ontarget", BENCH)[
        "config_file"]["library"][0], num_mismatches=1)
    names = [f"a{i}" for i in range(len(codes))]
    table = {"headers": ["sequence_name", "sequence"],
             "columns": [names, [generate.decode(c) for c in codes]]}
    return generate.Library([filters, table], codes)


def _library(config, seed, tmp_path):
    c = spec.load_cell("basic_fastq_ontarget", BENCH)
    lib = (_alleles(seed) if config == "alleles"
           else generate.library(c["config_file"]))
    path = str(tmp_path / "library.json")
    generate.write_library(path, lib)
    reads = generate.fastq_reads(lib, c["traffic_file"], 8192, seed)
    return path, reads


@pytest.mark.parametrize("config", ["basic", "alleles"])
def test_alignment_equals_the_ports_pseudoalign(config, tmp_path):
    from nimble_tpu_torch.config import LibraryChemistry
    from nimble_tpu_torch.core.filters import pseudoalign
    from nimble_tpu_torch.index.build import build_index
    from nimble_tpu_torch.library import (get_reference_sequence_data,
                                          load_reference_library)

    path, reads = _library(config, 2**31 + 3, tmp_path)
    seqs = list(reads)
    # the gates ahead of the walk: short, low entropy, and a skipped read
    seqs[0], seqs[1], seqs[2], seqs[3] = (reads[0][:35],
                                          np.zeros(90, np.int8),
                                          reads[2][:61], None)
    pcfg, pref = load_reference_library(path, LibraryChemistry.UNSTRANDED)
    pidx = build_index(get_reference_sequence_data(pref)[0])
    cfg, ref = host.load_reference_library(
        path, host.LibraryChemistry.UNSTRANDED)
    index = align.KmerIndex([host.encode_bases(s) for s in
                             host.get_reference_sequence_data(ref)[0]], "cpu")
    got = align.align(index, seqs, cfg)
    for s, (aln, filt) in zip(seqs, got):
        want_aln, want_filt = ((None, None) if s is None
                               else pseudoalign(s, pidx, pcfg, 40))
        assert aln == want_aln
        assert (filt is None) == (want_filt is None)
        if filt is not None:
            assert (filt[0].value, filt[1], filt[2]) == (
                want_filt[0].value, want_filt[1], want_filt[2])
    # on the allele families, reads whose anchor has more postings than
    # the program's c_max = 8 (its host rescue) are among them
    keys = align._keys(torch.from_numpy(reads.astype(np.int64)), align.K)
    slot = torch.searchsorted(index.keys, keys).clamp(
        max=index.keys.numel() - 1)
    hit = index.keys[slot] == keys
    first = torch.where(hit, torch.arange(keys.shape[1]), keys.shape[1])
    first = first.amin(1).clamp(max=keys.shape[1] - 1)
    count = index.post_count[slot.gather(1, first[:, None])[:, 0]]
    over = int((hit.any(1) & (count > 8)).sum())
    assert (over > 1000) == (config == "alleles"), over


@pytest.mark.parametrize("config", ["basic", "alleles"])
@pytest.mark.parametrize("full", [False, True])
def test_frozen_byte_count_equals_chip_smokes(config, full, tmp_path):
    import chip_smoke
    from nimble_tpu_torch.config import LibraryChemistry
    from nimble_tpu_torch.index.build import build_index
    from nimble_tpu_torch.library import (get_reference_sequence_data,
                                          load_reference_library)
    from nimble_tpu_torch.models.aligner import TorchAlignEngine, pack_reads

    path, reads = _library(config, 5, tmp_path)
    cfg, ref = load_reference_library(path, LibraryChemistry.UNSTRANDED)
    engine = TorchAlignEngine(build_index(get_reference_sequence_data(ref)[0]),
                              cfg, device="cpu")
    lens = np.full(len(reads), 90, dtype=np.int32)
    mine = roofline.pack_reads(reads, lens, 92)
    assert (mine == pack_reads(reads, lens, 92)).all()
    packed = torch.from_numpy(mine)
    assert roofline.probe_walk_work(packed, engine.tables, 92, engine.c_max,
                                    full) == chip_smoke._probe_walk_work(
        packed, engine.tables, 92, engine.c_max, full)
