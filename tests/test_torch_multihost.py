"""The port's multi-host pipeline against the JAX package's, on the CPU.

``nimble_tpu_torch.parallel.multihost`` replaces ``jax.distributed`` with a
gloo process group.  Its routing, packing, ownership hash, merge and ranges
are copies: each is run beside the JAX function on the same seeded inputs
and must give the same arrays.  Hosts are simulated in one process through
the ``allgather`` / ``allgather_bytes`` injection points (threads meeting
in an exchanging allgather), as ``tests/test_multihost.py`` does, and run
for real as two gloo processes (``file://`` rendezvous, or the CLI's
``--coordinator``), each with its own timeout and killed at it.  Every
merged table, TSV and decompressed forensic TSV must equal the JAX
package's single-process output byte for byte; a world that does not span
the claimed hosts, or a peer that never joins a collective, must raise.
"""

import contextlib
import datetime
import gzip
import io
import os
import pickle
import socket
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from nimble_tpu.cli import main as jax_main
from nimble_tpu.models.aligner import DeviceAlignEngine
from nimble_tpu.parallel import multihost as jax_mh
from nimble_tpu_torch.cli import main as port_main
from nimble_tpu_torch.models.aligner import TorchAlignEngine
from nimble_tpu_torch.parallel import multihost as port_mh
from nimble_tpu_torch.workload import write_bam_workload, write_workload

from conftest import library_path, reads_path
from test_torch_bam import ensure_native_libraries
from torch_sides import JAX, PORT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_TIMEOUT_S = 150  # each host subprocess is killed after this


@pytest.fixture(scope="module", autouse=True)
def native_libraries():
    ensure_native_libraries()


def _codes(rng, n, width, lo, hi):
    """(n, width) int8 codes zero past each of ``n`` lengths in [lo, hi)."""
    mat = rng.integers(0, 4, (n, width)).astype(np.int8)
    lens = rng.integers(lo, hi, n).astype(np.int32)
    mat[np.arange(width)[None, :] >= lens[:, None]] = 0
    return mat, lens


# --- the pure functions -------------------------------------------------------

@pytest.mark.parametrize("n_records,n_hosts", [(0, 2), (7, 3), (24, 2),
                                               (1001, 8)])
def test_ranges_match_and_partition(n_records, n_hosts):
    for fn in ("host_record_range", "host_group_range"):
        got = [getattr(port_mh, fn)(n_records, n_hosts, h)
               for h in range(n_hosts)]
        assert got == [getattr(jax_mh, fn)(n_records, n_hosts, h)
                       for h in range(n_hosts)]
        assert got[0][0] == 0 and got[-1][1] == n_records
        assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


@pytest.mark.parametrize("L", [1, 3, 40, 90, 91])
def test_pack2bit_round_trip(L):
    rng = np.random.default_rng(8 + L)
    mat = rng.integers(0, 4, (37, L)).astype(np.int8)
    packed = port_mh._pack2bit(mat)
    np.testing.assert_array_equal(packed, jax_mh._pack2bit(mat))
    u = port_mh._unpack2bit(packed)
    np.testing.assert_array_equal(u, jax_mh._unpack2bit(packed))
    assert u.shape[1] >= L and (u[:, :L] == mat).all()
    assert (u[:, L:] == 0).all()


@pytest.mark.parametrize("paired", [False, True])
def test_read_owner_hash(monkeypatch, paired):
    """Ownership depends only on read CONTENT: the native hash, the NumPy
    fallback and any pad width agree, and equal the JAX package's."""
    rng = np.random.default_rng(7)
    mat, lens = _codes(rng, 2000, 90, 40, 91)
    mates = _codes(rng, 2000, 77, 40, 78) if paired else (None, None)
    nat = port_mh._read_owner_hash(mat, lens, 5, *mates)
    np.testing.assert_array_equal(
        nat, jax_mh._read_owner_hash(mat, lens, 5, *mates))
    wide = np.zeros((2000, 128), dtype=np.int8)
    wide[:, :90] = mat
    np.testing.assert_array_equal(
        port_mh._read_owner_hash(wide, lens, 5, *mates), nat)
    monkeypatch.setattr(PORT.native, "owner_hash", lambda *a, **k: None)
    np.testing.assert_array_equal(
        port_mh._read_owner_hash(mat, lens, 5, *mates), nat)
    assert set(np.unique(nat)) == set(range(5))


def test_owner_hash_refuses_mismatched_lengths():
    mat = np.zeros((4, 8), dtype=np.int8)
    with pytest.raises(ValueError, match="lengths"):
        PORT.native.owner_hash(mat, np.full(3, 8), 2)
    with pytest.raises(ValueError, match="lengths"):
        PORT.native.owner_hash(mat, np.full(4, 8), 2, mat[:3],
                               np.full(3, 8))


def _exchanging_allgather(n):
    """A simulated allgather over ``n`` host threads that really exchanges
    each host's payload."""
    cond = threading.Condition()
    state = {"items": {}, "result": None, "gen": 0}

    def make(host):
        def ag(payload):
            with cond:
                gen = state["gen"]
                state["items"][host] = payload
                if len(state["items"]) == n:
                    state["result"] = [state["items"][h] for h in range(n)]
                    state["items"] = {}
                    state["gen"] += 1
                    cond.notify_all()
                    return list(state["result"])
                while state["gen"] == gen:
                    if not cond.wait(timeout=120):
                        raise RuntimeError("simulated allgather timed out")
                return list(state["result"])
        return ag
    return make


def _threaded_hosts(n, run):
    """``run(host, make_allgather)`` on ``n`` host threads; returns each
    host's result or raised exception, by host."""
    make = _exchanging_allgather(n)
    results = {}

    def host(h):
        try:
            results[h] = run(h, make)
        except Exception as e:  # reported to the test
            results[h] = e

    threads = [threading.Thread(target=host, args=(h,), name=f"mh-host-{h}")
               for h in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
        assert not t.is_alive(), "a simulated host deadlocked"
    return [results[h] for h in range(n)]


@pytest.mark.parametrize("paired", [False, True])
def test_exchange_reads_by_content(paired):
    """Three simulated hosts, reads repeated within and across hosts: each
    host's owned reads equal the JAX exchange's, every owned read hashes to
    its owner, and the owned sets are disjoint and cover every distinct
    read (pair)."""
    rng = np.random.default_rng(11)
    base, blens = _codes(rng, 60, 90, 30, 91)
    mbase, mlens = _codes(rng, 60, 70, 30, 71)
    pick = rng.integers(0, 60, 300)
    mat, lens = base[pick], blens[pick]
    mates = (mbase[pick], mlens[pick]) if paired else (None, None)
    n = 3

    def run_side(side, mh):
        def run(h, make):
            lo, hi = mh.host_record_range(len(pick), n, h)
            kw = {}
            if paired:
                kw = {"mate_mat": mates[0][lo:hi], "mate_lens": mates[1][lo:hi]}
            return mh.exchange_reads_by_content(
                mat[lo:hi], lens[lo:hi], n, h, allgather=make(h),
                local_seen=side.native.make_dedupe_set(), **kw)
        return _threaded_hosts(n, run)

    got = run_side(PORT, port_mh)
    want = run_side(JAX, jax_mh)
    keys = []
    for h, (g, w) in enumerate(zip(got, want)):
        assert not isinstance(g, Exception), g
        assert len(g) == (4 if paired else 2)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
        owner = port_mh._read_owner_hash(*g, n) if not paired else \
            port_mh._read_owner_hash(g[0], g[1], n, g[2], g[3])
        assert (owner == h).all()
        for i in range(len(g[1])):
            key = g[0][i, :g[1][i]].tobytes()
            if paired:
                key += b"|" + g[2][i, :g[3][i]].tobytes()
            keys.append((key, h))
    owners = {}
    for key, h in keys:
        assert owners.setdefault(key, h) == h, "a read has two owners"
    want_keys = {mat[i, :lens[i]].tobytes() + (
        b"|" + mates[0][i, :mates[1][i]].tobytes() if paired else b"")
        for i in range(len(pick))}
    assert set(owners) == want_keys


def test_merge_host_results_matches():
    rng = np.random.default_rng(3)
    names = [f"F{i}" for i in range(8)]
    per_host = [[(sorted(rng.choice(names, int(rng.integers(1, 4)),
                                    replace=False).tolist()),
                  (int(rng.integers(1, 50)), [], []))
                 for _ in range(30)] for _ in range(3)]
    blobs = [pickle.dumps([(tuple(cs), e[0]) for cs, e in res])
             for res in per_host]
    got = port_mh.merge_host_results(per_host[0],
                                     allgather_bytes=lambda p: blobs)
    want = jax_mh.merge_host_results(per_host[0],
                                     allgather_bytes=lambda p: blobs)
    assert got == want
    assert sum(e[0] for _cs, e in got) == sum(
        e[0] for res in per_host for _cs, e in res)


# --- real gloo processes --------------------------------------------------------

def _hosts(argvs, cwd, timeout=PROC_TIMEOUT_S, env_extra=None):
    """Start one process per argv (the host processes of one run), wait for
    them at most ``timeout`` seconds, kill what is left; returns
    (returncode, stdout, stderr) per process."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               **(env_extra or {}))
    procs = [subprocess.Popen(argv, cwd=str(cwd), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for argv in argvs]
    outs = [None] * len(procs)
    deadline = time.monotonic() + timeout
    try:
        for i, p in enumerate(procs):
            outs[i] = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a host process outlived its {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o[0], o[1]) for p, o in zip(procs, outs)]


_FASTQ_HOST = textwrap.dedent("""
    import datetime, pickle, sys
    from nimble_tpu_torch.config import LibraryChemistry
    from nimble_tpu_torch.index.build import build_index
    from nimble_tpu_torch.library import (get_reference_sequence_data,
                                          load_reference_library)
    from nimble_tpu_torch.models.aligner import TorchAlignEngine
    from nimble_tpu_torch.parallel import multihost
    rank, init, lib, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    inputs = sys.argv[5:]
    multihost.initialize(None, 2, rank, init_method="file://" + init,
                         timeout=datetime.timedelta(seconds=60))
    cfg, ref = load_reference_library(lib, LibraryChemistry.UNSTRANDED)
    engine = TorchAlignEngine(build_index(get_reference_sequence_data(ref)[0]),
                              cfg, device="cpu")
    merged = multihost.process_fastq_multihost(
        inputs[0], engine, ref, cfg, None,
        mate_path=inputs[1] if len(inputs) > 1 else None)
    multihost.shutdown()
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "nimble_tpu"))
    with open(out + str(rank), "wb") as f:
        pickle.dump(([(cs, e[0]) for cs, e in merged], leaked), f)
""")


def _jax_fastcounter_table(lib, inputs):
    """The JAX package's single-process FastCounter table."""
    from nimble_tpu.core.fast_count import FastCounter
    from nimble_tpu.io.fastq import read_fastq_matrix

    cfg, ref = JAX.load_reference_library(lib,
                                          JAX.LibraryChemistry.UNSTRANDED)
    engine = DeviceAlignEngine(
        JAX.build_index(JAX.get_reference_sequence_data(ref)[0]), cfg)
    counter = FastCounter(engine, ref, cfg)
    counter.add(*(m for path in inputs for m in read_fastq_matrix(path)))
    return [(cs, e[0]) for cs, e in counter.finalize()]


@pytest.mark.parametrize("paired", [False, True])
def test_two_gloo_processes_fastq_equal_jax_single_process(tmp_path, paired):
    wl = write_workload(str(tmp_path / "wl"), n_features=6, feat_len=300,
                        read_len=80, n_reads=900, seed=21, paired=paired,
                        mate_gap=50)
    out = str(tmp_path / "merged")
    runs = _hosts([[sys.executable, "-c", _FASTQ_HOST, str(r),
                    str(tmp_path / "init"), wl.library, out, *wl.inputs]
                   for r in range(2)], tmp_path)
    for rc, _o, err in runs:
        assert rc == 0, err[-3000:]
    tables = []
    for r in range(2):
        with open(out + str(r), "rb") as f:
            table, leaked = pickle.load(f)
        assert leaked == [], leaked[:5]
        tables.append(table)
    want = _jax_fastcounter_table(wl.library, wl.inputs)
    assert tables[0] == tables[1] == want
    assert sum(count for _cs, count in want) > 100


@pytest.fixture(scope="module")
def cli_workloads(tmp_path_factory):
    """A single-end and a paired FASTQ and a BAM, with the JAX package's
    single-process CLI output of each (decompressed for the BAM)."""
    d = tmp_path_factory.mktemp("cli_wl")
    cases = {
        "fastq": write_workload(str(d / "fq"), n_features=6, feat_len=300,
                                read_len=80, n_reads=700, seed=5),
        "paired": write_workload(str(d / "pe"), n_features=6, feat_len=300,
                                 read_len=80, n_reads=500, seed=6,
                                 paired=True, mate_gap=50),
        "bam": write_bam_workload(str(d / "bam"), n_features=6, feat_len=300,
                                  n_groups=96, seed=7),
    }
    want = {}
    for kind, wl in cases.items():
        out = str(d / f"jax_{kind}.tsv{'.gz' if kind == 'bam' else ''}")
        with contextlib.redirect_stdout(io.StringIO()):
            assert jax_main(["-r", wl.library, *sum((["-i", p] for p in
                                                     wl.inputs), []),
                             "-o", out, "-c", "2"]) == 0
        want[kind] = (gzip.open(out).read() if kind == "bam"
                      else open(out, "rb").read())
    return cases, want


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


@pytest.mark.parametrize("kind", ["fastq", "paired", "bam"])
@pytest.mark.parametrize("rendezvous", ["coordinator", "init-method"])
def test_cli_two_processes_equal_jax_cli(tmp_path, cli_workloads, kind,
                                         rendezvous):
    """The CLI's --num-processes / --process-id on two real processes: the
    output process 0 writes equals the JAX CLI's single-process output."""
    cases, want = cli_workloads
    wl = cases[kind]
    out = str(tmp_path / ("out.tsv.gz" if kind == "bam" else "out.tsv"))
    meet = (["--coordinator", f"127.0.0.1:{_free_port()}"]
            if rendezvous == "coordinator"
            else ["--init-method", f"file://{tmp_path / 'init'}"])
    argv = ["-r", wl.library, *sum((["-i", p] for p in wl.inputs), []),
            "-o", out, "-c", "2", "--device", "cpu", "--num-processes", "2",
            *meet]
    runs = _hosts([[sys.executable, "-m", "nimble_tpu_torch.cli", *argv,
                    "--process-id", str(r)] for r in range(2)], tmp_path,
                  env_extra={"NIMBLE_TIMING": "1"})
    for rc, stdout, err in runs:
        assert rc == 0, err[-3000:]
        assert "(multi-host)" in stdout
    got = gzip.open(out).read() if kind == "bam" else open(out, "rb").read()
    assert got == want[kind]
    assert got.count(b"\n") > (100 if kind == "bam" else 5)
    for host, (_rc, _o, err) in enumerate(runs):
        assert f"[multihost host {host}] " in err
    assert not [p for p in os.listdir(tmp_path) if ".part" in p]


_LOST_PEER = textwrap.dedent("""
    import datetime, sys, time
    from nimble_tpu_torch.parallel import multihost
    rank, init = int(sys.argv[1]), sys.argv[2]
    multihost.initialize(None, 2, rank, init_method="file://" + init,
                         timeout=datetime.timedelta(seconds=3))
    if rank == 1:
        time.sleep(60)  # never joins the collective
    t0 = time.monotonic()
    try:
        multihost.barrier()
    except RuntimeError as e:
        print(f"RAISED {time.monotonic() - t0:.1f}", flush=True)
        sys.exit(0)
    sys.exit(3)
""")


def test_lost_peer_raises_within_the_timeout(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _LOST_PEER, str(r), str(tmp_path / "init")],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        out, err = procs[0].communicate(timeout=PROC_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    assert procs[0].returncode == 0, err[-3000:]
    waited = float(out.split("RAISED")[1])
    assert 2.0 < waited < 30.0


# --- BAM: simulated hosts against the JAX process_fast ---------------------------

def _bam_inputs(side, bam, n_groups=12, junk=False):
    """The reference, index and config of ``tests/test_multihost.py``'s BAM
    workloads, built with ``side``'s loaders; writes the BAM with the JAX
    package's synthesizer when ``bam`` does not exist yet."""
    rng = np.random.default_rng(23 if junk else 17)
    n_feat = 2 if junk else 6
    feats = ["".join(rng.choice(list("ACGT"), size=220)) for _ in range(n_feat)]
    reads_from = (["".join(rng.choice(list("ACGT"), size=220))
                   for _ in range(2)] if junk else feats)
    doubled = [x for s in feats for x in (s, side.revcomp(s))]
    names = [n for i in range(n_feat) for n in (f"feat{i}", f"feat{i}§rev")]
    reference = side.Reference(
        group_on=0, headers=["sequence_name", "sequence"],
        columns=[names, doubled], sequence_name_idx=0, sequence_idx=1)
    cfg = side.AlignFilterConfig(
        reference_genome_size=2 * n_feat, score_percent=0.2,
        score_threshold=40, num_mismatches=0 if junk else 1,
        max_hits_to_report=8)
    if not os.path.exists(bam):
        from nimble_tpu.io.synth import make_synthetic_bam

        if junk:
            make_synthetic_bam(bam, reads_from, n_groups=4, pairs_per_group=2,
                               read_len=80, seed=23)
        else:
            make_synthetic_bam(bam, reads_from, n_groups=n_groups,
                               pairs_per_group=3, read_len=80, seed=17,
                               mutate_every=4)
    return reference, side.build_index(doubled), cfg


def _jax_process_fast(tmp_path, bam, quirks=True, junk=False):
    reference, index, cfg = _bam_inputs(JAX, bam, junk=junk)
    out = str(tmp_path / "jax_single.tsv.gz")
    with contextlib.redirect_stdout(io.StringIO()):
        JAX.bam_fast.process_fast([bam], [DeviceAlignEngine(index, cfg)],
                                  [reference], [cfg], [out], 2, False,
                                  parity_quirks=quirks)
    return gzip.open(out).read()


def _port_two_hosts(bam, out, quirks=True, junk=False):
    reference, index, cfg = _bam_inputs(PORT, bam, junk=junk)

    def run(h, make):
        with contextlib.redirect_stdout(io.StringIO()):
            port_mh.process_bam_multihost(
                bam, [TorchAlignEngine(index, cfg, device="cpu")],
                [reference], [cfg], [out], False, n_hosts=2, host_id=h,
                parity_quirks=quirks, batch_records=64,
                allgather_bytes=make(h))
    return _threaded_hosts(2, run)


@pytest.mark.parametrize("quirks", [True, False])
def test_simulated_two_host_bam_equals_jax_single(tmp_path, quirks):
    bam = str(tmp_path / "mh.bam")
    want = _jax_process_fast(tmp_path, bam, quirks)
    out = str(tmp_path / "mh.tsv.gz")
    assert _port_two_hosts(bam, out, quirks) == [None, None]
    got = gzip.open(out).read()
    assert got == want and got.count(b"\n") > 10
    assert not os.path.exists(out + ".part0")


def test_simulated_two_host_bam_empty_output(tmp_path):
    """Reads that hit nothing: the single-host pipeline's empty-content gzip
    (no rows, no header) in multi-host mode too."""
    bam = str(tmp_path / "junk.bam")
    want = _jax_process_fast(tmp_path, bam, junk=True)
    assert want == b""
    out = str(tmp_path / "mh.tsv.gz")
    assert _port_two_hosts(bam, out, junk=True) == [None, None]
    assert gzip.open(out).read() == want


def test_two_host_bam_ignores_stale_part_files(tmp_path):
    bam = str(tmp_path / "mh.bam")
    want = _jax_process_fast(tmp_path, bam)
    out = str(tmp_path / "mh.tsv.gz")
    for h in (0, 1):
        with gzip.open(f"{out}.part{h}", "wb") as f:
            f.write(b"STALE ROWS FROM A PREVIOUS RUN\n")
    assert _port_two_hosts(bam, out) == [None, None]
    got = gzip.open(out).read()
    assert b"STALE" not in got and got == want


def test_two_host_bam_peer_failure_aborts_merge(tmp_path, monkeypatch):
    """A host that fails during alignment: it raises its own error, the
    surviving host aborts with a RuntimeError instead of merging or
    deadlocking, and no merged output is written."""
    bam = str(tmp_path / "mh.bam")
    _bam_inputs(JAX, bam)
    real = PORT.bam_fast._finish_batch

    def flaky(ctx, workers, collected=None):
        if threading.current_thread().name == "mh-host-1":
            raise ValueError("injected device failure on host 1")
        return real(ctx, workers, collected)

    monkeypatch.setattr(PORT.bam_fast, "_finish_batch", flaky)
    out = str(tmp_path / "mh.tsv.gz")
    results = _port_two_hosts(bam, out)
    assert isinstance(results[1], ValueError)
    assert isinstance(results[0], RuntimeError)
    assert "failed" in str(results[0])
    assert not os.path.exists(out)


# --- refusals ----------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["process_fastq_multihost",
                                "process_bam_multihost"])
def test_world_that_does_not_span_the_hosts_raises(tmp_path, fn):
    """Two claimed hosts without a process group across them: raise, never
    count a share of the input in silence."""
    assert port_mh.process_count() == 1
    if fn == "process_fastq_multihost":
        call = lambda: port_mh.process_fastq_multihost(  # noqa: E731
            reads_path("basic.fastq"), None, None, None, None, n_hosts=2,
            host_id=0)
    else:
        call = lambda: port_mh.process_bam_multihost(  # noqa: E731
            "x.bam", [], [], [], [str(tmp_path / "o.tsv.gz")], False,
            n_hosts=2, host_id=0)
    with pytest.raises(RuntimeError, match="not initialized across"):
        call()


def test_world_of_one_process_claiming_two_raises(tmp_path):
    """A real gloo group of one process with --num-processes 2's claim."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=30))
    try:
        assert port_mh.process_count() == 1
        with pytest.raises(RuntimeError, match="1 process"):
            port_mh.process_fastq_multihost(
                reads_path("basic.fastq"), None, None, None, None,
                n_hosts=2, host_id=0)
    finally:
        port_mh.shutdown()


@pytest.mark.parametrize("extra,match", [
    (["--engine", "mesh"], "engine mesh cannot run"),
    (["--engine", "host"], "requires a device engine"),
    (["--engine", "host", "BAM"], "multi-host BAM mode requires the native"),
    (["--no-process-id"], "needs --process-id"),
    (["--no-coordinator"], "needs --coordinator"),
])
def test_cli_multihost_refusals(tmp_path, extra, match):
    argv = ["-r", library_path("basic.json"), "-o", str(tmp_path / "o.tsv"),
            "--device", "cpu", "--num-processes", "2"]
    argv += ["-i", "reads.bam"] if "BAM" in extra else [
        "-i", reads_path("basic.fastq")]
    if "--no-process-id" not in extra:
        argv += ["--process-id", "0"]
    if "--no-coordinator" not in extra:
        argv += ["--coordinator", "127.0.0.1:1"]
    argv += [a for a in extra if not a.startswith("--no-") and a != "BAM"]
    with pytest.raises(SystemExit, match=match):
        port_main(argv)
    assert not torch.distributed.is_initialized()


def test_jax_multihost_fastq_fails_with_the_host_engine():
    """What the JAX CLI does with --engine host and --num-processes > 1 on
    FASTQ: its FastCounter asks the host engine for the compact interface
    it lacks.  The port's CLI exits with a message instead (above)."""
    cfg, ref = JAX.load_reference_library(library_path("basic.json"),
                                          JAX.LibraryChemistry.NONE)
    engine = JAX.HostAlignEngine(
        JAX.build_index(JAX.get_reference_sequence_data(ref)[0]), cfg)

    def allgather(arrays):  # host 0 owns every read
        return [(*arrays[:-1], np.zeros_like(arrays[-1]))] * 2

    with pytest.raises(AttributeError, match="align_raw_compact"):
        jax_mh.process_fastq_multihost(
            reads_path("basic.fastq"), engine, ref, cfg, None, n_hosts=2,
            host_id=0, allgather=allgather,
            allgather_bytes=lambda payload: [payload, payload])


@pytest.mark.parametrize("local_rank,process_id,want", [("3", 0, 1),
                                                        (None, 3, 1),
                                                        (None, 0, 0)])
def test_cli_multihost_card_choice(tmp_path, monkeypatch, local_rank,
                                   process_id, want):
    """With --device cuda, host process I takes card LOCAL_RANK % cards, or
    I % cards without LOCAL_RANK (two cards faked; the run stops at the
    rendezvous)."""
    chosen = []

    class Stop(Exception):
        pass

    def initialize(*a, **k):
        raise Stop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    monkeypatch.setattr(port_mh, "initialize", initialize)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    with pytest.raises(Stop):
        port_main(["-r", library_path("basic.json"), "-i",
                   reads_path("basic.fastq"), "-o", str(tmp_path / "o.tsv"),
                   "--num-processes", "4", "--process-id", str(process_id),
                   "--coordinator", "127.0.0.1:1"])
    assert chosen == [torch.device("cuda", want)]
