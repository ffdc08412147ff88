"""The host's readings beside each pass: what two samples say, and the
window's summary."""

import pytest

from portbench import hostload


def test_between_reads_the_process():
    got = hostload.between((10.0, 3.0, 7), (11.5, 5.0, 9))
    assert got == {"wall_s": 1.5, "cpu_s": 2.0, "nivcsw": 2, "probe_s": None}


def test_summary_correlates_wall_with_the_probe(tmp_path):
    passes = [{"wall_s": w, "cpu_s": 0.5, "nivcsw": 1, "probe_s": 0.005 * w}
              for w in (1.0, 1.2, 1.4, 1.1)]
    s = hostload.summary(passes)
    assert s["r_wall_probe"] == pytest.approx(1.0)
    assert s["probe_s_median"] == pytest.approx(0.006)
    assert s["r_wall_cpu"] is None  # the process's CPU time never moved
    assert s["cpu_per_wall"] == pytest.approx(2.0 / 4.7)
    hostload.write(str(tmp_path / "host.tsv"), passes)
    lines = (tmp_path / "host.tsv").read_text().splitlines()
    assert lines[0].split("\t") == list(hostload.FIELDS) and len(lines) == 5


def test_without_probes_only_the_process_is_summed():
    s = hostload.summary([hostload.between((0.0, 0.0, 0), (2.0, 1.0, 3))] * 3)
    assert s["cpu_per_wall"] == 0.5 and s["nivcsw"] == 9
    assert "probe_s_median" not in s


def test_the_probe_takes_a_few_milliseconds():
    assert 0 < hostload.probe_s() < 0.5
