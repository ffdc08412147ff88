"""What the host did in each pass of the window, beside its wall time.

The card is idle most of a pass: the host sets the pace, and the host's
cores are shared.  Around each pass the harness reads the process's CPU
seconds and involuntary context switches (``getrusage``), and after each
pass it times a fixed piece of pure-Python work (:func:`probe_s`), which
says how fast a core of the host ran just then.  From them
:func:`summary` says how a pass's wall time moved with its own CPU time
and with the probe.  None of it is a metric; it is printed on standard
error and kept, one line a pass, in the run's work directory.
"""

from __future__ import annotations

import resource
import time
from typing import List, Optional

FIELDS = ("wall_s", "cpu_s", "nivcsw", "probe_s")
PROBE_STEPS = 200_000  # some milliseconds of one core


def sample() -> tuple:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return (time.perf_counter(), ru.ru_utime + ru.ru_stime, ru.ru_nivcsw)


def probe_s() -> float:
    """Seconds a core takes for the same pure-Python loop every time."""
    t = time.perf_counter()
    x = 0
    for i in range(PROBE_STEPS):
        x ^= i
    return time.perf_counter() - t


def between(a: tuple, b: tuple) -> dict:
    """The pass between two samples."""
    return {"wall_s": b[0] - a[0], "cpu_s": b[1] - a[1],
            "nivcsw": b[2] - a[2], "probe_s": None}


def _corr(x: list, y: list) -> Optional[float]:
    n = len(x)
    if n < 3:
        return None
    mx, my = sum(x) / n, sum(y) / n
    sxy = sum((a - mx) * (b - my) for a, b in zip(x, y))
    sxx = sum((a - mx) ** 2 for a in x)
    syy = sum((b - my) ** 2 for b in y)
    return sxy / (sxx * syy) ** 0.5 if sxx > 0 and syy > 0 else None


def summary(passes: List[dict]) -> dict:
    """The window's totals and how pass wall time moved with the rest."""
    wall = [p["wall_s"] for p in passes]
    cpu = [p["cpu_s"] for p in passes]
    out = {"cpu_per_wall": sum(cpu) / sum(wall) if sum(wall) else None,
           "nivcsw": sum(p["nivcsw"] for p in passes),
           "r_wall_cpu": _corr(wall, cpu)}
    probe = [p["probe_s"] for p in passes]
    if None not in probe and passes:
        out["probe_s_median"] = sorted(probe)[len(probe) // 2]
        out["r_wall_probe"] = _corr(wall, probe)
    return out


def write(path: str, passes: List[dict]) -> None:
    with open(path, "w", encoding="ascii") as f:
        f.write("\t".join(FIELDS) + "\n")
        for p in passes:
            f.write("\t".join("" if p[k] is None else f"{p[k]:.6g}"
                              for k in FIELDS) + "\n")
