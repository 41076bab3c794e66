"""The host's probe and the cores each rank keeps to, and the sweep
probe's record of the traced sweeps that kernel A's roofline sums."""

from __future__ import annotations

import types

import pytest
import torch

from ilpbench import host
from ilpbench.driver import SweepProbe


@pytest.mark.parametrize("world,n", [(1, 8), (4, 32), (4, 4), (1, 1)])
def test_each_rank_keeps_to_cores_of_its_own(world, n):
    cores = list(range(n))
    mine = [host.cores_for(r, world, cores) for r in range(world)]
    assert all(m and set(m) <= set(cores) for m in mine)
    assert len({c for m in mine for c in m}) == sum(map(len, mine))
    assert mine[0][-1] == n - 1


def test_the_report_names_the_cores_and_times_the_probe():
    out = host.report()
    assert out["probe_ms"] > 0 and out["cores"] == host.all_cores()


def test_the_probe_records_only_the_traced_sweeps():
    calls = []

    def sweep(*a, **kw):
        calls.append(a)
        return a[1:5]

    mod = types.SimpleNamespace(psweep=sweep)
    args = lambda i: (None, i, i, i, i, torch.tensor([[i > 0]]), torch.tensor([i]))  # noqa: E731
    with SweepProbe(mod, "psweep") as probe:
        mod.psweep(*args(0), n_rows=0)
        probe.recording = True
        for i in (1, 2, 3):
            mod.psweep(*args(i), n_rows=i)
        probe.recording = False
        mod.psweep(*args(4), n_rows=4)
    assert mod.psweep is sweep and probe.calls == 5 and len(calls) == 5
    assert [int(st["order"]) for st in probe.traced] == [1, 2, 3]
    assert [st["n_rows"] for st in probe.traced] == [1, 2, 3]
