"""The port's command line, observers and CSV suite runner, on the CPU
(``--device cpu``): the cases of tests/test_cli.py, tests/test_observer.py
and tests/test_bench_harness.py against ``baryonyx_torch``."""

import csv
import os

import numpy as np
import pytest
import torch

import baryonyx_torch as bt
from baryonyx_torch.bench.harness import BenchData, benchmark
from baryonyx_torch.cli import assign_parameter, main
from baryonyx_torch.core.params import ConstraintOrder, ObserverType, SolverParameters
from baryonyx_torch.generators import (
    n_queens_lp,
    random_assignment_lp,
    random_set_cover_lp,
)
from baryonyx_torch.observer import (
    FileObserver,
    NoneObserver,
    PnmObserver,
    make_observer,
    write_pnm,
)

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Eager torch ops on these small tensors gain nothing from threads,
    and the test workers share the machine's cores: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_assign_parameter_scalars():
    p = SolverParameters()
    assert assign_parameter(p, "theta", "0.3")
    assert p.theta == 0.3
    assert assign_parameter(p, "kappa-step", "0.01")
    assert p.kappa_step == 0.01
    assert assign_parameter(p, "limit", "123")
    assert p.limit == 123
    assert not assign_parameter(p, "theta", "zzz")
    assert not assign_parameter(p, "unknown-param", "1")


def test_assign_parameter_enums():
    p = SolverParameters()
    assert assign_parameter(p, "constraint-order", "random-sorting")
    assert p.order == ConstraintOrder.random_sorting
    assert not assign_parameter(p, "constraint-order", "bogus")
    assert assign_parameter(p, "floating-point-type", "double")
    assert p.float_type == bt.FloatType.float64


def _model(tmp_path, text=None):
    lp = tmp_path / "model.lp"
    lp.write_text(text or n_queens_lp(6))
    return lp


SOLVE = ["--quiet", "-p", "limit:2000", "-p", "seed:42", "-p", "pushes-limit:2"]


def test_cli_solve_writes_sol(tmp_path, monkeypatch):
    lp = _model(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert main(CPU + SOLVE + [str(lp)]) == 0
    sols = list(tmp_path.glob("model.lp-*.sol"))
    assert len(sols) == 1
    text = sols[0].read_text()
    assert text.startswith("\\ solver..........: baryonyx-torch ")
    assert "\\ solver................: solve\n" in text  # the loop ran
    # the .sol round-trips through the result reader and validates
    res = bt.make_result(bt.make_context(0), str(sols[0]))
    assert bt.is_valid_solution(bt.parse_lp(lp.read_text()), res)


def test_cli_check(tmp_path, monkeypatch, capsys):
    lp = _model(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert main(CPU + SOLVE + [str(lp)]) == 0
    sol = next(tmp_path.glob("model.lp-*.sol"))
    assert main(["--quiet", "--check", str(sol), str(lp)]) == 0
    out = capsys.readouterr().out
    assert "valid" in out and "INVALID" not in out
    assert "objective: 6.0" in out


def test_cli_optimize_and_limit_options(tmp_path, monkeypatch):
    lp = _model(tmp_path, random_set_cover_lp(30, 90, 0.08, seed=2))
    monkeypatch.chdir(tmp_path)
    rc = main(CPU + ["--quiet", "--optimize", "--limit", "40", "--seed", "3",
                     "-p", "thread:8", str(lp)])
    assert rc == 0
    sol = next(tmp_path.glob("model.lp-*.sol"))
    assert "\\ solver................: optimize\n" in sol.read_text()
    loop = [l for l in sol.read_text().splitlines() if l.startswith("\\ loop")]
    assert int(loop[0].split(":")[1]) >= 40  # whole chunks of sweeps


def test_cli_random_and_time_limit(tmp_path, monkeypatch):
    lp = _model(tmp_path, random_set_cover_lp(30, 90, 0.08, seed=2))
    monkeypatch.chdir(tmp_path)
    rc = main(CPU + ["--quiet", "--random", "--limit", "20", "--time-limit", "5",
                     "--seed", "3", str(lp)])
    assert rc in (0, 1)  # a random fill may or may not land on a cover
    assert len(list(tmp_path.glob("model.lp-*.sol"))) == 1


def test_cli_multiple_files_append_res(tmp_path, monkeypatch):
    a = _model(tmp_path)
    b = tmp_path / "b.lp"
    b.write_text(random_assignment_lp(3, seed=5))
    monkeypatch.chdir(tmp_path)
    assert main(CPU + SOLVE + [str(a), str(b)]) == 0
    res = list(tmp_path.glob("baryonyx-*.res"))
    assert len(res) == 1
    lines = res[0].read_text().splitlines()
    assert len(lines) == 2 and all(" success " in l for l in lines)
    assert list(tmp_path.glob("*.sol")) == []


def test_cli_unknown_option():
    assert main(["--frobnicate"]) == 1


def test_cli_no_files():
    assert main(["--quiet"]) == 1


def test_cli_bad_parameter(capsys):
    assert main(["-p", "theta:zzz", "x.lp"]) == 1
    assert "bad parameter" in capsys.readouterr().err


def test_cli_runs_on_the_card_unless_told(tmp_path, monkeypatch):
    """No --device: the first CUDA device, and an error without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lp = _model(tmp_path)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(SOLVE + [str(lp)])
    assert list(tmp_path.glob("*.sol")) == []


def test_cli_auto_modes_say_they_are_not_available(tmp_path, monkeypatch, capsys):
    """The meta modes run (the manual grid's 3,125 combos in one chunk of
    as many replicas); an unknown one is refused."""
    lp = _model(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert main(CPU + ["--quiet", "--auto:manual", "-p", "thread:3125",
                       "-p", "chunk-size:2", "--time-limit", "1", "--seed",
                       "3", str(lp)]) == 0
    sols = list(tmp_path.glob("model.lp-*.sol"))
    assert len(sols) == 1
    pb = bt.parse_lp(lp.read_text())
    assert bt.is_valid_solution(pb, bt.make_result(bt.make_context(0), str(sols[0])))
    assert main(CPU + ["--quiet", "--auto:bogus", str(lp)]) == 1
    assert "unknown auto mode" in capsys.readouterr().err


def test_cli_verbose_echoes_parameters(tmp_path, monkeypatch, capsys):
    lp = _model(tmp_path, random_assignment_lp(3, seed=5))
    monkeypatch.chdir(tmp_path)
    assert main(CPU + ["-p", "seed:42", str(lp)]) == 0
    out = capsys.readouterr().out
    assert "Solver starts" in out and "  - kappa: 0 0.001 0.6" in out
    assert "- Solver finished: success" in out and "Checked: True" in out


def test_parameter_echo_matches_reference_layout():
    from baryonyx_torch.core.out import format_parameters, format_result_line
    from baryonyx_torch.core.params import ModeType
    from baryonyx_torch.core.result import Result, ResultStatus, Solution

    out = format_parameters(SolverParameters())
    for line in (
        "Solver starts", " * Global parameters:", "  - limit: 1000",
        "  - floating-point-type: float", "  - auto-tune: disabled",
        " * In The Middle parameters:", "  - kappa: 0 0.001 0.6",
        "  - norm: loo", " * Pushes system parameters:",
        " * Solver initialization parameters:",
        "  - init-policy: bastert",
        " * Optimizer initialization parameters:",
    ):
        assert line in out, line

    p = SolverParameters()
    p.mode = ModeType.nlopt | ModeType.branch
    assert "auto-tune: nlopt-and-branch" in format_parameters(p)

    r = Result(status=ResultStatus.success, loop=42, duration=1.5)
    r.solutions.append(Solution([1, 0], 7.0))
    assert format_result_line(r) == "Best solution found: 7 in 42 loop and 1.5s\n"
    r2 = Result(
        status=ResultStatus.time_limit_reached, remaining_constraints=3,
        duration=2.0,
    )
    assert "Constraint remaining: 3. Time limit reached" in format_result_line(r2)


def test_cli_warmup_no_sol(tmp_path, monkeypatch):
    lp = _model(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert main(CPU + ["--quiet", "--warmup", "-p", "seed:42", str(lp)]) == 0
    assert list(tmp_path.glob("model.lp-*.sol")) == []


def test_cli_debug_writes_the_row_trace(tmp_path, monkeypatch):
    lp = _model(tmp_path)
    monkeypatch.chdir(tmp_path)
    main(CPU + ["--quiet", "--debug", "--limit", "20", "-p", "seed:42",
                "-p", "pushes-limit:0", str(lp)])
    assert list(tmp_path.glob("baryonyx-debug-*.log"))


def test_module_entry_point(tmp_path):
    import subprocess
    import sys
    from pathlib import Path

    lp = _model(tmp_path, random_assignment_lp(3, seed=5))
    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, "-m", "baryonyx_torch", "--quiet", "--device", "cpu",
         str(lp)],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(repo)),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert len(list(tmp_path.glob("model.lp-*.sol"))) == 1


# ---------------------------------------------------------------------------
# observers
# ---------------------------------------------------------------------------


def test_write_pnm_roundtrip(tmp_path):
    rgb = np.zeros((4, 6, 3), np.uint8)
    rgb[1, 2] = (255, 0, 7)
    path = str(tmp_path / "img.pnm")
    write_pnm(path, rgb)
    with open(path, "rb") as fh:
        data = fh.read()
    assert data.startswith(b"P6\n6 4\n255\n")
    body = data[len(b"P6\n6 4\n255\n"):]
    assert np.array_equal(np.frombuffer(body, np.uint8).reshape(4, 6, 3), rgb)


def test_pnm_observer_writes_files(tmp_path):
    obs = PnmObserver("trace", str(tmp_path))
    P = np.linspace(-1, 1, 12).reshape(3, 4)
    pi = np.array([0.5, -0.5, 0.0])
    obs.make_observation(P, pi, loop=0)
    obs.make_observation(P * 2, pi, loop=1)
    assert sorted(os.listdir(tmp_path)) == [
        "trace-P-000000.pnm",
        "trace-P-000001.pnm",
        "trace-pi-000000.pnm",
        "trace-pi-000001.pnm",
    ]


def test_file_observer_writes_parsable_text(tmp_path):
    obs = FileObserver("trace", str(tmp_path))
    P = np.arange(6, dtype=float).reshape(2, 3)
    pi = np.array([1.5, -2.25])
    obs.make_observation(P, pi, loop=0)
    assert np.allclose(np.loadtxt(tmp_path / "trace-P-000000.txt"), P)
    assert np.allclose(np.loadtxt(tmp_path / "trace-pi-000000.txt"), pi)


def test_make_observer_dispatch():
    assert isinstance(make_observer(ObserverType.pnm), PnmObserver)
    assert isinstance(make_observer(ObserverType.file), FileObserver)
    assert isinstance(make_observer(ObserverType.none), NoneObserver)


@pytest.mark.parametrize("kind", ["pnm", "file"])
def test_solve_with_observer_dumps(tmp_path, monkeypatch, kind):
    monkeypatch.chdir(tmp_path)
    pb = bt.parse_lp(random_set_cover_lp(8, 24, 0.3, seed=2))
    ctx = bt.make_context(0)
    ctx.parameters.observer = ObserverType[kind]
    ctx.parameters.limit = 30
    ctx.parameters.seed = 3
    ctx.parameters.time_limit = 5.0
    ctx.parameters.pushes_limit = 1
    r = bt.solve(ctx, pb, device="cpu")
    assert r.method == "solve"  # an observed run is never enumerated
    ext = ".pnm" if kind == "pnm" else ".txt"
    assert [f for f in os.listdir(tmp_path) if f.endswith(ext)]


# ---------------------------------------------------------------------------
# the CSV suite runner behind --bench
# ---------------------------------------------------------------------------


def _write_suite(tmp_path):
    (tmp_path / "cover1.lp").write_text(
        random_set_cover_lp(12, 40, density=0.2, seed=3)
    )
    (tmp_path / "assign1.lp").write_text(random_assignment_lp(3, seed=4))
    csv_path = tmp_path / "suite.csv"
    csv_path.write_text(
        "file,optimum,other-solver\n"
        "cover1,10,12\n"
        "assign1,50,inf\n"
        "missing-model,1,2\n"
    )
    return str(csv_path)


def _bench_ctx():
    ctx = bt.make_context(0)
    ctx.parameters.time_limit = 2.0
    ctx.parameters.limit = 200
    ctx.parameters.thread = 8
    ctx.parameters.seed = 11
    return ctx


def test_benchmark_appends_column_and_stats(tmp_path):
    csv_path = _write_suite(tmp_path)
    assert benchmark(_bench_ctx(), csv_path, "bx-test", device="cpu") == 0

    data = BenchData.load(csv_path)
    assert data.header == ["file", "optimum", "other-solver", "bx-test"]
    rows = {r[0]: r for r in data.rows}
    assert float(rows["cover1"][3]) > 0
    assert float(rows["assign1"][3]) > 0
    assert rows["missing-model"][3] == "inf"

    stats_path = os.path.splitext(csv_path)[0] + "-stats.csv"
    with open(stats_path) as fh:
        stats = [row for row in csv.reader(fh) if row]
    assert stats[0] == ["model", "other-solver", "bx-test"]
    labels = [r[0] for r in stats]
    assert "mean-rank" in labels and "final-rank" in labels
    final = stats[labels.index("final-rank")][1:]
    assert sorted(final) == ["1", "2"]


def test_benchmark_duplicate_column_gets_suffix(tmp_path):
    csv_path = _write_suite(tmp_path)
    assert benchmark(_bench_ctx(), csv_path, "other-solver", device="cpu") == 0
    assert BenchData.load(csv_path).header[-1] == "other-solver-2"


def test_cli_bench_option(tmp_path):
    csv_path = _write_suite(tmp_path)
    rc = main(CPU + ["--quiet", "--bench", csv_path, "--name", "run1",
                     "--time-limit", "1", "-p", "thread:8", "--seed", "2"])
    assert rc == 0
    assert BenchData.load(csv_path).header[-1] == "run1"
