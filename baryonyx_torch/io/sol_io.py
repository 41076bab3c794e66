""".sol result-file reader/writer.

Format (reference: result.hpp:156-224 writer, result.cpp:77-123 reader):
``\\``-prefixed comment lines carrying metadata, then one ``name=0|1`` line
per variable (preprocessor-fixed variables first).
"""

from __future__ import annotations

from typing import TextIO, Union

from baryonyx_torch.core.context import Context
from baryonyx_torch.core.errors import FileFormatError
from baryonyx_torch.core.result import Result, ResultStatus, Solution


def problem_resume(pb) -> str:
    """Problem-statistics comment block written at the top of .sol files
    (reference: app/src/main.cpp:1046-1079 `resume(raw_problem&, ostream&)`
    via lib/src/resume.hpp)."""
    real = sum(1 for v in pb.vars.values if v.type.name == "real")
    binary = sum(1 for v in pb.vars.values if v.type.name == "binary")
    general = sum(1 for v in pb.vars.values if v.type.name == "general")
    mode = "quadratic" if pb.objective.qelements else "linear"
    obj = "maximize" if pb.type.name == "maximize" else "minimize"
    return (
        f"\\ objective : {obj}\n"
        f"\\ mode: {mode}\n"
        f"\\ variables: {real}/{general}/{binary} (real/general/binary)\n"
        f"\\ constraints: {len(pb.equal_constraints)}/"
        f"{len(pb.greater_constraints)}/{len(pb.less_constraints)}"
        " (equal/greater/less)\n"
    )


def write_result(res: Result, out: Union[TextIO, None] = None) -> str:
    """Serialize a result the way the reference's fmt::formatter does
    (reference: result.hpp:156-224)."""
    import io

    buf = io.StringIO()
    buf.write(f"\\ solver................: {res.method}\n")
    buf.write(f"\\ constraints...........: {res.constraints}\n")
    buf.write(f"\\ variables.............: {res.variables}\n")
    buf.write(f"\\ duration..............: {res.duration}s\n")
    buf.write(f"\\ loop..................: {res.loop}\n")
    buf.write(f"\\ status................: {res.status.name}\n")

    if res.status == ResultStatus.success and res.solutions:
        buf.write(f"\\ value.................: {res.solutions[-1].value:.10g}\n")
        if len(res.solutions) > 1:
            buf.write("\\ other value...........: ")
            for sol in res.solutions:
                buf.write(f"{sol.value:.10g} ")
            buf.write("\n")
        buf.write("\\ variables.............: \n")
        for name, value in zip(res.affected_vars.names, res.affected_vars.values):
            buf.write(f"{name}={1 if value else 0}\n")
        for name, value in zip(res.variable_name, res.solutions[-1].variables):
            buf.write(f"{name}={1 if value else 0}\n")
        if len(res.derived_vars):
            vals = res.solution_map()
            for name in res.derived_vars.names:
                buf.write(f"{name}={vals[name]}\n")
    elif res.status in (
        ResultStatus.time_limit_reached,
        ResultStatus.kappa_max_reached,
        ResultStatus.limit_reached,
    ):
        buf.write(f"\\ remaining constraints.: {res.remaining_constraints}\n")

    text = buf.getvalue()
    if out is not None:
        out.write(text)
    return text


def read_result(source) -> Result:
    """Parse a .sol file (reference: result.cpp:77-123)."""
    if hasattr(source, "read"):
        text = source.read()
    else:
        with open(source, "r") as fh:
            text = fh.read()

    ret = Result(status=ResultStatus.success)
    ret.solutions.append(Solution())
    for lineno, line in enumerate(text.splitlines()):
        stripped = line.lstrip()
        if not stripped:
            continue
        if stripped.startswith("\\"):
            continue
        if "=" not in line:
            raise FileFormatError("bad name", lineno, 0)
        left, _, right = line.partition("=")
        try:
            value = int(right.strip().split()[0])
        except (ValueError, IndexError):
            raise FileFormatError("bad value", lineno, 0)
        ret.variable_name.append(left.strip())
        ret.solutions[-1].variables.append(1 if value else 0)
    return ret


def make_result(ctx: Context, filename: str) -> Result:
    """reference: result.cpp:36-48."""
    ctx.info("solution reads from file {}\n", filename)
    return read_result(filename)
