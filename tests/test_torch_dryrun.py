"""The port's ``entry.dryrun_multichip`` on spawned CPU ranks (gloo).

It must run each check the JAX dry run runs for the same ``n`` and print
its ``OK`` and ``SKIPPED`` lines in the JAX function's order. The JAX
function itself is not run here (its own test is ``slow``); its layout and
its guards (``__graft_entry__.py:179-238``, ``:327-400``) are written out
below and held against :func:`entry.dryrun_plan` for every ``n`` up to 16.
"""
import math
import re

import pytest

from petastorm_tpu_torch import entry


def _jax_guards(n):
    """``__graft_entry__._dryrun_impl``'s choices for ``n`` devices: the
    ``(data, seq, model)`` sizes and the checks it prints, in order."""
    if n % 8 == 0:
        dp, sp, tp = 2, 2, n // 4
    elif n % 4 == 0:
        dp, sp, tp = 1, 2, n // 2
    elif n % 2 == 0:
        dp, sp, tp = 1, 2, n // 2
    else:
        dp, sp, tp = 1, 1, n
    if tp > 1 and (8 % tp or 4 % tp):
        g = math.gcd(tp, 4)
        dp, tp = dp * (tp // g), g
    checks = ["store"]
    ok_ulysses = sp > 1 and (8 // max(tp, 1)) % sp == 0 and (4 // max(tp, 1)) % sp == 0
    if not ok_ulysses:
        checks.append("ulysses SKIPPED")
    checks += ["ring", "ring-flash"] + (["ulysses"] if ok_ulysses else []) + ["fsdp", "switch"]
    pp = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    checks += ["pp f32", "pp bf16"] if pp > 1 else ["pp SKIPPED"]
    return (dp, sp, tp), (pp, n // pp), checks


def _label(line):
    """The check a printed line reports."""
    if "fed from petastorm store" in line:
        return "store"
    name = re.match(r"dryrun_multichip\(\d+\): (\S+)", line).group(1)
    if line.endswith("SKIPPED") or " SKIPPED " in line:
        return f"{name} SKIPPED"
    assert line.endswith("OK"), line
    if name.startswith("pp"):
        return "pp f32" if " f32 " in line else "pp bf16"
    return {"fsdp(zero-3)": "fsdp", "switch-moe": "switch"}.get(name, name)


@pytest.mark.parametrize("n", range(1, 17))
def test_plan_is_the_jax_dry_runs(n):
    mesh, pipe, checks = _jax_guards(n)
    plan = entry.dryrun_plan(n)
    assert plan["mesh"] == mesh and plan["pipe"] == pipe
    assert [c for c in checks if c in ("ring", "ring-flash", "ulysses")] == plan["strategies"]
    assert [_label(line) for line in plan["skipped"]] == \
        [c for c in checks if c == "ulysses SKIPPED"]


@pytest.mark.parametrize("n", [4, 8, 1])
def test_dryrun_prints_the_jax_checks_in_order(n, capsys):
    result = entry.dryrun_multichip(n, device="cpu")
    lines = result["lines"]
    assert capsys.readouterr().out.splitlines() == lines
    assert result["launches"] == {}   # CPU tensors take the plain versions
    assert [_label(line) for line in lines] == _jax_guards(n)[2]


def test_dryrun_raises_on_a_failed_bar(monkeypatch):
    # A bar of 0 fails even a loss equal to its reference.
    monkeypatch.setitem(entry.DRYRUN_BARS, "pp_f32", 0.0)
    with pytest.raises(Exception, match="pipelined llama f32"):
        entry.dryrun_multichip(2, device="cpu")
