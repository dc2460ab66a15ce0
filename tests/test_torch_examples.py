"""The port's example twins on the CPU against the reference examples.

``repro_torch.examples.quickstart --device cpu`` prints the numbers of the
reference quickstart's steps 1-4 (a product, the exhaustive metrics, the
t sweep, the GEMM's relative error); ``accuracy_sweep --device cpu``
prints the reference's ``exhaustive_eval(8, t)`` ER and NMED at each t and
finite losses.
"""

from __future__ import annotations

import math
import pathlib
import runpy

import pytest

torch = pytest.importorskip("torch")

from repro.core import error_metrics as jax_error_metrics
from repro.engine.config import ripple_delay, segmented_delay
from repro_torch.examples import accuracy_sweep, quickstart

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_quickstart_prints_the_reference_numbers(capsys):
    runpy.run_path(str(ROOT / "examples" / "quickstart.py"), run_name="__main__")
    want = capsys.readouterr().out.splitlines()
    quickstart.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 9
    # steps 1-3 line for line, step 4's modes and relative error
    assert got[:6] == want[:6]
    assert got[6].split("  backends")[0] == want[6].split("  backends")[0]
    assert got[7] == want[7]
    assert got[8].startswith("elementwise approximate products on cpu: shape=(8, 128), "
                             "dtype=torch.uint32, bit-equal to the reference body=True")


def test_accuracy_sweep_error_columns_equal_the_reference(capsys):
    accuracy_sweep.main(["--steps", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("trained exact model: loss=")
    rows = [ln.split() for ln in lines[lines.index(next(ln for ln in lines if "eval_loss" in ln))
                                          + 1:]]
    assert [r[0] for r in rows] == ["exact"] + [str(t) for t in range(1, 8)]
    for row in rows:
        assert math.isfinite(float(row[4]))
    for row in rows[1:]:
        t = int(row[0])
        rep = jax_error_metrics.exhaustive_eval(8, t)
        assert row[1] == f"{rep.er:7.3f}".strip() and row[2] == f"{rep.nmed:10.2e}".strip()
        assert row[3] == f"{100 * (1 - segmented_delay(8, t) / ripple_delay(8)):13.1f}".strip()
