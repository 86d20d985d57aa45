"""The check's control and planted faults, at a size a CPU test holds:
each comes out not correct under the cells' own limits. At the cells' own
sizes they are read on the card (``python -m benchmark.control``;
``test_harness_card.py``)."""

import pytest

from benchmark import control
from benchmark.tests.tiny import CELL, tiny_registry


@pytest.mark.parametrize("traffic", ["dyn", "noheur"])
def test_control_and_faults_fail(tmp_path, traffic):
    kw = (dict(taxa=256, sites=600, span=(300, 450), sample=8)
          if traffic == "dyn" else
          dict(taxa=16, sites=500, span=(300, 450), sample=8))
    reg = tiny_registry(tmp_path, traffic=traffic, **kw)
    rows = control.readings(reg, CELL, 2 ** 31 + 3, "cpu")
    got = {r["variant"]: r for r in rows[1:]}
    assert set(got) == {"tf32", "unchanged", "altered", "top_row",
                        "drop_second"}
    for v, r in got.items():
        assert not r["correct"], (v, r)
    assert got["tf32"]["logl_err"] > got["tf32"]["limits"]["logl_err"]
    assert got["unchanged"]["opt_gap"] > got["unchanged"]["limits"]["opt_gap"]
    assert got["top_row"]["rows_off"] > got["top_row"]["limits"]["rows_off"]
