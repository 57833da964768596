"""The port's copy of the paper's §VII analytic model
(``repro_torch.core.commsim``) against the reference's
(``repro.core.commsim``): ``calibrate``, ``predict`` for every system and
``default_topology`` equal as Python floats, over the configurations
``benchmarks/table3_breakdown.py`` and ``benchmarks/fig8_speedup.py``
evaluate (the three paper models at 2-16 experts, the paper's rates),
and the hierarchical and overlap systems over topologies and chunk
counts; the paper's tables are the same data."""
import dataclasses

import pytest

from repro.comm.topology import Topology as JTopology
from repro.configs import get_config as jget_config
from repro.core import commsim as jsim

from repro_torch.comm.topology import Topology
from repro_torch.configs import get_config
from repro_torch.core import commsim as tsim

SYSTEMS = ("vanilla", "luffy", "ext", "hyt", "vanilla-hier", "luffy-hier",
           "vanilla-overlap", "luffy-overlap")


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert type(a[k]) is type(b[k]) and a[k] == b[k], (k, a[k], b[k])


def test_tables_equal():
    for name in ("PAPER_VANILLA", "PAPER_TABLE3", "PAPER_RATES", "BYTES"):
        assert getattr(tsim, name) == getattr(jsim, name), name


@pytest.mark.parametrize("model", list(jsim.PAPER_VANILLA))
@pytest.mark.parametrize("E", [2, 4, 8, 16])
def test_calibrate_and_predict_equal(model, E):
    tcfg, jcfg = get_config(model, num_experts=E), \
        jget_config(model, num_experts=E)
    ts, js = tsim.PaperSetup(cfg=tcfg), jsim.PaperSetup(cfg=jcfg)
    assert ts.tokens == js.tokens
    vc, vm = jsim.PAPER_VANILLA[model][E]
    tc, jc = tsim.calibrate(ts, vc, vm), jsim.calibrate(js, vc, vm)
    assert dataclasses.astuple(tc) == dataclasses.astuple(jc)
    assert tsim.expert_bytes(tcfg) == jsim.expert_bytes(jcfg)
    rates = jsim.PAPER_RATES[model]
    for system in SYSTEMS:
        kw = rates if "luffy" in system else {}
        _same(tsim.predict(ts, tc, system=system, **kw),
              jsim.predict(js, jc, system=system, **kw))
    for nodes, ratio, chunks in ((2, 4.0, None), (2, 2.5, 3), (4, 8.0, 1)):
        tt = tsim.default_topology(E, nodes, ratio)
        jt = jsim.default_topology(E, nodes, ratio)
        assert dataclasses.astuple(tt) == dataclasses.astuple(jt)
        for system in ("luffy-hier", "luffy-overlap", "vanilla-overlap"):
            _same(tsim.predict(ts, tc, system=system, topo=tt,
                               chunks=chunks, **rates),
                  jsim.predict(js, jc, system=system, topo=jt,
                               chunks=chunks, **rates))
    # an explicit topology of the port's own type
    t2, j2 = Topology(2, E // 2 or 1), JTopology(2, E // 2 or 1)
    _same(tsim.predict(ts, tc, system="vanilla-hier", topo=t2),
          jsim.predict(js, jc, system="vanilla-hier", topo=j2))
    with pytest.raises(ValueError):
        tsim.predict(ts, tc, system="nope")
