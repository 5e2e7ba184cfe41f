"""The port's numpy cost models against the reference's, exactly.

``repro_torch.core.{workloads,simulator,area_power}`` are copies of the
reference's numpy modules, and the router's ``replica_cost`` reads
them; ``autotune.objectives.analytic_proxy`` is the accuracy axis both
share. Every result here is held ``==`` to the reference's (no
tolerance): the same code on the same seeded exponent draws gives the
same floats, and a drift in either copy shows as a mismatch.
"""
import dataclasses

import pytest

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.core import area_power as ref_ap
from repro.core import simulator as ref_sim
from repro.core import workloads as ref_wl
from repro.autotune.objectives import analytic_proxy as ref_proxy
from repro.models.registry import projection_groups as ref_groups
from repro_torch.autotune.objectives import analytic_proxy
from repro_torch.core import area_power as ap
from repro_torch.core import simulator as sim
from repro_torch.core import workloads as wl
from repro_torch.models.registry import projection_groups

from _torch_parity import ARCHS, port_config

WORKLOADS = sorted(wl.WORKLOADS)
TYPES = ("INT4", "INT8x4", "INT8", "FP16", "FP8", "FP4")
TILES = {
    "big": dict(),
    "big_w16_c1": dict(adder_w=16, cluster_size=1),
    "big_w12_c4": dict(adder_w=12, cluster_size=4),
    "small_w16": dict(c_unroll=8, k_unroll=8, adder_w=16),
    "skip_w12": dict(adder_w=12, skip_empty_partitions=True),
}
SOURCES = ("FORWARD_SOURCE", "BACKWARD_SOURCE")
def _stats(net):
    return [dataclasses.asdict(layer) for layer in net.layers]


@pytest.mark.parametrize("name", WORKLOADS)
def test_workloads_equal(name):
    assert ([dataclasses.asdict(layer) for layer in wl.WORKLOADS[name]()]
            == [dataclasses.asdict(layer)
                for layer in ref_wl.WORKLOADS[name]()])
    assert wl.total_macs(wl.WORKLOADS[name]()) \
        == ref_wl.total_macs(ref_wl.WORKLOADS[name]())


def test_lm_projection_layers_equal():
    args = (896, 4864, 24, 151936, 128)
    assert ([dataclasses.asdict(layer)
             for layer in wl.lm_projection_layers(*args)]
            == [dataclasses.asdict(layer)
                for layer in ref_wl.lm_projection_layers(*args)])


@pytest.mark.parametrize("tile", sorted(TILES))
@pytest.mark.parametrize("types", TYPES)
@pytest.mark.parametrize("source", SOURCES)
def test_simulate_network_equal(tile, types, source):
    """Every layer's cycles, groups, utilization and MC factor, on the
    first layers of every study workload (the seeded exponent draws
    must be the same numbers for these to agree)."""
    for name in WORKLOADS:
        got = sim.simulate_network(
            wl.WORKLOADS[name]()[:3],
            dataclasses.replace(sim.BIG_TILE, **TILES[tile]),
            getattr(sim, types), getattr(sim, source), seed=3)
        want = ref_sim.simulate_network(
            ref_wl.WORKLOADS[name]()[:3],
            dataclasses.replace(ref_sim.BIG_TILE, **TILES[tile]),
            getattr(ref_sim, types), getattr(ref_sim, source), seed=3)
        assert _stats(got) == _stats(want), name
        assert got.slowdown == want.slowdown


@pytest.mark.parametrize("source", SOURCES)
def test_exponent_histogram_equal(source):
    got = sim.exponent_diff_histogram(getattr(sim, source), samples=20_000)
    want = ref_sim.exponent_diff_histogram(getattr(ref_sim, source),
                                           samples=20_000)
    assert got.tolist() == want.tolist()


def test_table1_model_equal():
    assert ap.table1_model() == ref_ap.table1_model()


def test_fig7_deltas_equal():
    assert ap.fig7_deltas() == ref_ap.fig7_deltas()


@pytest.mark.parametrize("mc", [1.0, 1.3, 2.0])
def test_headline_gains_equal(mc):
    assert ap.headline_gains(mc) == ref_ap.headline_gains(mc)


def test_designs_breakdowns_equal():
    for (name, d), (_, rd) in zip(sorted(ap.paper_designs().items()),
                                  sorted(ref_ap.paper_designs().items())):
        assert ap.area_breakdown(d) == ref_ap.area_breakdown(rd), name
        assert ap.power_breakdown(d) == ref_ap.power_breakdown(rd), name
        for wname, t in ap.WORKLOAD_TYPES.items():
            assert ap.throughput_tops(d, t) == ref_ap.throughput_tops(
                rd, ref_ap.WORKLOAD_TYPES[wname]), (name, wname)


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4", "fp8", "fp4",
                                  "fp16_ipu"])
@pytest.mark.parametrize("w", [10, 16, 28, 38])
def test_analytic_proxy_equal(mode, w):
    for sw in (16, 28):
        assert analytic_proxy(mode, w, sw) == ref_proxy(mode, w, sw)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_projection_groups_equal(arch, size):
    """Every family's precision-tuning units, including families whose
    layers the port does not run yet (the cost model reads them)."""
    ref_cfg = (ref_get_config if size == "full" else ref_reduced)(arch)
    got = projection_groups(port_config(ref_cfg))
    assert [dataclasses.asdict(g) for g in got] \
        == [dataclasses.asdict(g) for g in ref_groups(ref_cfg)]
    assert [g.macs_per_token for g in got] \
        == [g.macs_per_token for g in ref_groups(ref_cfg)]
