"""The port's roofline, cell configs and roofline table against the JAX
reference's (``repro/launch/{roofline,cell_configs}.py``,
``tools/roofline_table.py``), and its collective recorder against hand
counts.

* ``_ring_factor``, ``model_flops`` for every arch x shape,
  ``RECOMMENDED`` (every field but the notes, which quote TPU figures
  in the reference) and ``analytic_floor_bytes`` equal the reference's.
* The constants are the H100 SXM data sheet's, and ``chip_smoke.py``'s
  card table agrees on the memory rate.
* ``CollectiveRecorder`` on a fake world of 8 (a ``fake`` process
  group, started for this module and ended after it): each collective
  that ``torch.distributed`` and DTensor issue adds its per-rank payload
  times the ring factor of its group's size, as counted by hand.
"""
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.launch import cell_configs as ref_cells
from repro.launch import roofline as ref_rl
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import cell_configs
from repro_torch.launch import roofline as rl
from repro_torch.tools import roofline_table

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
       "collective-permute")


@pytest.mark.parametrize("op", OPS)
def test_ring_factor_equals_reference(op):
    for group in (0, 1, 2, 3, 4, 8, 16, 256, 512):
        assert rl._ring_factor(op, group) == ref_rl._ring_factor(op, group)


def test_shapes_equal_reference():
    assert {k: tuple(v.__dict__.values()) for k, v in SHAPES.items()} == \
        {k: tuple(v.__dict__.values()) for k, v in REF_SHAPES.items()}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equals_reference(arch, shape):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert cfg.active_params_count() == ref_cfg.active_params_count()
    assert cfg.sub_quadratic == ref_cfg.sub_quadratic
    assert rl.model_flops(cfg, SHAPES[shape]) == \
        ref_rl.model_flops(ref_cfg, REF_SHAPES[shape])


def test_recommended_equals_reference_but_its_notes():
    fields = ("microbatches", "moe_dispatch", "remat")
    assert set(cell_configs.RECOMMENDED) == set(ref_cells.RECOMMENDED)
    for key, cc in cell_configs.RECOMMENDED.items():
        ref = ref_cells.RECOMMENDED[key]
        assert [getattr(cc, f) for f in fields] == \
            [getattr(ref, f) for f in fields], key
        # the reference's item name (M7, C1, C3), and no TPU figure
        item = re.match(r"[MC]\d+", ref.note)
        assert re.match(r"[MC]\d+", cc.note) == item or \
            cc.note.startswith(item.group(0)), key
        assert "GB" not in cc.note and "->" not in cc.note
    for arch in ARCH_IDS:
        for shape in SHAPES:
            a = cell_configs.recommended(arch, shape)
            b = ref_cells.recommended(arch, shape)
            assert [getattr(a, f) for f in fields] == \
                [getattr(b, f) for f in fields]


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_floor_bytes_equals_reference(arch, shape):
    ref_table = _load("ref_roofline_table",
                      os.path.join(ROOT, "tools", "roofline_table.py"))
    kind = SHAPES[shape].kind
    args = 123_456_789
    ref_rec = {"arch": arch, "shape": shape, "kind": kind, "chips": 256,
               "memory": {"argument_size_in_bytes": args}}
    rec = {"arch": arch, "shape": shape, "kind": kind, "chips": 256,
           "memory": {"Parameter": 100_000_000, "Optstate": 20_000_000,
                      "Other": args - 120_000_000, "Temp": 5}}
    assert roofline_table.analytic_floor_bytes(rec) == \
        ref_table.analytic_floor_bytes(ref_rec)


def test_constants_are_the_h100_data_sheet():
    assert rl.PEAK_FLOPS == 989e12
    assert rl.HBM_BW == 3.35e12
    assert rl.LINK_BW == 50e9
    smoke = _load("chip_smoke_cards", os.path.join(ROOT, "chip_smoke.py"))
    assert smoke.CARDS["H100"]["bytes_per_s"] == rl.HBM_BW


def test_terms_from_counts():
    cfg = get_config("qwen2-0.5b")
    stats = rl.CollectiveStats()
    stats.add("all-gather", 5e9)
    t = rl.terms_from_counts("qwen2-0.5b", SHAPES["train_4k"], "pod16x16",
                             256, 1e15, 6.7e12, stats, cfg)
    assert t.hlo_flops == 1e15 * 256 and t.collective_bytes == 5e9 * 256
    assert t.compute_s == 1e15 / rl.PEAK_FLOPS
    assert t.memory_s == 2.0 and t.collective_s == 0.1
    assert t.bottleneck == "memory"
    d = t.to_dict()
    assert d["flops_ratio"] == rl.model_flops(cfg, SHAPES["train_4k"]) \
        / (1e15 * 256)


# ------------------------------------------------ the recorder, by hand

WORLD = 8


@pytest.fixture(scope="module")
def fake_world():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _recorded(fn):
    with rl.CollectiveRecorder() as rec:
        fn()
    return rec.stats


def test_recorder_c10d_collectives(fake_world):
    import torch.distributed as dist
    x8 = torch.zeros(8, 16, dtype=torch.int8)
    f4 = torch.zeros(4)
    g = torch.zeros(8, 4)

    def gather():
        dist.all_gather(list(torch.empty(WORLD, 8, 16, dtype=torch.int8)
                             .unbind(0)), x8)

    # payload: the gathered bytes over the group, 8 x 128 / 8, x 7/8
    s = _recorded(gather)
    assert s.by_op == {"all-gather": 128 * 7 / 8} and s.count == 1
    # all-reduce: 16 bytes x 2 x 7/8
    s = _recorded(lambda: dist.all_reduce(f4, op=dist.ReduceOp.MAX))
    assert s.by_op == {"all-reduce": 16 * 2 * 7 / 8}
    # reduce-scatter and all-to-all: their 128-byte input x 7/8
    s = _recorded(lambda: dist.reduce_scatter_tensor(torch.empty(1, 4), g))
    assert s.by_op == {"reduce-scatter": 128 * 7 / 8}
    s = _recorded(lambda: dist.all_to_all_single(torch.empty(8, 4), g))
    assert s.by_op == {"all-to-all": 128 * 7 / 8}
    assert s.total_bytes == 112.0


def test_recorder_subgroups_and_dtensor(fake_world):
    import torch.distributed as dist
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    data = mesh.get_group("data")
    s = _recorded(lambda: dist.all_reduce(torch.zeros(8), group=data))
    assert s.by_op == {"all-reduce": 32 * 2 * 1 / 2}
    x = distribute_tensor(torch.zeros(8, 16), mesh, [Replicate(), Shard(0)],
                          src_data_rank=None)
    # Shard(0) over 'model' (4) -> Replicate: a functional all-gather of
    # the (2, 16) f32 shards, 512 gathered bytes / 4, x 3/4
    s = _recorded(lambda: x.redistribute(mesh, [Replicate(), Replicate()]))
    assert s.by_op == {"all-gather": 512 / 4 * 3 / 4}
    p = x.redistribute(mesh, [Replicate(), Replicate()])
    from torch.distributed.tensor import DTensor
    part = DTensor.from_local(p.to_local(), mesh, [Partial(), Replicate()],
                              run_check=False)
    # Partial over 'data' (2) -> Replicate: an all-reduce of 512 bytes x 1
    s = _recorded(lambda: part.redistribute(mesh,
                                            [Replicate(), Replicate()]))
    assert s.by_op == {"all-reduce": 512 * 2 * 1 / 2}


def test_recorder_ignores_other_ops(fake_world):
    s = _recorded(lambda: (torch.ones(3) @ torch.ones(3)).sum())
    assert s.total_bytes == 0 and s.count == 0 and s.by_op == {}


def test_roofline_table_renders_records(tmp_path, capsys):
    """``roofline_table`` on two records of production shapes (their
    numbers made up here): a row each, the summary lines, the misfit
    named; and ``enrich`` beside the reference's on the same terms."""
    import json
    ref_table = _load("ref_roofline_table",
                      os.path.join(ROOT, "tools", "roofline_table.py"))
    terms = rl.RooflineTerms("qwen2-0.5b", "train_4k", "pod16x16", 256,
                             4e16, 5e15, 6e12, 3.1e15, 0.16, 6.1, 0.47)
    rec = {"arch": "qwen2-0.5b", "shape": "train_4k", "kind": "train",
           "mesh": "pod16x16", "status": "ok", "chips": 256,
           "roofline": terms.to_dict(), "per_device_bytes": 9e10,
           "fits_card": False, "memory": {}}
    for name, r in (("a", rec), ("b", dict(rec, status="error"))):
        with open(tmp_path / f"{name}.json", "w") as f:
            json.dump(r, f)
    assert roofline_table.main(["--dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.count("| qwen2-0.5b | train_4k | pod16x16 |") == 1
    assert "cells exceeding the card's memory: [('qwen2-0.5b', " \
        "'train_4k', 'pod16x16', 90.0)]" in out
    ours = roofline_table.enrich(rec)
    theirs = ref_table.enrich(dict(rec, memory={}))
    assert ours["fits_card"] is False and "fits_16gb" not in ours
    assert ours["per_device_gb"] == theirs["per_device_gb"] == 90.0
    # the same floor bytes, over the H100's HBM rate
    assert np.isclose(ours["mem_floor_s"] * rl.HBM_BW,
                      theirs["mem_floor_s"] * ref_rl.HBM_BW)
    assert roofline_table.fmt_row(ours).startswith(
        "| qwen2-0.5b | train_4k | pod16x16 |")
