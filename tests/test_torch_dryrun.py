"""The port's dry-run (``repro_torch.launch.dryrun``) and the tools
around it on a fake world of 8 ranks, in one subprocess
(``tests/_torch_dryrun.py``: a fake process group is process-wide).

Reduced configs: qwen2-0.5b train on (2, 4), decode on (2, 2, 2) and
prefill on (2, 4), and qwen3-moe-30b-a3b prefill with ``gather``
dispatch on (2, 4). Each record has the reference's keys
(``fits_card`` and ``card_bytes`` in place of ``fits_16gb``); the
tracker's parameter and optimizer bytes are exactly the local shards'
bytes under the sharding rules; the dense prefill's FLOPs are exactly
a hand count of its matmuls on rank 0's local shapes. ``exchange_bench``,
``mem_probe`` and ``roofline_table`` run on reduced inputs.
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import reduced
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.launch.train import init_state, state_shardings
from repro_torch.models import registry
from repro_torch.parallel import sharding as shd

HERE = os.path.dirname(os.path.abspath(__file__))

# the reference's record (repro/launch/dryrun.py), fits_16gb renamed
REF_KEYS = {"arch", "shape", "mesh", "kind", "status", "chips", "lower_s",
            "compile_s", "memory", "cost", "collectives", "roofline",
            "params", "active_params", "per_device_bytes", "fits_16gb"}
PORT_KEYS = REF_KEYS - {"fits_16gb"} | {"fits_card", "card_bytes"}
MESHES = {"train": (2, 4), "decode": (2, 2, 2), "prefill": (2, 4),
          "moe_prefill": (2, 4)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "out.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(os.path.dirname(HERE), "src"),
                    env.get("PYTHONPATH")) if p)
    res = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_dryrun.py"), str(out)],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(out) as f:
        return json.load(f)


def _leaves(tree):
    out = []
    shd.tree_map_with_path(lambda p, x: out.append(x), tree)
    return out


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _local_bytes(tree, shardings, mesh):
    """Sum of each leaf's local shard bytes under its spec (every axis
    divides its dim: the rules drop those that do not)."""
    sizes = shd.axis_sizes(mesh)
    total = 0
    for x, sh in zip(_leaves(tree), _leaves(shardings)):
        spec = sh.spec
        local = list(x.shape)
        for d, ax in enumerate(spec):
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    assert local[d] % sizes[a] == 0
                    local[d] //= sizes[a]
        total += math.prod(local) * x.element_size()
    return total


@pytest.mark.parametrize("cell", sorted(MESHES))
def test_cells_trace_to_ok_records(runs, cell):
    rec = runs["cells"][cell]
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) == PORT_KEYS
    shape = MESHES[cell]
    assert rec["chips"] == math.prod(shape)
    assert rec["mesh"] == "pod" + "x".join(map(str, shape))
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    assert rec["per_device_bytes"] == rec["memory"]["Total"] > 0
    assert rec["fits_card"] is True
    r = rec["roofline"]
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert r["hlo_flops"] == rec["cost"]["flops"] * rec["chips"]
    # every cell shards something over a mesh axis, so it communicates
    assert rec["collectives"]["count"] > 0
    assert rec["collectives"]["per_chip_link_bytes"] == \
        sum(rec["collectives"]["by_op"].values())


def test_train_state_bytes_are_the_local_shards(runs):
    rec = runs["cells"]["train"]
    api = registry.build(reduced("qwen2-0.5b"))
    state = init_state(api, params=api.init(0, "meta"))
    mesh = abstract_mesh(MESHES["train"], _names(MESHES["train"]))
    sh = state_shardings(state, mesh)
    params = _local_bytes(state.params, sh.params, mesh)
    opt = sum(_local_bytes(getattr(state, f), getattr(sh, f), mesh)
              for f in ("opt", "loss_scale", "step"))
    assert rec["memory"]["Parameter"] == params
    assert rec["memory"]["Optstate"] == opt
    # FSDP over 'data': the step gathers parameters and scatters grads
    assert rec["collectives"]["by_op"]["all-gather"] > 0
    assert rec["collectives"]["by_op"]["reduce-scatter"] > 0


@pytest.mark.parametrize("cell", ("decode", "prefill", "moe_prefill"))
def test_serving_param_bytes_are_the_local_shards(runs, cell):
    arch = "qwen3-moe-30b-a3b" if cell == "moe_prefill" else "qwen2-0.5b"
    api = registry.build(reduced(arch))
    params = api.init(0, "meta")
    mesh = abstract_mesh(MESHES[cell], _names(MESHES[cell]))
    want = _local_bytes(params, shd.param_shardings(params, mesh), mesh)
    assert runs["cells"][cell]["memory"]["Parameter"] == want


def test_prefill_flops_are_a_hand_count_of_its_matmuls(runs):
    """Rank 0 of (2, 4) holds 4 of the 8 rows of 32 tokens (T = 128).
    The projections sharding their output over 'model' (wq, wk, wv,
    w_gate, w_up, the tied head) multiply by their local columns; wo and
    w_down, whose rules shard their output over 'data', run whole (K
    whole, ``mplinear.on_local_shards``); attention covers every head of
    the local rows; the head reads each row's last position."""
    cfg = reduced("qwen2-0.5b")
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    rows, s, model = 8 // 2, 32, 4
    t = rows * s
    layer = (2 * t * d * (h * hd // model)            # wq
             + 2 * 2 * t * d * (kv * hd // model)     # wk, wv
             + 2 * 2 * rows * h * s * s * hd          # q k^T, p v
             + 2 * t * (h * hd) * d                   # wo, whole
             + 2 * 2 * t * d * (f // model)           # w_gate, w_up
             + 2 * t * f * d)                         # w_down, whole
    head = 2 * rows * d * (cfg.padded_vocab // model)
    assert runs["cells"]["prefill"]["cost"]["flops"] == \
        cfg.n_layers * layer + head


def test_moe_cell_runs_gather_dispatch(runs):
    rec = runs["cells"]["moe_prefill"]
    cfg = reduced("qwen3-moe-30b-a3b")
    assert rec["active_params"] == cfg.active_params_count()
    assert rec["roofline"]["model_flops"] == 2.0 * cfg.active_params_count() \
        * 32 * 8


def test_exchange_bench_on_reduced_gemma2(runs):
    ex = runs["exchange"]
    assert ex["mesh"] == [2, 2, 2]
    assert ex["n_params"] == sum(
        x.numel() for x in _leaves(registry.build(
            reduced("gemma2-9b")).init(0, "meta")))
    gathered = {m: ex[m]["by_op"]["all-gather"] for m in
                ("f32", "int8", "blockfp8")}
    # int8 puts a quarter of f32's bytes on the wire; blockfp8 pads each
    # local shard to whole 256-value blocks (the small norm leaves)
    assert gathered["int8"] * 4 == gathered["f32"]
    assert gathered["int8"] < gathered["blockfp8"] < gathered["f32"] / 3.5
    for m in ("int8", "blockfp8"):
        assert ex[f"{m}_reduction"] >= 3.5
        assert ex[m]["exchange_s_at_link_bw"] == \
            ex[m]["per_chip_wire_bytes"] / 50e9


def test_mem_probe_on_reduced_qwen2(runs):
    full, none, two_layers, quarter_seq, quarter_batch = runs["mem_probe"]
    assert min(runs["mem_probe"]) > 0
    # remat keeps fewer activations; fewer tokens take less
    assert none > full and quarter_seq < full and quarter_batch < full
    assert two_layers == full    # the reduced config has 2 layers


def test_roofline_table_renders_a_record(runs):
    text = runs["roofline_table"]
    assert text.count("| qwen2-0.5b |") == 1
    assert "cells exceeding the card's memory: []" in text
    e = runs["enriched"]
    assert e["fits_card"] is True and e["mem_floor_s"] > 0
    assert torch.isfinite(torch.tensor(e["fraction"]))
