"""The port's precision planner (``repro_torch.autotune``: candidates,
objectives, search, CLI, and ``repro_torch.tools.plan_report``) against
the reference's ``repro.autotune`` and ``tools/plan_report.py``, on the
CPU.

The reference runs once, in one subprocess (XLA's excess precision off,
as ``_torch_parity.reference`` runs it), started when the module's first
parity test asks for it. It returns:

* the candidate keys of three grids (cache-key material and plan
  assignment strings): equal lists;
* its score table without the probe (cycles, efficiency and the
  analytic accuracy proxy: numpy models on both sides) at reduced shapes
  for every group, and at full shapes for two groups: ``==`` entry for
  entry;
* ``search_plan`` over that reduced table: the port's ``search_plan``
  over the *reference's* table gives byte-identical plan JSON;
* ``cmd_search --no-probe --shapes reduced``'s plan file: the port's
  ``cmd_search`` with the same flags writes the same bytes;
* ``render_report`` and ``tools/plan_report.py`` on that plan and on the
  committed ``results/plans/qwen2_0_5b.json``: identical text;
* ``plan_weight_bytes`` for every architecture of
  ``_torch_parity.ARCHS``, full and reduced, under each uniform mode, a
  mixed and a partial assignment: ``==``;
* ``divergence_probe`` for an int8, an fp8 and an fp16_ipu (w = 12,
  exact: the reference's Pallas ``mp_matmul`` in interpret mode, the
  port's plain ``mp_matmul``) candidate, int8 on ``attn_wo`` (a flipped
  int8 step, below) and int4 on the head, with the probe
  model's parameters (``PRNGKey(0)``) and tokens: the port's
  ``probe_kl`` on the converted parameters and the same tokens is within
  ``PROBE_KL_RTOL`` and ``PROBE_KL_ATOL`` of the reference's KL (the
  head's is 0 in both: neither package routes the head through the
  policy);
* ``plan_act_scales`` of the committed plan with both calibrations fed
  the same prompts: the port's, on the converted parameters, ``==``.

Tolerance of the probe (``objectives.PROBE_KL_RTOL`` and
``PROBE_KL_ATOL``): ``|port - reference| <= PROBE_KL_RTOL * reference
+ PROBE_KL_ATOL``, 0.1 relative and 2e-6 absolute. Both packages run
the same bf16 forward and differ only in the order of f32 sums inside
matrix products (see ``tests/test_torch_lm.py``: logits within 1e-5),
which can flip a bf16 or an int8 rounding step; a KL of 1e-5 to 1e-2 is the
small difference of two such forwards. Of these probes, int8 on
``attn_wo`` differs most, 5.5e-2 relative (2.992e-4 against 2.835e-4:
a flipped int8 step of an activation), and fp16_ipu w = 12 on
``ffn_out`` 3.5e-7 absolute (1.540e-5 against 1.505e-5); the bound
leaves about twice those. ``chip_smoke.py`` phase 16 holds the card's
accuracy rows to the CPU's with the same bound.

The port's own contracts, as ``tests/test_autotune.py`` holds the
reference to them: the cold/warm frontier, the non-dominated front, the
seed in the cache key, greedy descent strictly lowering cycles, the
search CLI and ``resolve_arch``'s aliases, the smoke, the probe's
transient policies leaving no ``_probe/`` or ``_calib/`` entry behind,
and a search never writing under ``results/plans/``.
"""
import contextlib
import dataclasses
import functools
import hashlib
import io
import json
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch import exp
from repro_torch.autotune import candidates as cand_mod
from repro_torch.autotune import cli
from repro_torch.autotune import objectives as obj
from repro_torch.autotune.objectives import PROBE_KL_ATOL, PROBE_KL_RTOL
from repro_torch.autotune import search as search_mod
from repro_torch.autotune.plan import load_plan
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import POLICIES, get_policy
from repro_torch.models.registry import projection_groups
from repro_torch.tools import plan_report

from _torch_parity import (ARCHS, _reference_env, flat,  # noqa
                           one_intra_op_thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen2-0.5b"
COMMITTED_PLAN = os.path.join(ROOT, "results", "plans", "qwen2_0_5b.json")

CANDIDATE_GRIDS = {
    "default": {},
    "grouped": {"group_sizes": [None, 32, 128], "clusters": [1, 2]},
    "widths": {"widths": [8, 12, 28, 38],
               "modes": ["fp16_ipu", "bf16", "int4", "fp4"]},
}
FULL_GROUPS = ("attn_wo", "head")
# (group, mode, w): one int8, one fp8, one exact fp16_ipu candidate, a
# flipped int8 step, and the (unrouted) head
PROBES = (("ffn_in", "int8", 16), ("attn_qkv", "fp8", 16),
          ("ffn_out", "fp16_ipu", 12), ("attn_wo", "int8", 16),
          ("head", "int4", 16))
SEARCH_FLAGS = ["--model", "qwen2_0_5b", "--no-probe", "--shapes",
                "reduced", "--quiet-progress"]


def calib_prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 512, n).astype(np.int32) for n in (11, 5, 16)]


_REFERENCE_SCRIPT = r"""
import contextlib, io, json, os, pickle, sys, tempfile
import numpy as np
import jax
from repro import exp
from repro.autotune import candidates as cand_mod
from repro.autotune import objectives as obj
from repro.autotune import search as search_mod
from repro.autotune.cli import (cmd_search, plan_act_scales,
                                plan_weight_bytes, render_report)
from repro.autotune.plan import load_plan
from repro.configs import get_config, reduced
from repro.configs.base import InputShape
from repro.models import registry
from repro.quant import calibrate
import tools.plan_report as plan_report

out, arg = sys.argv[1], json.loads(sys.argv[2])
ARCH, res = arg["arch"], {}

def stdout_of(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()

res["keys"] = {name: [c.key() for c in cand_mod.default_candidates(**kw)]
               for name, kw in arg["grids"].items()}
cands = cand_mod.default_candidates()
engine = exp.EngineConfig(cache=None)
table = search_mod.build_scores(
    ARCH, registry.projection_groups(reduced(ARCH)), cands, engine,
    shapes="reduced", probe=False)
res["table_reduced"] = table.scores
res["plan_from_table"] = json.dumps(
    search_mod.search_plan(ARCH, table).to_json(), indent=1, sort_keys=True)
full = [g for g in registry.projection_groups(get_config(ARCH))
        if g.name in arg["full_groups"]]
res["table_full"] = search_mod.build_scores(
    ARCH, full, cands, engine, shapes="full", probe=False).scores

with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "plan.json")
    stdout_of(cmd_search, arg["search_flags"] + [
        "--cache-dir", os.path.join(d, "c"), "--out", path])
    with open(path) as f:
        res["search_json"] = f.read()
    res["reports"] = {}
    for name, p in (("searched", path), ("committed", arg["committed"])):
        res["reports"][name] = (render_report(load_plan(p)),
                                stdout_of(plan_report.main, [p]))

res["weight_bytes"] = {}
for arch in arg["archs"]:
    for shapes in ("full", "reduced"):
        cfg = reduced(arch) if shapes == "reduced" else get_config(arch)
        names = [g.name for g in registry.projection_groups(cfg)]
        assigns = {m: {n: m for n in names}
                   for m in ("bf16", "fp16_ipu", "int8", "int4", "fp8",
                             "fp4", "fp32")}
        modes = ("int4", "fp8", "bf16", "int8", "fp4", "fp16_ipu")
        assigns["mixed"] = {n: modes[i % len(modes)]
                            for i, n in enumerate(names)}
        assigns["partial"] = {n: "int8" for n in names[1:]}
        for name, modes_ in assigns.items():
            res["weight_bytes"][(arch, shapes, name)] = (
                modes_, plan_weight_bytes(arch, modes_, shapes))
res["weight_bytes_unknown"] = plan_weight_bytes("no-such-arch", {})

cfg = reduced(ARCH)
params = registry.build(cfg).init(jax.random.PRNGKey(0))
res["probe_params"] = jax.tree.map(np.asarray, params)
batch = registry.materialize_batch(cfg, InputShape("probe", 16, 2,
                                                   "prefill"), seed=0)
res["probe_tokens"] = np.asarray(batch["tokens"])
res["probe_kl"] = {tuple(p): obj.divergence_probe(ARCH, p[0], p[1], p[2],
                                                  28, seed=0)
                   for p in arg["probes"]}

prompts = [np.asarray(p, np.int32) for p in arg["prompts"]]
real = calibrate.calibrate_act_scales
calibrate.calibrate_act_scales = (
    lambda cfg, api, params, **kw: real(cfg, api, params, prompts=prompts))
res["act_scales"] = plan_act_scales(load_plan(arg["committed"]))
calibrate.calibrate_act_scales = real
from repro.core.policy import POLICIES
res["transient"] = sorted(n for n in POLICIES
                          if n.startswith(("_probe/", "_calib/")))
with open(out, "wb") as f:
    pickle.dump(res, f)
"""


@functools.lru_cache(maxsize=None)
def _reference():
    _, env = _reference_env()
    env["PYTHONPATH"] = os.pathsep.join((ROOT, env["PYTHONPATH"]))
    arg = {"arch": ARCH, "grids": CANDIDATE_GRIDS,
           "full_groups": list(FULL_GROUPS), "search_flags": SEARCH_FLAGS,
           "committed": COMMITTED_PLAN, "archs": list(ARCHS),
           "probes": [list(p) for p in PROBES],
           "prompts": [p.tolist() for p in calib_prompts()]}
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "ref.pkl")
        subprocess.run([sys.executable, "-c", _REFERENCE_SCRIPT, out,
                        json.dumps(arg)], cwd=ROOT, env=env, check=True,
                       timeout=600)
        with open(out, "rb") as f:
            return pickle.load(f)


@pytest.fixture(scope="module")
def ref():
    return _reference()


def _stdout_of(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def _cpu_engine(cache_dir=None):
    return exp.EngineConfig(
        cache=None if cache_dir is None else exp.ResultCache(str(cache_dir)),
        device="cpu")


# ------------------------------------------------- against the reference

@pytest.mark.parametrize("grid", sorted(CANDIDATE_GRIDS))
def test_candidate_keys_equal_the_reference(ref, grid):
    got = [c.key() for c in
           cand_mod.default_candidates(**CANDIDATE_GRIDS[grid])]
    assert got == ref["keys"][grid]
    assert len(set(got)) == len(got)


def test_score_table_equals_the_reference_at_reduced_shapes(ref):
    table = search_mod.build_scores(
        ARCH, projection_groups(reduced(ARCH)),
        cand_mod.default_candidates(), _cpu_engine(), shapes="reduced",
        probe=False)
    assert table.scores == ref["table_reduced"]


def test_score_table_equals_the_reference_at_full_shapes(ref):
    groups = [g for g in projection_groups(get_config(ARCH))
              if g.name in FULL_GROUPS]
    table = search_mod.build_scores(
        ARCH, groups, cand_mod.default_candidates(), _cpu_engine(),
        shapes="full", probe=False)
    assert len(table.scores) == 2 * len(cand_mod.default_candidates())
    assert table.scores == ref["table_full"]


def test_search_plan_over_the_reference_table_is_byte_identical(ref):
    table = search_mod.ScoreTable(
        ref["table_reduced"], projection_groups(reduced(ARCH)),
        cand_mod.default_candidates())
    plan = search_mod.search_plan(ARCH, table)
    assert json.dumps(plan.to_json(), indent=1, sort_keys=True) \
        == ref["plan_from_table"]


def test_cmd_search_writes_the_reference_plan(ref, tmp_path):
    out = tmp_path / "plan.json"
    rc, text = _stdout_of(cli.cmd_search, SEARCH_FLAGS + [
        "--device", "cpu", "--cache-dir", str(tmp_path / "c"),
        "--out", str(out)])
    assert rc == 0 and f"-> {out}" in text
    assert out.read_text() == ref["search_json"]


@pytest.mark.parametrize("which", ("searched", "committed"))
def test_report_and_plan_report_print_the_reference_text(ref, tmp_path,
                                                         which):
    path = COMMITTED_PLAN
    if which == "searched":
        path = tmp_path / "plan.json"
        path.write_text(ref["search_json"])
    want_report, (want_rc, want_tool) = ref["reports"][which]
    assert cli.render_report(load_plan(str(path))) == want_report
    assert _stdout_of(plan_report.main, [str(path)]) == (want_rc, want_tool)
    assert _stdout_of(cli.cmd_report, ["--plan", str(path)]) \
        == (0, want_report)


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_weight_bytes_equal_the_reference(ref, arch):
    cases = {k: v for k, v in ref["weight_bytes"].items() if k[0] == arch}
    assert len(cases) == 2 * 9
    for (_, shapes, name), (modes, want) in cases.items():
        assert cli.plan_weight_bytes(arch, modes, shapes) == want, \
            (shapes, name)
    assert cli.plan_weight_bytes("no-such-arch", {}) \
        == ref["weight_bytes_unknown"] is None


def _probe_params(ref):
    return params_from_numpy(ref["probe_params"], device="cpu")


@pytest.mark.parametrize("probe", PROBES,
                         ids=lambda p: f"{p[0]}-{p[1]}_w{p[2]}")
def test_probe_kl_on_shared_inputs_matches_the_reference(ref, probe):
    """The port's probe on the reference's parameters (converted) and
    tokens: the same KL within the stated bound, and no policy left
    behind."""
    group, mode, w = probe
    policy = obj.probe_policy(ARCH, group, mode, w, 28)
    assert policy.spec_for("x").mode == "bf16"
    batch = {"tokens": torch.from_numpy(ref["probe_tokens"])}
    got = obj.probe_kl(reduced(ARCH), _probe_params(ref), batch, policy)
    want = ref["probe_kl"][probe]
    assert want > 0 or group == "head"
    assert abs(got - want) <= PROBE_KL_RTOL * want + PROBE_KL_ATOL, \
        (got, want)
    assert policy.name not in POLICIES


def test_plan_act_scales_equal_the_reference(ref, monkeypatch):
    """Both calibrations fed the same prompts, the port's model init
    replaced by the reference's ``PRNGKey(0)`` parameters (converted)."""
    from repro_torch.models import registry
    from repro_torch.quant import calibrate
    real_calibrate, real_build = calibrate.calibrate_act_scales, \
        registry.build
    params = _probe_params(ref)

    def with_prompts(cfg, api, params, **kw):
        return real_calibrate(cfg, api, params, prompts=calib_prompts(),
                              device=kw["device"])

    def reference_init(cfg):
        return real_build(cfg)._replace(
            init=lambda seed=0, device=None: params)

    monkeypatch.setattr(calibrate, "calibrate_act_scales", with_prompts)
    monkeypatch.setattr(registry, "build", reference_init)
    got = cli.plan_act_scales(load_plan(COMMITTED_PLAN), device="cpu")
    assert got == ref["act_scales"]
    assert not [n for n in POLICIES if n.startswith(("_probe/", "_calib/"))]
    assert ref["transient"] == []


# ------------------------------------------------ the port's own contracts

def _toy_setup(cache_dir):
    groups = projection_groups(reduced(ARCH))
    cands = cand_mod.default_candidates(
        widths=(12, 16), clusters=(1,),
        modes=("bf16", "fp16_ipu", "int8", "int4"))
    return groups, cands, _cpu_engine(cache_dir)


def _toy_table(tmp_path):
    groups, cands, engine = _toy_setup(tmp_path / "cache")
    return search_mod.build_scores(ARCH, groups, cands, engine, seq=1,
                                   seed=0, shapes="reduced", probe=False)


def test_cold_then_warm_and_frontier(tmp_path):
    groups, cands, engine = _toy_setup(tmp_path / "cache")
    table = search_mod.build_scores(ARCH, groups, cands, engine, seq=1,
                                    seed=0, shapes="reduced", probe=False)
    assert engine.total.n_executed > 0
    plan = search_mod.search_plan(ARCH, table)
    assert len(plan.frontier) >= 3, "trivial Pareto frontier"
    warm = _cpu_engine(tmp_path / "cache")
    table2 = search_mod.build_scores(ARCH, groups, cands, warm, seq=1,
                                     seed=0, shapes="reduced", probe=False)
    assert warm.total.n_executed == 0, "warm re-run re-evaluated"
    assert search_mod.search_plan(ARCH, table2).to_json() == plan.to_json()


def test_frontier_is_non_dominated(tmp_path):
    front = list(search_mod.search_plan(ARCH, _toy_table(tmp_path)).frontier)
    for a in front:
        for b in front:
            if a is b:
                continue
            am, bm = a["metrics"], b["metrics"]
            dominated = (bm["cycles"] <= am["cycles"]
                         and bm["acc_proxy"] <= am["acc_proxy"]
                         and bm["tops_per_w"] >= am["tops_per_w"]
                         and (bm["cycles"] < am["cycles"]
                              or bm["acc_proxy"] < am["acc_proxy"]
                              or bm["tops_per_w"] > am["tops_per_w"]))
            assert not dominated, (a["name"], b["name"])


def test_seed_is_part_of_cache_key():
    point = exp.SweepSpec(
        name="k", fn="repro_torch.autotune.objectives:cycles_point",
        axes={"seed": [0]}, fixed={"arch": ARCH, "group": "attn_qkv",
                                   "mode": "int8", "w": 16,
                                   "sw_precision": 28, "cluster": 1,
                                   "seq": 1, "shapes": "reduced"})
    p0 = point.points()[0]
    p1 = dataclasses.replace(
        p0, params=tuple(("seed", 1) if k == "seed" else (k, v)
                         for k, v in p0.params))
    assert exp.point_key(p0, salt="s") != exp.point_key(p1, salt="s")


def test_greedy_descent_strictly_lowers_cycles(tmp_path):
    table = _toy_table(tmp_path)
    bf16 = next(c for c in table.candidates if c.mode == "bf16")
    traj = search_mod.greedy_descent(
        table, {g.name: bf16 for g in table.groups})
    cycles = [search_mod.plan_metrics(table, a)["cycles"] for a in traj]
    assert all(b < a for a, b in zip(cycles, cycles[1:]))
    assert len(traj) >= 2


def test_search_cli_acceptance(tmp_path):
    """`search --model qwen2_0_5b` (alias form) emits a plan JSON with a
    non-trivial frontier that serves via --plan, and `score --plan`
    gives back its metrics from the warm cache."""
    out = str(tmp_path / "plan.json")
    flags = ["--model", "qwen2_0_5b", "--no-probe", "--shapes", "reduced",
             "--widths", "12", "16", "--cache-dir", str(tmp_path / "cache"),
             "--quiet-progress", "--device", "cpu"]
    rc, _ = _stdout_of(cli.cmd_search, flags + ["--out", out])
    assert rc == 0
    plan = load_plan(out)
    assert plan.arch == ARCH and len(plan.frontier) >= 3
    assert get_policy(f"plan:{out}").rules
    report = cli.render_report(plan)
    assert "Pareto frontier" in report and plan.name in report
    rc, text = _stdout_of(cli.cmd_score, flags + ["--plan", out])
    assert rc == 0 and text.startswith("# total: ") \
        and " 0 executed " in text.splitlines()[0]
    scored = json.loads(text.split("\n", 1)[1])
    assert scored["metrics"] == plan.metrics


def test_resolve_arch_aliases():
    assert cli.resolve_arch("qwen2-0.5b") == ARCH
    assert cli.resolve_arch("qwen2_0_5b") == ARCH
    assert cli.resolve_arch("QWEN2_0_5B") == ARCH
    assert cli.resolve_arch("rwkv6_1_6b") == "rwkv6-1.6b"
    with pytest.raises(SystemExit):
        cli.resolve_arch("not-a-model")


def test_smoke_meets_the_reference_contract(tmp_path):
    rc, text = _stdout_of(cli.main, ["smoke", "--device", "cpu",
                                     "--cache-dir", str(tmp_path)])
    assert rc == 0 and text.startswith("autotune smoke OK: cold ")
    assert ", warm " in text and " cached / 0 executed" in text
    assert os.listdir(tmp_path) == []       # its cache is removed
    assert not [n for n in POLICIES if n.startswith("_probe/")]


def test_default_output_is_the_ports_directory(tmp_path, monkeypatch):
    """A search without ``--out`` writes ``results/plans_torch/<arch>``,
    never the reference's ``results/plans/``."""
    assert cli.DEFAULT_PLAN_DIR == "results/plans_torch"
    monkeypatch.chdir(tmp_path)
    rc, text = _stdout_of(cli.cmd_search, [
        "--model", "qwen2-0.5b", "--no-probe", "--shapes", "reduced",
        "--modes", "bf16", "int8", "--quiet-progress", "--device", "cpu",
        "--no-cache"])
    assert rc == 0 and "-> results/plans_torch/qwen2_0_5b.json" in text
    assert sorted(os.listdir(tmp_path)) == ["results"]
    assert os.listdir(tmp_path / "results") == ["plans_torch"]
    assert load_plan(str(tmp_path / "results" / "plans_torch"
                         / "qwen2_0_5b.json")).arch == ARCH


def test_probe_runs_the_plain_mp_matmul_on_cpu(monkeypatch):
    """An exact fp16_ipu candidate probes through ``ops.mp_matmul``
    (its plain version on CPU tensors): one call a projection of the
    group, in the candidate's forward only; other candidates make none."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.mp_matmul

    def counting(a, b, *args, **kwargs):
        calls.append(tuple(a.shape) + (b.shape[1],))
        return real(a, b, *args, **kwargs)

    monkeypatch.setattr(ops, "mp_matmul", counting)
    kl = obj.divergence_probe(ARCH, "attn_qkv", "fp16_ipu", 12, 28,
                              device="cpu")
    assert kl > 0
    # wq, wk, wv in each of the 2 layers, at M = 2 x 16 rows
    assert sorted(calls) == sorted([(32, 64, 64), (32, 64, 32),
                                    (32, 64, 32)] * 2)
    calls.clear()
    obj.divergence_probe(ARCH, "attn_qkv", "fp16_ipu", 28, 28, device="cpu")
    obj.divergence_probe(ARCH, "attn_qkv", "int8", 16, 28, device="cpu")
    assert calls == []


@pytest.mark.parametrize("group", ("attn_qkv", "attn_wo", "ffn_in",
                                   "ffn_out"))
def test_probe_widths_change_the_mp_matmul_bits(monkeypatch, group):
    """On the probe's own operands, each exact width of the default grid
    (12, 16, 20) gives ``mp_matmul`` outputs that differ from w = 28's:
    holding the probe's calls bit-equal to the plain version
    (``chip_smoke.py`` phase 16, ``test_torch_cuda.py``) would see a
    kernel that ignored the width, where the KL does not."""
    from repro_torch.kernels import mpmm, ref
    calls = []
    real = mpmm.mp_matmul

    def recording(a, b, cfg, **kwargs):
        out = real(a, b, cfg, **kwargs)
        calls.append((a, b, cfg, kwargs, out))
        return out

    monkeypatch.setattr(mpmm, "mp_matmul", recording)
    widths = sorted({c.w for c in cand_mod.default_candidates()
                     if cand_mod.exact_for(c.mode, c.w)})
    assert widths == [12, 16, 20]
    for w in widths:
        calls.clear()
        obj.divergence_probe(ARCH, group, "fp16_ipu", w, 28, device="cpu")
        assert calls
        for a, b, cfg, kwargs, out in calls:
            wide = ref.mp_matmul_blocked_ref(
                a, b, dataclasses.replace(cfg, w=28), **kwargs)
            assert cfg.w == w and not torch.equal(out, wide), (w, a.shape)


def test_accuracy_point_is_the_same_on_a_reused_draw():
    """The probe draws its weights from numpy's seed: two calls give the
    same KL, and the bf16 candidate probes nothing."""
    a = obj.accuracy_point(ARCH, "ffn_out", "int4", 16, 28, device="cpu")
    b = obj.accuracy_point(ARCH, "ffn_out", "int4", 16, 28, device="cpu")
    assert a == b and a["divergence"] > 0
    assert a["acc_proxy"] == a["divergence"] + 1e-3 * a["bound_rel"]
    bf16 = obj.accuracy_point(ARCH, "ffn_out", "bf16", 38, 28, device="cpu")
    assert bf16["divergence"] == 0.0


# sha256 of the probe model's weights and tokens for reduced qwen2-0.5b,
# seed 0 (``draw_digest``); ``chip_smoke.py`` phase 16 holds the card
# machine's installation to the same value
PROBE_DRAW_SHA256 = ("437f48216f191db829a5ed92b840e74e"
                     "d6284a69a72b18017c18d7b9b84958cb")


def draw_digest(*trees) -> str:
    """sha256 over every leaf of ``trees`` in sorted path order: its path
    and its values as f32 bytes."""
    h = hashlib.sha256()
    for tree in trees:
        leaves = flat(tree)
        for path in sorted(leaves):
            h.update(path.encode())
            h.update(leaves[path].to(torch.float32).numpy().tobytes())
    return h.hexdigest()


def test_probe_draw_is_pinned():
    """The probe's weights and tokens come from numpy seeds: their bits
    do not depend on the torch installation, so every installation that
    reproduces this digest probes the same model."""
    params, batch = obj.probe_inputs(reduced(ARCH), 0, device="cpu")
    assert draw_digest(params, batch) == PROBE_DRAW_SHA256


@pytest.mark.parametrize("arch", ARCHS)
def test_numpy_draws_give_the_init_tree_and_distributions(arch):
    """``init(draws="numpy")`` gives the tree of the torch draw, leaf for
    leaf in shape and dtype; every leaf the init fills with a constant
    equal; every drawn leaf of 256 values or more with a standard
    deviation within 15 % of the torch draw's and a mean within 0.15 of
    its standard deviation; and the same bits on a second call."""
    from repro_torch.models import registry
    api = registry.build(reduced(arch))
    ref = flat(api.init(0, "cpu"))
    got = flat(api.init(0, "cpu", draws="numpy"))
    assert got.keys() == ref.keys()
    for path, t in ref.items():
        g = got[path]
        assert (g.shape, g.dtype) == (t.shape, t.dtype), path
        t32, g32 = t.to(torch.float32), g.to(torch.float32)
        if torch.all(t32 == t32.flatten()[0]):
            assert torch.equal(g32, t32), path
        elif t.numel() >= 256:
            std = float(g32.std() / t32.std())
            mean = float(g32.mean() - t32.mean()) / float(t32.std())
            assert 0.85 < std < 1.15 and abs(mean) < 0.15, (path, std, mean)
    again = flat(api.init(0, "cpu", draws="numpy"))
    assert all(torch.equal(again[p], got[p]) for p in got)


def test_numpy_truncated_normal_is_truncated_at_3_sigma():
    """``dense_init`` from numpy draws: nothing beyond 3 / sqrt(d_in),
    and the truncated standard normal's deviation (0.9866) times that
    scale within 1 %."""
    from repro_torch.layers.common import dense_init
    w = dense_init(np.random.default_rng(3), 400, 500, "cpu")
    assert float(w.abs().max()) <= 3.0 / 20.0
    assert abs(float(w.std()) * 20.0 / 0.9866 - 1.0) < 0.01


def test_init_refuses_an_unknown_draw_source():
    from repro_torch.models import registry
    with pytest.raises(ValueError, match="draws"):
        registry.build(reduced(ARCH)).init(0, "cpu", draws="jax")
