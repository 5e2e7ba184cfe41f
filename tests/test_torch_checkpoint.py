"""The port's checkpoints against the reference's format, on the CPU.

Mirrors ``tests/test_checkpoint.py`` (the self-describing restore, per
leaf checksums, the miss behaviour, crash safety and GC) on the port's
``repro_torch.checkpoint``, then crosses the packages both ways:

* a reference-written engine checkpoint (``int4_serving`` calibrated,
  and an fp/per-group policy) restores through the port's
  ``build_engine(..., device="cpu")`` with every leaf bit-equal, zero
  weight quantizations and zero calibration passes, and serves the
  reference engine's greedy streams EQUAL; saved again by the port, its
  ``manifest.msgpack`` is byte-equal to the reference's;
* a port-written checkpoint restores in ``repro.checkpoint`` bit for
  bit, and its manifest unpacks (``msgpack.unpackb``) to the reference's
  paths, shapes, dtypes and checksums for the same tree.

The port writes and reads manifests with its own codec; ``msgpack`` is
used here only as the yardstick.
"""
import dataclasses
import os

import msgpack
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro.core.policy import PrecisionSpec as RefSpec
from repro.fabric.checkpoint import load_engine_checkpoint as ref_load_engine
from repro.quant.prepare import prepare_weight as ref_prepare_weight
from repro.serving.config import EngineConfig as RefEngineConfig
from repro_torch.checkpoint import (CheckpointError, CheckpointManager,
                                    CheckpointNotFound, ChecksumError,
                                    latest_step, list_steps,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint.checkpoint import _tree_paths
from repro_torch.configs import reduced
from repro_torch.core.policy import (PrecisionPolicy, PrecisionSpec,
                                     register_policy)
from repro_torch.fabric import (build_engine, load_engine_checkpoint,
                                save_engine_checkpoint)
from repro_torch.fabric.checkpoint import (engine_config_from_dict,
                                           model_config_from_dict,
                                           model_config_to_dict)
from repro_torch.layers.mplinear import count_weight_quant
from repro_torch.models import registry
from repro_torch.quant import calibrate
from repro_torch.quant.prepare import (PreparedWeight, prepare_weight,
                                       tree_manifest)
from repro_torch.serving import EngineConfig, Request, SamplingParams
from repro_torch.serving.engine import ServingEngine

from _jax_reference import drive_trace, fp_grouped_rules
from _torch_parity import one_intra_op_thread  # noqa: F401 (autouse)
from _torch_parity import reference, run_references, to_torch

ARCH = "qwen2-0.5b"


def _prepared_tree():
    """A serving-shaped tree: packed int4 + int8 PreparedWeights (with
    an act scale), a raw bf16 leaf, a tuple, a None hole."""
    rng = np.random.default_rng(0)
    w4 = torch.from_numpy(rng.normal(0, 1, (16, 8)).astype(np.float32))
    w8 = torch.from_numpy(rng.normal(0, 1, (12, 8)).astype(np.float32))
    p4 = prepare_weight(w4, PrecisionSpec("int4", exact=True),
                        act_scale=0.125)
    p8 = prepare_weight(w8, PrecisionSpec("int8", exact=True))
    assert p4.kind == "int4_packed" and p8.kind == "int8"
    return {
        "blocks": {"b0": {"attn": {"wq": p4, "wo": p8}}},
        "emb": torch.arange(24, dtype=torch.bfloat16).reshape(4, 6),
        "pair": (torch.ones(3), None),
        "ids": [torch.arange(5, dtype=torch.int32)],
    }


def _ref_prepared_tree():
    """The same tree built by the reference (jax arrays)."""
    rng = np.random.default_rng(0)
    w4 = jnp.asarray(rng.normal(0, 1, (16, 8)), jnp.float32)
    w8 = jnp.asarray(rng.normal(0, 1, (12, 8)), jnp.float32)
    return {
        "blocks": {"b0": {"attn": {
            "wq": ref_prepare_weight(w4, RefSpec("int4", exact=True),
                                     act_scale=0.125),
            "wo": ref_prepare_weight(w8, RefSpec("int8", exact=True))}}},
        "emb": jnp.arange(24, dtype=jnp.bfloat16).reshape(4, 6),
        "pair": (jnp.ones(3, jnp.float32), None),
        "ids": [jnp.arange(5, dtype=jnp.int32)],
    }


def _bits(t):
    """A leaf's bytes, whichever package it comes from."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes(), tuple(t.shape)
    a = np.asarray(t)
    return a.tobytes(), a.shape


def _manifest(step_dir):
    with open(os.path.join(step_dir, "manifest.msgpack"), "rb") as f:
        return f.read()


# ------------------------------------------------ the port's own format

class TestSelfDescribingRestore:
    def test_prepared_tree_bit_exact_without_template(self, tmp_path):
        tree = _prepared_tree()
        save_checkpoint(str(tmp_path), 3, tree, {"policy": "int4"})
        out, meta = restore_checkpoint(str(tmp_path), 3, device="cpu")
        assert meta == {"policy": "int4"}
        for key in ("wq", "wo"):
            got = out["blocks"]["b0"]["attn"][key]
            want = tree["blocks"]["b0"]["attn"][key]
            assert isinstance(got, PreparedWeight) and got.kind == want.kind
            for f in ("data", "scale", "act_scale"):
                a, b = getattr(got, f), getattr(want, f)
                assert (a is None) == (b is None)
                if a is not None:
                    assert a.dtype == b.dtype and torch.equal(a, b)
        assert isinstance(out["pair"], tuple) and out["pair"][1] is None
        assert isinstance(out["ids"], list)
        assert out["emb"].dtype == torch.bfloat16
        assert torch.equal(out["emb"].view(torch.int16),
                           tree["emb"].view(torch.int16))

    def test_fp_and_per_group_tree_bit_exact(self, tmp_path):
        rng = np.random.default_rng(1)
        w8 = torch.from_numpy(rng.normal(0, 1, (32, 8)).astype(np.float32))
        w4 = torch.from_numpy(rng.normal(0, 1, (32, 8)).astype(np.float32))
        p8 = prepare_weight(w8, PrecisionSpec("fp8", group_size=8),
                            act_scale=0.25)
        p4 = prepare_weight(w4, PrecisionSpec("fp4"))
        assert p8.kind == "fp8" and p8.scale_groups == 4
        assert p4.kind == "fp4_packed"
        tree = {"fp8": p8, "fp4": p4}
        save_checkpoint(str(tmp_path), 1, tree, {"tier": "fp"})
        out, meta = restore_checkpoint(str(tmp_path), 1, device="cpu")
        assert meta == {"tier": "fp"}
        for key, want in tree.items():
            got = out[key]
            assert got.kind == want.kind and got.data.dtype == want.data.dtype
            assert torch.equal(got.data, want.data)
            assert torch.equal(got.scale, want.scale)
        assert torch.equal(out["fp8"].dequant(), p8.dequant())

    def test_like_template_still_casts(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, {"w": torch.ones((2, 3))})
        like = {"w": torch.zeros((2, 3), dtype=torch.bfloat16)}
        out, _ = restore_checkpoint(str(tmp_path), 1, like, device="cpu")
        assert out["w"].dtype == torch.bfloat16
        assert torch.equal(out["w"], like["w"] + 1)

    def test_like_shape_mismatch_is_checkpoint_error(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, {"w": torch.ones((2, 3))})
        with pytest.raises(CheckpointError, match="shape"):
            restore_checkpoint(str(tmp_path), 1,
                               {"w": torch.ones((3, 2))}, device="cpu")


class TestChecksums:
    def _corrupt(self, tmp_path, step, key):
        npz = os.path.join(str(tmp_path), f"step_{step:09d}", "arrays.npz")
        data = dict(np.load(npz))
        flat = data[key].reshape(-1).copy()
        if flat.dtype.kind in "iu":
            flat[0] ^= 1
        else:
            flat[0] = flat[0] + 1.0
        data[key] = flat.reshape(data[key].shape)
        np.savez(npz, **data)

    def test_corruption_raises_naming_leaf(self, tmp_path):
        tree = {"alpha": torch.arange(4, dtype=torch.int32),
                "beta": torch.ones(3)}
        save_checkpoint(str(tmp_path), 5, tree)
        self._corrupt(tmp_path, 5, "a0")        # leaf 0 == 'alpha'
        with pytest.raises(ChecksumError) as ei:
            restore_checkpoint(str(tmp_path), 5, device="cpu")
        assert "['alpha']" in str(ei.value)
        with pytest.raises(ChecksumError, match="alpha"):
            restore_checkpoint(str(tmp_path), 5, tree, device="cpu")

    def test_verify_off_skips_the_check(self, tmp_path):
        save_checkpoint(str(tmp_path), 5,
                        {"alpha": torch.arange(4, dtype=torch.int32)})
        self._corrupt(tmp_path, 5, "a0")
        out, _ = restore_checkpoint(str(tmp_path), 5, verify=False,
                                    device="cpu")
        assert out["alpha"].shape == (4,)

    def test_intact_checkpoint_verifies_clean(self, tmp_path):
        save_checkpoint(str(tmp_path), 2, _prepared_tree())
        restore_checkpoint(str(tmp_path), 2, device="cpu")


class TestMissBehavior:
    def test_restore_checkpoint_raises_not_found(self, tmp_path):
        with pytest.raises(CheckpointNotFound):
            restore_checkpoint(str(tmp_path), 9, device="cpu")
        save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(2)})
        with pytest.raises(CheckpointNotFound, match="have steps \\[1\\]"):
            restore_checkpoint(str(tmp_path), 9, device="cpu")

    def test_restore_latest_unified(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        with pytest.raises(CheckpointNotFound):
            mgr.restore_latest(device="cpu")
        assert mgr.restore_latest(missing_ok=True) == (None, None, {})
        with pytest.raises(FileNotFoundError):
            mgr.restore_latest(device="cpu")


class TestCrashSafetyAndGC:
    def test_leftover_tmp_ignored_and_cleaned(self, tmp_path):
        stale = tmp_path / "step_000000042.tmp"
        os.makedirs(stale)
        (stale / "arrays.npz").write_bytes(b"partial")
        assert latest_step(str(tmp_path)) is None
        assert list_steps(str(tmp_path)) == []
        mgr = CheckpointManager(str(tmp_path), keep=2)
        mgr.save(1, {"x": torch.zeros(2)})
        assert not stale.exists()
        assert list_steps(str(tmp_path)) == [1]

    def test_keep_last_k(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=1)
        for s in (1, 2, 3):
            mgr.save(s, {"x": torch.full((2,), float(s))})
        assert list_steps(str(tmp_path)) == [3]
        step, out, _ = mgr.restore_latest({"x": torch.zeros(2)},
                                          device="cpu")
        assert step == 3 and out["x"].tolist() == [3.0, 3.0]

    def test_save_over_same_step_replaces(self, tmp_path):
        save_checkpoint(str(tmp_path), 7, {"x": torch.zeros(2)})
        save_checkpoint(str(tmp_path), 7, {"x": torch.ones(2)})
        out, _ = restore_checkpoint(str(tmp_path), 7, device="cpu")
        assert out["x"].tolist() == [1.0, 1.0]


# -------------------------------------------- the codec and the paths

class TestCodec:
    VALUES = [None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536,
              2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129,
              -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63, 0.0, -0.0,
              1.5, 1e300, float("inf"), "", "a" * 31, "a" * 32, "a" * 255,
              "a" * 256, "a" * 65536, "héllo →", b"", b"x" * 300,
              list(range(15)), list(range(16)), list(range(70000)),
              (1, (2, 3)), {"k": None}, {str(i): i for i in range(16)},
              {str(i): [i, {"n": -i}] for i in range(70000)}]

    @pytest.mark.parametrize("i", range(len(VALUES)))
    def test_bytes_equal_msgpack(self, i):
        v = self.VALUES[i]
        assert _msgpack.packb(v) == msgpack.packb(v)
        assert _msgpack.unpackb(msgpack.packb(v)) == msgpack.unpackb(
            msgpack.packb(v))

    def test_refuses_what_a_manifest_never_holds(self):
        with pytest.raises(TypeError):
            _msgpack.packb(np.int64(3))
        with pytest.raises(TypeError):
            _msgpack.packb({1.5})
        with pytest.raises(ValueError, match="extra data"):
            _msgpack.unpackb(msgpack.packb(1) + b"\x00")
        with pytest.raises(ValueError, match="truncated"):
            _msgpack.unpackb(msgpack.packb("abc")[:-1])
        with pytest.raises(ValueError, match="key"):
            _msgpack.unpackb(msgpack.packb({1: 2}))


def test_paths_are_the_references_keystr():
    want = [jax.tree_util.keystr(kp) for kp, _ in
            jax.tree_util.tree_flatten_with_path(_ref_prepared_tree())[0]]
    assert _tree_paths(_prepared_tree()) == want
    assert want[0] == "['blocks']['b0']['attn']['wo'].data"


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """Port-written -> ``repro.checkpoint``: bit for bit, and the same
    manifest the reference writes for the same tree (its bytes too)."""
    tree = _prepared_tree()
    meta = {"policy": "int4", "n": [1, 2.5, None]}
    port_dir = save_checkpoint(str(tmp_path / "port"), 4, tree, meta)
    ref_dir = ref_save(str(tmp_path / "ref"), 4, _ref_prepared_tree(), meta)
    got, got_meta = ref_restore(str(tmp_path / "port"), 4)
    assert got_meta == meta
    got_leaves = jax.tree_util.tree_leaves(got)
    assert len(got_leaves) == len(tree_leaves_flat(tree))
    for a, b in zip(got_leaves, tree_leaves_flat(tree)):
        assert a.dtype.name == str(b.dtype).replace("torch.", "")
        assert _bits(a) == _bits(b)
    mine, theirs = (msgpack.unpackb(_manifest(d)) for d in (port_dir,
                                                             ref_dir))
    for key in ("paths", "shapes", "dtypes", "checksums", "tree_spec",
                "n_leaves", "version", "step", "metadata"):
        assert mine[key] == theirs[key], key
    assert set(mine["dtypes"]) == {"bfloat16", "float32", "int8", "int32"}
    assert _manifest(port_dir) == _manifest(ref_dir)
    assert _manifest(port_dir) == msgpack.packb(mine)


def tree_leaves_flat(tree):
    """Tensor leaves in the reference's flattening order."""
    return tree_manifest(tree)[1]


# ------------------------------------------------------ engine round trips

@pytest.fixture(scope="module")
def ref_ckpt():
    return reference("checkpoint")


def _register_fp_grouped():
    groups = {g.name: g.pattern
              for g in registry.projection_groups(reduced(ARCH))}
    register_policy(PrecisionPolicy("fp_grouped", rules=tuple(
        (pat, PrecisionSpec(mode, group_size=gs))
        for pat, mode, gs in fp_grouped_rules(groups))))


def _greedy(rid, prompt, budget, stops):
    return Request(rid=rid, prompt=prompt, max_new_tokens=budget,
                   sampling=SamplingParams(stop_ids=stops))


def _write(files, directory):
    step_dir = os.path.join(directory, "step_000000003")
    os.makedirs(step_dir)
    for name, data in files.items():
        with open(os.path.join(step_dir, name), "wb") as f:
            f.write(data)
    return step_dir


@pytest.mark.parametrize("policy", ["int4_serving", "fp_grouped"])
def test_reference_engine_checkpoint_rebuilds_in_the_port(
        ref_ckpt, policy, tmp_path, monkeypatch):
    _register_fp_grouped()
    want = ref_ckpt["cases"][policy]
    ckpt = str(tmp_path / "ckpt")
    _write(want["files"], ckpt)

    def refuse(*a, **k):
        raise AssertionError("the rebuild ran a calibration pass")
    monkeypatch.setattr(calibrate, "calibrate_act_scales", refuse)
    with count_weight_quant() as wq:
        eng = build_engine(ckpt, device="cpu")
    assert wq[0] == 0
    assert eng.prepared and eng.fused == want["fused"]
    assert eng.act_scales == want["scales"]
    if policy == "int4_serving":
        assert eng.config.cost_correction == "online"
    leaves = tree_leaves_flat(eng.params)
    assert len(leaves) == len(want["leaves"])
    for a, b in zip(leaves, want["leaves"]):
        assert str(a.dtype).replace("torch.", "") == b.dtype.name
        assert _bits(a) == _bits(b)
    assert eng.weight_quant_trace_count() == 0
    assert eng.act_quant_trace_count() == 0
    _, streams = drive_trace(lambda: eng, _greedy, {})
    assert streams == want["streams"]
    # saved again by the port: the reference's manifest, byte for byte
    again = save_engine_checkpoint(eng, str(tmp_path / "again"), step=3)
    assert _manifest(again) == want["files"]["manifest.msgpack"]


def test_port_engine_checkpoint_reads_in_the_reference(tmp_path):
    params = _ref_params()
    cfg = dataclasses.replace(reduced(ARCH), precision_policy="int4_serving")
    eng = ServingEngine(cfg, registry.build(cfg), params, config=EngineConfig(
        batch_slots=2, cache_len=64, act_calibration="auto"), device="cpu")
    save_engine_checkpoint(eng, str(tmp_path), step=0)
    rcfg, rconfig, rparams, rscales, _ = ref_load_engine(str(tmp_path))
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(
        dataclasses.replace(cfg))
    assert rconfig == RefEngineConfig(**dict(
        dataclasses.asdict(eng.config), act_calibration=rscales))
    assert rscales == eng.act_scales
    got = jax.tree_util.tree_leaves(rparams)
    mine = tree_leaves_flat(eng.params)
    assert len(got) == len(mine)
    for a, b in zip(got, mine):
        assert _bits(a) == _bits(b)


def test_rebuild_does_no_rework_where_a_fresh_engine_does(tmp_path,
                                                          monkeypatch):
    """The counters the no-rework checks read do count: a fresh calibrated
    int4 engine quantizes every projection and calibrates once; its
    rebuild does neither, and serves its streams."""
    calls = []
    real = calibrate.calibrate_act_scales
    monkeypatch.setattr(calibrate, "calibrate_act_scales",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = dataclasses.replace(reduced(ARCH), precision_policy="int4_serving")
    params = _ref_params()
    with count_weight_quant() as wq:
        eng = ServingEngine(cfg, registry.build(cfg), params,
                            config=EngineConfig(batch_slots=2, cache_len=64,
                                                act_calibration="auto"),
                            device="cpu")
    assert wq[0] >= 7 and calls == [1]
    save_engine_checkpoint(eng, str(tmp_path))
    with count_weight_quant() as wq:
        again = build_engine(str(tmp_path), device="cpu")
    assert wq[0] == 0 and calls == [1]
    _, a = drive_trace(lambda: eng, _greedy, {})
    _, b = drive_trace(lambda: again, _greedy, {})
    assert a == b


def _ref_params(arch=ARCH):
    """The reference's seeded ``reduced`` init, converted to the port."""
    from repro.configs import reduced as ref_reduced
    from repro.models import registry as ref_registry
    return to_torch(ref_registry.build(ref_reduced(arch)).init(
        jax.random.PRNGKey(0)))


def test_engine_checkpoint_corruption_names_the_leaf(tmp_path):
    tree = _prepared_tree()
    save_checkpoint(str(tmp_path), 0, tree)
    npz = os.path.join(str(tmp_path), "step_000000000", "arrays.npz")
    data = dict(np.load(npz))
    data["a2"] = data["a2"].copy()            # leaf 2: wq's packed bytes
    data["a2"].reshape(-1)[5] ^= np.int8(0x10)
    np.savez(npz, **data)
    with pytest.raises(ChecksumError,
                       match=r"\['blocks'\]\['b0'\]\['attn'\]\['wq'\]\.data"):
        restore_checkpoint(str(tmp_path), 0, device="cpu")


# ------------------------------------------- an MoE engine, both ways

MOE_ARCH = "mixtral-8x7b"


def _expert_stacks(params):
    moe = params["blocks"]["b0"]["moe"]
    return [moe[n]["w"] for n in ("w_gate", "w_up", "w_down")]


def test_reference_moe_engine_checkpoint_rebuilds_in_the_port(
        tmp_path, monkeypatch):
    """A reduced mixtral ``int4_serving`` engine saved by the reference:
    its 4-D packed expert stacks come through the manifest bit for bit,
    nothing is quantized or calibrated again, and the rebuilt engine
    serves the reference engine's streams."""
    want = reference("checkpoint", MOE_ARCH)["cases"]["int4_serving"]
    ckpt = str(tmp_path / "ckpt")
    _write(want["files"], ckpt)

    def refuse(*a, **k):
        raise AssertionError("the rebuild ran a calibration pass")
    monkeypatch.setattr(calibrate, "calibrate_act_scales", refuse)
    with count_weight_quant() as wq:
        eng = build_engine(ckpt, device="cpu")
    assert wq[0] == 0 and eng.cfg.moe is not None
    assert eng.fused == want["fused"] and eng.act_scales == want["scales"]
    leaves = tree_leaves_flat(eng.params)
    assert len(leaves) == len(want["leaves"])
    for a, b in zip(leaves, want["leaves"]):
        assert _bits(a) == _bits(b)
    cfg = eng.cfg
    for w in _expert_stacks(eng.params):
        assert isinstance(w, PreparedWeight) and w.kind == "int4_packed"
        assert w.data.dim() == 4 and w.data.shape[:2] == (
            cfg.n_layers, cfg.moe.n_experts)
    _, streams = drive_trace(lambda: eng, _greedy, {})
    assert streams == want["streams"]
    assert eng.weight_quant_trace_count() == 0
    again = save_engine_checkpoint(eng, str(tmp_path / "again"), step=3)
    assert _manifest(again) == want["files"]["manifest.msgpack"]


def test_port_moe_engine_checkpoint_rebuilds_in_the_reference(tmp_path):
    """The other way: a port-saved reduced mixtral ``int4_serving``
    engine, rebuilt by the reference's ``build_engine`` (in a
    subprocess), has the port's leaves bit for bit, quantizes nothing
    and serves the port engine's streams."""
    cfg = dataclasses.replace(reduced(MOE_ARCH),
                              precision_policy="int4_serving")
    eng = ServingEngine(cfg, registry.build(cfg), _ref_params(MOE_ARCH),
                        config=EngineConfig(batch_slots=2, cache_len=64,
                                            prefill_chunk=4, decode_block=2,
                                            act_calibration="auto"),
                        device="cpu")
    save_engine_checkpoint(eng, str(tmp_path), step=1)
    mine = tree_leaves_flat(eng.params)
    _, streams = drive_trace(lambda: eng, _greedy, {})
    got = run_references("rebuild", [None], env_extra={
        "REPRO_PARITY_CHECKPOINT": str(tmp_path)})[None]
    assert got["weight_quant"] == 0
    assert got["fused"] == eng.fused is True
    assert got["scales"] == eng.act_scales
    assert len(got["leaves"]) == len(mine)
    for a, b in zip(got["leaves"], mine):
        assert _bits(a) == _bits(b)
    assert got["streams"] == streams


# ------------------------------------------------------------ config schema

def test_engine_config_fields_are_the_references():
    mine = {f.name: f.default for f in dataclasses.fields(EngineConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(RefEngineConfig)}
    assert mine == theirs
    for bad in (dict(prefill="eager"), dict(cost_correction="maybe")):
        with pytest.raises(ValueError):
            EngineConfig(**bad)


def test_teacher_prefill_is_refused_and_batched_serves_as_auto():
    """Every prefill mode an engine config can carry serves: "batched"
    as "auto" (chunked waves for lm), and "teacher" (once refused by the
    port's engine, now teacher-forced admission) with the same streams
    and a teacher-forced step per prompt token but the last."""
    params = _ref_params()
    cfg = reduced(ARCH)

    def engine(prefill):
        return ServingEngine(cfg, registry.build(cfg), params,
                             config=EngineConfig(batch_slots=2, cache_len=64,
                                                 prefill_chunk=4,
                                                 prefill=prefill),
                             device="cpu")
    teacher, streams = drive_trace(lambda: engine("teacher"), _greedy, {})
    assert teacher.counters["teacher_forced_tokens"] > 0
    assert teacher.counters["prefill_calls"] == 0
    assert drive_trace(lambda: engine("batched"), _greedy, {})[1] \
        == drive_trace(lambda: engine("auto"), _greedy, {})[1] == streams


def test_config_dicts_round_trip_and_refuse_drift():
    cfg = dataclasses.replace(reduced(ARCH), rec_pattern=("rec", "attn"))
    d = _msgpack.unpackb(_msgpack.packb(model_config_to_dict(cfg)))
    assert isinstance(d["rec_pattern"], list)
    assert model_config_from_dict(d) == cfg
    with pytest.raises(ValueError, match="unknown fields"):
        model_config_from_dict(dict(d, flux=1))
    with pytest.raises(ValueError, match="unknown fields"):
        engine_config_from_dict({"batch_slots": 2, "turbo": True}, None)
    assert engine_config_from_dict({"batch_slots": 2}, {"p": 0.5}) \
        == EngineConfig(batch_slots=2, act_calibration={"p": 0.5})
    with pytest.raises(CheckpointNotFound):
        load_engine_checkpoint(os.devnull + "_missing", device="cpu")
