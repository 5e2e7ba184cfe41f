"""The port's sharding on 8 gloo CPU ranks (``tests/_torch_multidev.py``),
spawned once for the whole file (about 95 s alone on 8 cores), each case
held to the port's own run on plain tensors on one device:

* *lower* (``tests/test_multidevice.py``'s 11 (arch, mesh) cases,
  "single" (2, 4) ("data", "model"), "multi" (2, 2, 2) ("pod", "data",
  "model")): every leaf of the sharded state is a DTensor at its rule's
  placements with the spec's local shape, before and after one step;
  the step's loss and parameters against the plain step's;
* *run*: 3 steps each of qwen2-0.5b single, mixtral-8x7b multi and
  rwkv6-1.6b single, and one step of qwen2-0.5b in 2 microbatches; the
  input state stays as it was;
* *elastic*: a state saved on (2, 4) writes the plain save's bytes,
  restores on (4, 2) through ``restore_latest(shardings=)`` and
  ``elastic_reshard`` (the two equal) and steps;
* *serve*: ``make_serve_fns`` on (2, 4) for qwen2-0.5b and
  recurrentgemma-9b under bf16 and qwen2-0.5b under ``fidelity_int8``
  and ``fidelity_fp16_ipu`` (whose kernels' plain versions run on the
  local shards, K whole): greedy streams identical to one device, the
  logits too (the reading: max abs 0.0 for all four, so no near tie is
  left to name), and as many per-call weight quantizations;
* *cli*: ``launch.train.run`` across the 8 ranks on its (1, 8) mesh;
* *exchange*: ``parallel.blockfp.make_pod_exchange`` on (2, 2, 2) over
  ``tests/test_blockfp.py``'s gradients, held to the JAX reference's
  exchange on 8 host devices (one ``_jax_reference.py blockfp``
  subprocess): each output's global shape, spec and placements; f32
  and int8 bit-equal; blockfp8 bit-equal to ``np.ldexp`` of the
  reference's own aligned mantissa sums and within ``EXCHANGE_RTOL``
  of its outputs (its ``jnp.exp2`` scale is inexact, ``ROADMAP.md``
  §3); the all-gather bytes per chip equal to its
  ``parse_collectives`` (18,432 f32, 4,608 int8 and blockfp8), and f32
  at least 3.5x either compressed exchange's total; the same with a
  ``fsdp_spec_fn`` of its own (``_jax_reference.exchange_spec``), and
  ``compress_grads`` (int8, blockfp8) on the local shards against the
  reference's in a ``shard_map`` with the exchange's specs.

Bounds are set from this file's readings (gloo, one intra-op thread per
rank), about five times each and never above ten; each reading stands
beside its bound. Where the reading is 0 the bound is 0: one AdamW step
from equal moments moves every parameter by the same amount however
the gradients' partial sums were ordered, and the fidelity kernels see
the one-device operands.
"""
import math

import numpy as np
import pytest

import _torch_multidev as md
from _torch_parity import run_references

# lower: loss abs (reading 0 or one f32 ulp at 6.7, 4.8e-7), params
# after one step (reading 0.0 in all 11)
LOWER_LOSS = 2.4e-6
LOWER_PARAMS = 0.0
# run, per case: loss abs, params abs, AdamW moments abs after the steps
RUN_BOUNDS = {
    "run/qwen2-0.5b/single/mb1": (6.7e-4, 5.4e-5, 3.7e-4),  # 1.3e-4 1.1e-5 7.3e-5
    "run/mixtral-8x7b/multi/mb1": (4.5e-5, 5.7e-5, 2.2e-4),  # 9.1e-6 1.1e-5 4.4e-5
    "run/rwkv6-1.6b/single/mb1": (1.1e-3, 5.7e-5, 3.6e-4),   # 2.2e-4 1.1e-5 7.1e-5
    "run/qwen2-0.5b/single/mb2": (0.0, 0.0, 1.9e-4),         # 0      0      3.7e-5
}
ELASTIC_LOSS, ELASTIC_PARAMS = 2.4e-6, 2.9e-5     # 4.8e-7 5.8e-6
CLI_LOSS, CLI_PARAMS = 5.6e-3, 1.1e-4             # 1.1e-3 2.1e-5
# blockfp8 against the reference's outputs, elementwise relative: its
# scale is XLA's exp2 of an integer-valued f32, off by up to 4.05e-6
# relative (the reading: 5.2e-7); where its scale is below 2^-125 the
# reference underflows (tests/test_torch_blockfp.py covers that range)
EXCHANGE_RTOL = 4.1e-6


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return md.run_all(str(tmp_path_factory.mktemp("multidev") / "out.pkl"))


def _case(results, name):
    r = results[name]
    assert "error" not in r, r["error"]
    return r


def _loss_err(r):
    assert len(r["losses"]) == len(r["plain_losses"])
    assert all(math.isfinite(x) for x in r["losses"])
    return max(abs(a - b) for a, b in zip(r["losses"], r["plain_losses"]))


@pytest.mark.parametrize("arch,mesh", md.LOWER)
def test_train_lowers_on_mesh(results, arch, mesh):
    r = _case(results, f"lower/{arch}/{mesh}")
    assert r["faults"] == []
    assert _loss_err(r) <= LOWER_LOSS
    assert r["param_err"] <= LOWER_PARAMS


@pytest.mark.parametrize("arch,mesh,mb,steps", md.RUN)
def test_train_runs_real_steps(results, arch, mesh, mb, steps):
    name = f"run/{arch}/{mesh}/mb{mb}"
    r = _case(results, name)
    loss_b, param_b, opt_b = RUN_BOUNDS[name]
    assert len(r["losses"]) == steps
    assert _loss_err(r) <= loss_b
    assert r["param_err"] <= param_b
    assert r["opt_err"] <= opt_b
    assert r["input_changed"] == 0.0


def test_elastic_reshard_across_topologies(results):
    r = _case(results, "elastic")
    assert r["step"] == 1 and r["faults"] == []
    assert r["same_bytes"]["manifest.msgpack"]
    assert r["same_bytes"]["arrays.npz"] or r["same_bytes"]["arrays"]
    assert r["elastic_vs_restore"] == 0.0
    assert _loss_err(r) <= ELASTIC_LOSS
    assert r["param_err"] <= ELASTIC_PARAMS


@pytest.mark.parametrize("arch,policy,n_new", md.SERVE)
def test_serve_fns_on_mesh(results, arch, policy, n_new):
    r = _case(results, f"serve/{arch}/{policy}")
    assert r["tokens"].shape == (8, n_new)
    np.testing.assert_array_equal(r["tokens"], r["plain_tokens"])
    assert r["logit_err"] == 0.0
    assert r["weight_quants"] == r["plain_weight_quants"]
    if policy != "bf16":
        assert r["weight_quants"] > 0


def test_trainer_cli_runs_across_ranks(results):
    r = _case(results, "cli")
    assert r["step"] == 4
    assert _loss_err(r) <= CLI_LOSS
    assert r["param_err"] <= CLI_PARAMS


@pytest.fixture(scope="module")
def exchange_reference():
    return run_references("blockfp", [None], env_extra={
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8 "
                     "--xla_allow_excess_precision=false"})[None]


def _check_layout(r, ref):
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.parallel import sharding as shd
    mesh = abstract_mesh(*md.MESHES["multi"])
    assert set(r["leaves"]) == set(ref)
    for name, leaf in r["leaves"].items():
        assert leaf["shape"] == ref[name]["shape"], name
        assert leaf["spec"] == ref[name]["spec"], name
        assert leaf["placements"] == leaf["want_placements"] == \
            shd.placements(ref[name]["spec"], mesh), name
        assert leaf["dtype"] == "torch.float32"


def _check_values(r, ref_leaves, method):
    for name, ref in ref_leaves.items():
        got, want = r["leaves"][name]["values"], ref["values"]
        assert got.shape == want.shape and got.dtype == np.float32
        if method != "blockfp8":
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))
            continue
        np.testing.assert_array_equal(got.view(np.int32),
                                      ref["ldexp"].view(np.int32))
        # every block of these gradients (about 1e-3) has its scale
        # near 2^-16, far above 2^-125
        keep = want != 0
        assert np.abs(want).max() < 1.0 and keep.mean() > 0.9
        rel = np.abs(got - want)[keep] / np.abs(want)[keep]
        assert rel.max() <= EXCHANGE_RTOL, (name, rel.max())


@pytest.mark.parametrize("method", md.EXCHANGE_METHODS)
def test_pod_exchange_layout_matches_reference(results, exchange_reference,
                                               method):
    _check_layout(_case(results, f"exchange/{method}"),
                  exchange_reference[method]["leaves"])


@pytest.mark.parametrize("method", md.EXCHANGE_METHODS)
def test_pod_exchange_values_match_reference(results, exchange_reference,
                                             method):
    _check_values(_case(results, f"exchange/{method}"),
                  exchange_reference[method]["leaves"], method)


@pytest.mark.parametrize("method", md.EXCHANGE_METHODS)
def test_pod_exchange_wire_bytes_match_reference(results, exchange_reference,
                                                 method):
    r = _case(results, f"exchange/{method}")
    ref = exchange_reference[method]["by_op"]
    assert r["by_op"]["all-gather"] == ref["all-gather"]
    assert r["by_op"]["all-gather"] == {"f32": 18432.0}.get(method, 4608.0)
    f32 = _case(results, "exchange/f32")["total_bytes"]
    if method != "f32":
        assert f32 / r["total_bytes"] >= 3.5


@pytest.mark.parametrize("method", md.EXCHANGE_METHODS)
def test_pod_exchange_with_a_spec_fn_matches_reference(
        results, exchange_reference, method):
    """``fsdp_spec_fn=exchange_spec`` (rows or columns over ('data',
    'model'), so other local shards and block boundaries than the
    default's): layout, values and all-gather bytes as the reference's
    under the same function."""
    key = f"fsdp/{method}"
    r, ref = _case(results, f"exchange/{key}"), exchange_reference[key]
    assert r["leaves"]["embed"]["spec"] == (None, None, ("data", "model"))
    _check_layout(r, ref["leaves"])
    _check_values(r, ref["leaves"], method)
    assert r["by_op"]["all-gather"] == ref["by_op"]["all-gather"]


@pytest.mark.parametrize("method", md.COMPRESS_METHODS)
def test_compress_grads_match_reference(results, exchange_reference,
                                        method):
    """``compress_grads`` over the 'pod' group on local shards, against
    the reference's in a ``shard_map`` with the same specs: the sums
    (not averages) bit-equal (int8) or as the exchange's values
    (blockfp8); all-gather bytes as the reference's; "f32" refused."""
    key = f"compress/{method}"
    r, ref = _case(results, key), exchange_reference[key]
    _check_layout(r, ref["leaves"])
    _check_values(r, ref["leaves"], method)
    assert r["by_op"]["all-gather"] == ref["by_op"]["all-gather"] == 4608.0
    assert "ValueError" in r["refuses"] and \
        "ValueError" in exchange_reference["compress_refuses"]
