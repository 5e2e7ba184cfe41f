"""Training on one device (``repro_torch.{optim,data,launch}``, the
models' ``loss_fn``) against the JAX reference, on the CPU.

* The optimizer on shared numpy inputs: three AdamW steps (clipped and
  not, each ``lr_scale`` its own), ``clip_by_global_norm``,
  ``warmup_cosine`` over three schedules, a loss-scale trace through
  growth and halving, ``grads_finite``; and the port's mirror of
  ``tests/test_substrates.py``'s ``TestOptim`` and ``TestData``
  (restart determinism, host slicing, the Markov structure on the
  reference's own transition table).
* ``fused_chunked_xent`` against ``next_token_xent`` and against the
  reference, with S a multiple of the chunk and not, masked and not:
  loss and the gradients of the hidden states and the head.
* Reduced qwen2-0.5b's ``loss_fn`` and gradients on the reference's
  converted weights under ``fp32`` (f32 activations too), ``bf16`` (with
  and without a mask) and ``int8_serving`` (straight-through fake
  quant); ``remat`` "full" and "dots" give the gradients of "none"
  exactly.
* Three whole steps (the step of ``make_train_step``) against the
  reference's ``_grad_step`` + ``_apply_updates`` under ``jax.jit`` (its
  ``make_train_step`` needs a device mesh): plain, and with
  ``microbatches=2, use_loss_scaling=True``, both under ``bf16``; every
  metric and the state after each step. An injected inf skips the update
  and halves the scale.
* The trainer CLI under ``FaultTolerantLoop``: killed by
  ``fail_at_step`` and resumed, its losses and final state are bit-equal
  to an uninterrupted run's. A ``TrainState`` checkpoint the reference
  wrote after two steps restores in the port (the optimizer state too)
  and the port's third step is the reference's.

Tolerances (the measured worst case beside each):

* loss: 1e-6 relative under ``fp32`` and ``int8_serving`` (measured 0
  and 0), 5e-5 under ``bf16`` (8.6e-6);
* gradients: each leaf within a relative L2 error (``_rel_l2``) of
  1e-2 under ``fp32`` and ``bf16`` (measured 3.3e-3 and 3.7e-3) and
  1e-5 under ``int8_serving`` (2.9e-6: its fake-quantized weights and
  per-token activation codes round both packages' operands alike).
  fp32 cannot be held to f32 rounding (1e-4) against the
  jitted reference: its ``mp_linear`` rounds every projection's output to bf16
  (its ``compute_dtype`` defaults to bf16 and no layer passes the
  config's), so even ``fp32`` with f32 activations carries bf16
  cotangents, and a backward through them turns f32 summation-order
  differences of 1e-7 into bf16 rounding flips. The same happens inside
  the reference: its own jitted and op-by-op gradients differ by 3e-3
  under ``bf16``. Against the op-by-op reference the port's ``bf16``
  gradients agree to 3e-6 (measured 6.9e-7): both round at the same
  places and sum their cotangents in the same order;
* whole steps: the loss within 1e-3 relative (measured 1.8e-4: from
  the second step on it sees weights the first step's gradients moved),
  ``grad_norm`` within 3e-3 (6.1e-4); after each step the whole
  parameter tree within 5e-4 relative L2 (9.6e-5) and its change since
  step 0 within 3e-2 (1.04e-2), the moments ``m`` and ``v`` each leaf
  within 3e-2 (1.5e-2). The third step from the reference's checkpoint
  holds its loss to 1e-4 (9.1e-5, the step losses' size; it runs on
  the weights the reference wrote). Per leaf the parameters cannot be
  held so: a
  leaf whose gradient is mostly rounding noise (the K bias, whose
  gradient RoPE alone keeps from cancelling to zero) takes AdamW steps
  of +-lr whose signs that noise sets, in both packages;
* optimizer pieces and the fused xent: 1e-6 relative (f32 arithmetic
  in a different order).

One reference subprocess (``_torch_parity.reference("train")``).
"""
import dataclasses
import math
import os
import re

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
from repro_torch.checkpoint.checkpoint import _tree_paths
from repro_torch.configs import InputShape, reduced
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.data.pipeline import (DataConfig, SyntheticLMDataset,
                                       _transition_table, batch_for)
from repro_torch.launch import train
from repro_torch.launch.train import (TrainConfig, TrainState, init_state,
                                      make_train_step)
from repro_torch.models import registry
from repro_torch.models.losses import fused_chunked_xent, next_token_xent
from repro_torch.optim import (AdamWConfig, AdamWState, LossScaleState,
                               adamw_init, adamw_update, clip_by_global_norm,
                               grads_finite, loss_scale_init,
                               loss_scale_update, warmup_cosine)
from repro_torch.optim.tree import flatten, tree_leaves, tree_map
from repro_torch.runtime.fault_tolerance import WorkerFailure, fail_at_step

from _jax_reference import (LOSS_SCALE_FLAGS, N_STEPS, SCHEDULE_STEPS,
                            STEP_CASES, TRAIN_ARCH, TRAIN_POLICIES,
                            TRAIN_SEQ, XENT_CASES, optim_inputs, step_config,
                            train_mask, train_tokens, xent_inputs)
from _torch_parity import one_intra_op_thread  # noqa: F401 (autouse)
from _torch_parity import flat, reference

# (loss relative, gradient leaf relative L2) per policy; the measured
# worst case beside each
TOL = {"fp32": (1e-6, 1e-2),                  # 0       3.3e-3
       "bf16": (5e-5, 1e-2),                  # 8.6e-6  3.7e-3
       "int8_serving": (1e-6, 1e-5)}          # 0       2.9e-6
# the port's bf16 gradients against the reference's op by op (6.9e-7)
EAGER_GRAD_RTOL = 3e-6
# whole steps: loss (1.8e-4); grad_norm (6.1e-4); the parameter tree
# (9.6e-5); its change since step 0 (1.04e-2); each moment leaf
# (1.5e-2); the loss of the step from the reference's checkpoint
# (9.1e-5)
STEP_LOSS_RTOL = 1e-3
GRAD_NORM_RTOL = 3e-3
PARAM_RTOL = 5e-4
UPDATE_RTOL = 3e-2
MOMENT_RTOL = 3e-2
RESUMED_LOSS_RTOL = 1e-4
F32_RTOL = 1e-6


@pytest.fixture(scope="module")
def ref():
    return reference("train")


def _cfg(policy, **kw):
    cfg = reduced(TRAIN_ARCH)
    if policy == "fp32":
        kw.setdefault("compute_dtype", "float32")
    return dataclasses.replace(cfg, precision_policy=policy, **kw)


def _np_to_torch(tree):
    return params_from_numpy(tree, device="cpu")


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _plain(tree):
    """NamedTuples as plain tuples (``to_numpy`` makes the port's so)."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree] if isinstance(tree, list) \
            else tuple(_plain(v) for v in tree)
    return tree


def _assert_leaves(got, want, rtol, what):
    got, want = flat(to_numpy(got)), flat(_plain(want))
    assert got.keys() == want.keys(), what
    for path, a in got.items():
        b = np.asarray(want[path])
        assert a.shape == b.shape, (what, path)
        if not np.issubdtype(b.dtype, np.floating):
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {path}")
            continue
        err = _rel_l2(a, b)
        assert err <= rtol, (what, path, err)


def _concat(tree):
    return np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in flat(_plain(tree)).values()])


def _assert_params(got, want, start, what):
    """The whole tree within ``PARAM_RTOL``, its change since ``start``
    within ``UPDATE_RTOL`` (relative L2 over every leaf at once)."""
    a, b, a0 = _concat(to_numpy(got)), _concat(want), _concat(start)
    assert a.shape == b.shape, what
    assert _rel_l2(a, b) <= PARAM_RTOL, (what, _rel_l2(a, b))
    if np.any(b != a0):
        assert _rel_l2(a - a0, b - a0) <= UPDATE_RTOL, (
            what, _rel_l2(a - a0, b - a0))


def _grads(api, params, batch):
    leaves, unflatten = flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss, metrics = api.loss_fn(unflatten(live), batch)
    grads = torch.autograd.grad(loss, live)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(list(grads)))


# ------------------------------------------------------------ optimizer

def _torch_tree(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("name", ("default", "no_clip"))
def test_adamw_matches_reference(ref, name):
    cfg = {"default": AdamWConfig(),
           "no_clip": AdamWConfig(lr=0.1, weight_decay=0.0,
                                  grad_clip=None)}[name]
    params, grads = optim_inputs()
    p = _torch_tree(params)
    st = adamw_init(p)
    for i, (g, want) in enumerate(zip(grads, ref["optim"]["adamw"][name])):
        p, st, m = adamw_update(cfg, p, _torch_tree(g), st,
                                lr_scale=0.5 + 0.25 * i)
        assert int(st.step) == want["step"]
        assert float(m["grad_norm"]) == pytest.approx(want["grad_norm"],
                                                      rel=F32_RTOL)
        for got, exp in ((p, want["params"]), (st.m, want["m"]),
                         (st.v, want["v"])):
            for path, a in flat(to_numpy(got)).items():
                np.testing.assert_allclose(a, flat(exp)[path],
                                           rtol=F32_RTOL, atol=1e-7,
                                           err_msg=f"{name} {i} {path}")


def test_clip_matches_reference(ref):
    _, grads = optim_inputs()
    clipped, norm = clip_by_global_norm(_torch_tree(grads[1]), 0.5)
    want = ref["optim"]["clip"]
    assert float(norm) == pytest.approx(want["norm"], rel=F32_RTOL)
    for path, a in flat(to_numpy(clipped)).items():
        np.testing.assert_allclose(a, flat(want["grads"])[path],
                                   rtol=F32_RTOL, atol=1e-7)
    assert math.sqrt(sum(float((a ** 2).sum())
                         for a in flat(to_numpy(clipped)).values())) \
        == pytest.approx(0.5, rel=1e-5)


def test_schedule_matches_reference(ref):
    for (w, t), want in ref["optim"]["schedule"].items():
        got = [float(warmup_cosine(s, warmup=w, total=t))
               for s in SCHEDULE_STEPS]
        np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=1e-7,
                                   err_msg=f"warmup={w} total={t}")
    # a () int32 step on the state's device takes the same path
    assert float(warmup_cosine(torch.tensor(50, dtype=torch.int32),
                               warmup=100, total=10_000)) == \
        ref["optim"]["schedule"][(100, 10_000)][SCHEDULE_STEPS.index(50)]


def test_loss_scale_trace_matches_reference(ref):
    st = loss_scale_init(1024.0)
    trace = []
    for fin in LOSS_SCALE_FLAGS:
        st = loss_scale_update(st, torch.tensor(fin), growth_interval=3)
        assert st.scale.dtype == torch.float32
        assert st.good_steps.dtype == torch.int32
        trace.append((float(st.scale), int(st.good_steps)))
    assert trace == ref["optim"]["loss_scale"]


def test_grads_finite_matches_reference(ref):
    _, grads = optim_inputs()
    got = [bool(grads_finite(_torch_tree(grads[0]))),
           bool(grads_finite({"a": torch.tensor([1.0, math.inf])}))]
    assert got == ref["optim"]["finite"] == [True, False]


class TestOptim:
    """``tests/test_substrates.py::TestOptim`` on the port."""

    def test_adamw_converges_quadratic(self):
        params = {"w": torch.tensor([4.0, -3.0])}
        state = adamw_init(params)
        cfg = AdamWConfig(lr=0.1, weight_decay=0.0, grad_clip=None)
        for _ in range(200):
            grads = {"w": 2 * params["w"]}
            params, state, _ = adamw_update(cfg, params, grads, state)
        assert float(params["w"].abs().max()) < 0.05

    def test_grad_clip(self):
        cfg = AdamWConfig(grad_clip=1.0)
        params = {"w": torch.ones(4)}
        state = adamw_init(params)
        grads = {"w": torch.full((4,), 100.0)}
        _, _, m = adamw_update(cfg, params, grads, state)
        assert m["grad_norm"] > 100

    def test_schedule(self):
        assert float(warmup_cosine(0, warmup=10, total=100)) == 0.0
        assert float(warmup_cosine(10, warmup=10, total=100)) == \
            pytest.approx(1.0)
        assert float(warmup_cosine(100, warmup=10, total=100)) == \
            pytest.approx(0.1)

    def test_loss_scale_dynamics(self):
        st = loss_scale_init(1024.0)
        st = loss_scale_update(st, torch.tensor(False))
        assert float(st.scale) == 512.0
        for _ in range(2000):
            st = loss_scale_update(st, torch.tensor(True))
        assert float(st.scale) > 512.0

    def test_grads_finite(self):
        assert bool(grads_finite({"a": torch.ones(3)}))
        assert not bool(grads_finite({"a": torch.tensor([1.0, math.nan])}))

    def test_update_leaves_its_inputs_alone(self):
        params = {"w": torch.ones(3)}
        state = adamw_init(params)
        before = [t.clone() for t in tree_leaves((params, state))]
        adamw_update(AdamWConfig(), params, {"w": torch.ones(3)}, state)
        assert all(torch.equal(a, b) for a, b in
                   zip(before, tree_leaves((params, state))))


class TestData:
    """``tests/test_substrates.py::TestData`` on the port."""

    def test_deterministic_across_restarts(self):
        cfg = DataConfig(vocab=256, seq_len=32, global_batch=8, seed=3)
        a = SyntheticLMDataset(cfg, device="cpu").batch(5)["tokens"]
        b = SyntheticLMDataset(cfg, device="cpu").batch(5)["tokens"]
        assert torch.equal(a, b) and a.dtype == torch.int32
        c = SyntheticLMDataset(cfg, device="cpu").batch(6)["tokens"]
        assert not torch.equal(a, c)

    def test_host_sharding_partitions_batch(self):
        cfg = DataConfig(vocab=256, seq_len=16, global_batch=8, seed=0)
        h0 = SyntheticLMDataset(cfg, 0, 2, device="cpu").batch(0)["tokens"]
        h1 = SyntheticLMDataset(cfg, 1, 2, device="cpu").batch(0)["tokens"]
        assert h0.shape == (4, 17) and h1.shape == (4, 17)
        assert not torch.equal(h0, h1)

    def test_markov_structure_learnable(self):
        """Next token is always one of the 16 successors of the current,
        on the reference's own transition table."""
        from repro.data.pipeline import DataConfig as RefDataConfig
        from repro.data.pipeline import _transition_table as ref_table
        cfg = DataConfig(vocab=128, seq_len=64, global_batch=4, seed=1)
        table = _transition_table(cfg)
        np.testing.assert_array_equal(
            table, ref_table(RefDataConfig(vocab=128, seq_len=64,
                                           global_batch=4, seed=1)))
        toks = SyntheticLMDataset(cfg, device="cpu").batch(0)["tokens"]
        for row in toks.numpy():
            for t in range(len(row) - 1):
                assert row[t + 1] in table[row[t]]

    def test_batch_for_stubs(self):
        shape = InputShape("t", 32, 4, "train")
        vlm = batch_for(reduced("internvl2-1b"), shape, 2, device="cpu")
        assert vlm["tokens"].shape == (4, 33)
        assert vlm["patches"].shape == (4, 8, 32)
        enc = batch_for(reduced("seamless-m4t-medium"), shape, 2,
                        device="cpu")
        assert enc["frames"].shape == (4, 8, 16)
        again = batch_for(reduced("seamless-m4t-medium"), shape, 2,
                          device="cpu")
        assert torch.equal(enc["frames"], again["frames"])

    def test_materialize_batch_matches_input_specs(self):
        cfg = reduced("internvl2-1b")
        for kind in ("train", "prefill", "decode"):
            shape = InputShape(kind, 16, 2, kind)
            specs = registry.input_specs(cfg, shape)
            batch = registry.materialize_batch(cfg, shape, device="cpu")
            assert batch.keys() == specs.keys()
            for k, spec in specs.items():
                assert tuple(batch[k].shape) == spec.shape
                assert batch[k].dtype == spec.dtype


# ------------------------------------------------------------- the loss

@pytest.mark.parametrize("case", XENT_CASES,
                         ids=[f"s{s}-c{c}-{'mask' if m else 'all'}"
                              for s, c, m in XENT_CASES])
def test_fused_chunked_xent(ref, case):
    s, chunk, masked = case
    inp = xent_inputs(s, masked)
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    w = torch.from_numpy(inp["w"]).requires_grad_(True)
    t = torch.from_numpy(inp["targets"])
    mask = torch.from_numpy(inp["mask"]) if masked else None
    loss, m = fused_chunked_xent(x, lambda xc: xc @ w, t, mask, chunk=chunk)
    assert m["nll"] is loss
    gx, gw = torch.autograd.grad(loss, (x, w))
    plain, _ = next_token_xent(x @ w, t, mask)
    px, pw = torch.autograd.grad(plain, (x, w))
    want = ref["xent"][case]
    for name, (lv, ax, aw) in (("fused", (loss, gx, gw)),
                               ("plain", (plain, px, pw))):
        for rl, rx, rw in (want["fused"], want["plain"]):
            assert float(lv.detach()) == pytest.approx(rl, rel=F32_RTOL), name
            np.testing.assert_allclose(ax.numpy(), rx, rtol=1e-5,
                                       atol=1e-7, err_msg=name)
            np.testing.assert_allclose(aw.numpy(), rw, rtol=1e-5,
                                       atol=1e-7, err_msg=name)


# ------------------------------------------------------ loss and grads

@pytest.mark.parametrize("policy,masked",
                         [(p, False) for p in TRAIN_POLICIES]
                         + [("bf16", True)])
def test_loss_and_gradients(ref, policy, masked):
    api = registry.build(_cfg(policy))
    params = _np_to_torch(ref["params"])
    tokens = train_tokens(512, 2, TRAIN_SEQ, 0)
    batch = {"tokens": torch.from_numpy(tokens)}
    if masked:
        batch["mask"] = torch.from_numpy(train_mask(2, TRAIN_SEQ, 1))
    loss, metrics, grads = _grads(api, params, batch)
    want = ref["loss"][(policy, masked)]
    loss_tol, grad_tol = TOL[policy]
    assert float(loss) == pytest.approx(want["loss"], rel=loss_tol)
    assert float(metrics["nll"]) == pytest.approx(want["metrics"]["nll"],
                                                  rel=loss_tol)
    assert float(metrics["aux"]) == want["metrics"]["aux"] == 0.0
    _assert_leaves(grads, want["grads"], grad_tol, policy)


def test_bf16_gradients_match_the_reference_op_by_op(ref):
    api = registry.build(_cfg("bf16"))
    batch = {"tokens": torch.from_numpy(train_tokens(512, 2, TRAIN_SEQ,
                                                     0))}
    loss, _, grads = _grads(api, _np_to_torch(ref["params"]), batch)
    want = ref["loss_eager"]
    assert float(loss) == pytest.approx(want["loss"], rel=F32_RTOL)
    _assert_leaves(grads, want["grads"], EAGER_GRAD_RTOL, "op by op")


@pytest.mark.parametrize("remat", ("full", "dots"))
def test_remat_settings_give_equal_gradients(ref, remat):
    params = _np_to_torch(ref["params"])
    batch = {"tokens": torch.from_numpy(train_tokens(512, 2, TRAIN_SEQ,
                                                     0))}
    base = _grads(registry.build(_cfg("bf16", remat="none")), params, batch)
    got = _grads(registry.build(_cfg("bf16", remat=remat)), params, batch)
    assert torch.equal(got[0], base[0])
    for a, b in zip(tree_leaves(got[2]), tree_leaves(base[2])):
        assert torch.equal(a, b)


# ---------------------------------------------------------- whole steps

def _port_train_config(case):
    kw = step_config(case)
    return TrainConfig(adamw=AdamWConfig(lr=kw.pop("lr")), **kw)


@pytest.mark.parametrize("case", tuple(STEP_CASES))
def test_whole_steps_match_reference(ref, case):
    policy, _, b = STEP_CASES[case]
    api = registry.build(_cfg(policy))
    step = make_train_step(api, _port_train_config(case))
    state = init_state(api, _np_to_torch(ref["params"]))
    want = ref["steps"][case]
    for i in range(N_STEPS):
        batch = {"tokens": torch.from_numpy(
            train_tokens(512, b, TRAIN_SEQ, 100 + i))}
        state, m = step(state, batch)
        wm = want["metrics"][i]
        assert list(m) == ["loss", "finite", "nll", "aux", "grad_norm",
                           "loss_scale"]
        assert m.keys() == wm.keys()
        assert float(m["loss"]) == pytest.approx(wm["loss"],
                                                 rel=STEP_LOSS_RTOL)
        assert float(m["nll"]) == pytest.approx(wm["nll"],
                                                rel=STEP_LOSS_RTOL)
        assert float(m["grad_norm"]) == pytest.approx(wm["grad_norm"],
                                                      rel=GRAD_NORM_RTOL)
        for k in ("finite", "aux", "loss_scale"):
            assert float(m[k]) == wm[k], k
        ws = want["states"][i]
        assert int(state.step) == int(ws[3]) == i + 1
        assert int(state.opt.step) == int(ws[1][0])
        assert float(state.loss_scale.scale) == float(ws[2][0])
        assert int(state.loss_scale.good_steps) == int(ws[2][1])
        _assert_params(state.params, ws[0], ref["params"],
                       f"{case} step {i}")
        for got, exp, what in ((state.opt.m, ws[1][1], "m"),
                               (state.opt.v, ws[1][2], "v")):
            _assert_leaves(got, exp, MOMENT_RTOL, f"{case} step {i} {what}")


def test_step_leaves_its_input_state_alone(ref):
    api = registry.build(_cfg("bf16"))
    step = make_train_step(api, _port_train_config("mb2_scaled"))
    state = init_state(api, _np_to_torch(ref["params"]))
    before = [t.clone() for t in tree_leaves(state)]
    step(state, {"tokens": torch.from_numpy(
        train_tokens(512, 4, TRAIN_SEQ, 100))})
    assert all(torch.equal(a, b)
               for a, b in zip(before, tree_leaves(state)))


def test_injected_inf_skips_the_update_and_halves_the_scale(ref):
    api = registry.build(_cfg("bf16"))
    tc = _port_train_config("mb2_scaled")
    state = init_state(api, _np_to_torch(ref["params"]))
    batch = {"tokens": torch.from_numpy(
        train_tokens(512, 4, TRAIN_SEQ, 100))}
    grads, loss, metrics = train.grad_step(api, tc, state, batch)
    grads["blocks"]["b0"]["mlp"]["w_up"]["w"][0, 3, 5] = math.inf
    new, m = train.apply_updates(api, tc, state, grads, loss, metrics)
    assert float(m["finite"]) == 0.0
    assert float(m["loss_scale"]) == 2.0 ** 15
    assert float(new.loss_scale.scale) == 2.0 ** 14
    assert int(new.loss_scale.good_steps) == 0
    assert int(new.step) == 1            # the step still counts
    for a, b in zip(tree_leaves((new.params, new.opt)),
                    tree_leaves((state.params, state.opt))):
        assert torch.equal(a, b)
    # the next clean step moves the weights again, at the halved scale
    new2, m2 = make_train_step(api, tc)(new, batch)
    assert float(m2["finite"]) == 1.0 and float(m2["loss_scale"]) == 2.0 ** 14
    assert not torch.equal(new2.params["embed"]["w"],
                           state.params["embed"]["w"])


def test_make_train_step_takes_no_mesh_or_one_device():
    api = registry.build(reduced(TRAIN_ARCH))
    make_train_step(api, mesh=None)
    make_train_step(api, mesh=["cpu"])
    with pytest.raises(NotImplementedError, match="one device"):
        make_train_step(api, mesh=["cpu", "cpu"])
    with pytest.raises(ValueError, match="microbatches"):
        train.grad_step(api, TrainConfig(microbatches=3),
                        init_state(api, seed=0, device="cpu"),
                        {"tokens": torch.zeros((4, 9), dtype=torch.int32)})


@pytest.mark.parametrize("tf32", (True, False))
def test_steps_run_the_trainer_numerics_and_restore_them(monkeypatch,
                                                         tf32):
    """Inside a step TF32 is off and torch's deterministic mode is as the
    caller left it; after the step the TF32 flags are as they were."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", tf32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", tf32)
    api = registry.build(reduced(TRAIN_ARCH))
    seen = []

    def loss_fn(params, batch):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32,
                     torch.are_deterministic_algorithms_enabled()))
        return api.loss_fn(params, batch)

    step = make_train_step(api._replace(loss_fn=loss_fn))
    step(init_state(api, seed=0, device="cpu"),
         {"tokens": torch.from_numpy(train_tokens(512, 2, TRAIN_SEQ, 0))})
    assert seen == [(False, False, False)]
    assert torch.backends.cuda.matmul.allow_tf32 == tf32
    assert torch.backends.cudnn.allow_tf32 == tf32


# ------------------------------------------------- CLI and checkpoints

def _args(tmp, steps=8, every=3):
    return train.parse_args(["--reduced", "--steps", str(steps),
                             "--device", "cpu", "--ckpt-every", str(every),
                             "--ckpt-dir", str(tmp)])


def test_cli_killed_and_resumed_gives_bit_equal_losses(tmp_path):
    whole = train.run(_args(tmp_path / "whole"))
    with pytest.raises(WorkerFailure):
        train.run(_args(tmp_path / "killed"), failure_hook=fail_at_step(5))
    resumed = train.run(_args(tmp_path / "killed"))
    assert resumed.step == whole.step == 8
    # the resumed run starts from the checkpoint at step 3
    assert [h["step"] for h in resumed.history] == list(range(3, 8))
    assert resumed.losses == whole.losses[3:]
    assert isinstance(resumed.state, TrainState)
    for a, b in zip(tree_leaves(resumed.state), tree_leaves(whole.state)):
        assert torch.equal(a, b)
    # a failure recovered in process replays the same stream too
    fired = []

    def once(step):
        if step == 4 and not fired:
            fired.append(step)
            raise WorkerFailure("injected")

    again = train.run(_args(tmp_path / "once"), failure_hook=once)
    assert again.restarts == 1
    assert again.losses[-5:] == whole.losses[3:]


def test_cli_prints_the_reference_closing_line(tmp_path, capsys):
    train.main(["--reduced", "--steps", "2", "--device", "cpu",
                "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out.strip()
    assert re.fullmatch(
        r"arch=qwen2-0\.5b steps=2 time=\d+\.\ds loss\[0\]=\d+\.\d{4} "
        r"loss\[-1\]=\d+\.\d{4} markov_entropy=2\.7726", out), out


def test_reference_checkpoint_resumes_in_the_port(ref, tmp_path):
    """The reference's ``TrainState`` after two steps, written by its
    ``save_checkpoint``, restores in the port (the leaf paths name the
    NamedTuple fields alike) and the port's third step is the
    reference's: params, moments, loss and metrics."""
    step_dir = tmp_path / f"step_{2:09d}"
    step_dir.mkdir()
    for name, data in ref["checkpoint"].items():
        (step_dir / name).write_bytes(data)
    api = registry.build(_cfg("bf16"))
    like = init_state(api, seed=1, device="cpu")
    got_step, state, meta = CheckpointManager(str(tmp_path)).restore_latest(
        like, device="cpu")
    assert got_step == 2 and meta == {"note": "reference"}
    assert isinstance(state, TrainState)
    assert isinstance(state.opt, AdamWState)
    assert isinstance(state.loss_scale, LossScaleState)
    want2 = ref["steps"]["plain"]["states"][1]
    _assert_leaves(state, want2, 0.0, "restored")
    from repro_torch.checkpoint._msgpack import unpackb
    manifest = unpackb(ref["checkpoint"]["manifest.msgpack"])
    assert manifest["paths"] == _tree_paths(state)
    assert ".opt.m['embed']['w']" in manifest["paths"]
    step = make_train_step(api, _port_train_config("plain"))
    batch = {"tokens": torch.from_numpy(
        train_tokens(512, 2, TRAIN_SEQ, 100 + 2))}
    state3, m = step(state, batch)
    wm = ref["steps"]["plain"]["metrics"][2]
    # the restored weights are the reference's, so the loss is a forward
    # of equal weights
    assert float(m["loss"]) == pytest.approx(wm["loss"],
                                             rel=RESUMED_LOSS_RTOL)
    assert float(m["grad_norm"]) == pytest.approx(wm["grad_norm"],
                                                  rel=GRAD_NORM_RTOL)
    ws = ref["steps"]["plain"]["states"][2]
    _assert_params(state3.params, ws[0], want2[0], "params")
    _assert_leaves(state3.opt.m, ws[1][1], MOMENT_RTOL, "m")
    _assert_leaves(state3.opt.v, ws[1][2], MOMENT_RTOL, "v")
    # and the port's own save of that state restores with the same paths
    restored, _ = restore_checkpoint(
        CheckpointManager(str(tmp_path / "port")).save(3, state3).rsplit(
            os.sep, 1)[0], 3, like, device="cpu")
    assert isinstance(restored, TrainState)
    for a, b in zip(tree_leaves(restored), tree_leaves(state3)):
        assert torch.equal(a, b)


def test_example_trains(tmp_path, capsys):
    from repro_torch.examples import train_lm
    losses = train_lm.main(["--device", "cpu", "--steps", "40",
                            "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 40 and losses[-1] < losses[0]
    out = capsys.readouterr().out
    assert out.startswith("arch=qwen2-0.5b params~")
    assert "loss: start=" in out


def test_launch_serve_reexports_the_serving_names():
    from repro_torch import serving
    from repro_torch.launch import serve
    for name in ("EngineConfig", "SamplingParams", "Request",
                 "ServingEngine"):
        assert getattr(serve, name) is getattr(serving, name)
    assert not hasattr(serve, "make_serve_fns")
