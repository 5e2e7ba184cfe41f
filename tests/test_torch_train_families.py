"""Every family's training loss and gradients against the JAX reference,
on the CPU.

Reduced rwkv6-1.6b (rwkv), recurrentgemma-9b (griffin), mixtral-8x7b
(the lm family's MoE, its load-balancing aux loss in the loss),
internvl2-1b (vlm: the loss over the token positions behind the patch
prefix) and seamless-m4t-medium (encdec: the decoder's loss given the
frames), each under ``bf16`` with the reference's converted weights and
the batch its ``materialize_batch`` drew: ``registry.build(cfg).loss_fn``
and its gradients against ``jax.value_and_grad`` of the reference's
(jitted). qwen2-0.5b's are in ``tests/test_torch_train.py``.

Tolerances, per family in ``TOL`` (the measured worst case beside
each): the loss and nll relative, the aux metric within 1e-6 (mixtral
0; the others have none), every gradient leaf's relative L2 error.
rwkv's worst gradient is on the token-shift mixing coefficients
``mu``; griffin's loss is 6.1e-5 off, the others' below 1e-7. rwkv's
``mu`` (and
griffin's projections upstream of the RG-LRU) multiply bf16 activations
in bf16, so their gradients are bf16 products summed over the batch and
sequence: XLA sums them with more bf16 roundings than torch (on one such
sum, 5.8e-3 and 2.2e-3 from the exact value), and the reference's
jitted and op-by-op gradients agree to 1.6e-7, so the gap is the two
libraries' reductions, not the port's order of operations.

One reference subprocess (``_torch_parity.reference("train_families")``)
for all five.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.models import registry
from repro_torch.optim.tree import flatten

from _jax_reference import TRAIN_FAMILY_ARCHS, TRAIN_SEQ
from _torch_parity import one_intra_op_thread  # noqa: F401 (autouse)
from _torch_parity import flat, reference

# (loss and nll relative, gradient leaf relative L2) per family
TOL = {
    "rwkv6-1.6b": (1e-6, 3e-2),               # 7.0e-8  9.6e-3
    "recurrentgemma-9b": (2e-4, 3e-2),        # 6.1e-5  1.4e-2
    "mixtral-8x7b": (1e-6, 3e-5),             # 7.1e-8  5.4e-6
    "internvl2-1b": (1e-6, 1e-5),             # 7.0e-8  1.4e-6
    "seamless-m4t-medium": (1e-6, 2e-4),      # 0       4.7e-5
}
AUX_RTOL = 1e-6


@pytest.fixture(scope="module")
def ref():
    return reference("train_families")


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _loss_and_grads(arch, want, **changes):
    api = registry.build(dataclasses.replace(reduced(arch), **changes))
    params = params_from_numpy(want["params"], device="cpu")
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in want["batch"].items()}
    leaves, unflatten = flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss, metrics = api.loss_fn(unflatten(live), batch)
    grads = torch.autograd.grad(loss, live)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(list(grads)))


@pytest.mark.parametrize("arch", TRAIN_FAMILY_ARCHS)
def test_loss_and_gradients_match_reference(ref, arch):
    want = ref[arch]
    assert want["batch"]["tokens"].shape == (2, TRAIN_SEQ + 1)
    loss, metrics, grads = _loss_and_grads(arch, want)
    assert set(metrics) == set(want["metrics"]) == {"nll", "aux"}
    loss_tol, grad_tol = TOL[arch]
    assert float(loss) == pytest.approx(want["loss"], rel=loss_tol)
    assert float(metrics["nll"]) == pytest.approx(want["metrics"]["nll"],
                                                  rel=loss_tol)
    assert float(metrics["aux"]) == pytest.approx(want["metrics"]["aux"],
                                                  rel=AUX_RTOL)
    got, exp = flat(to_numpy(grads)), flat(want["grads"])
    assert got.keys() == exp.keys()
    for path, a in got.items():
        b = np.asarray(exp[path], np.float64)
        assert a.shape == b.shape, path
        err = _rel_l2(a, b)
        assert err <= grad_tol, (arch, path, err)


def test_moe_aux_loss_enters_the_loss(ref):
    """mixtral's loss is its nll plus 0.01 of the load-balancing loss,
    and the router's gradient carries the aux term (without it the
    router would see only the gate values' share)."""
    want = ref["mixtral-8x7b"]
    loss, metrics, grads = _loss_and_grads("mixtral-8x7b", want)
    aux = float(metrics["aux"])
    assert aux > 1.0
    assert float(loss) == pytest.approx(float(metrics["nll"]) + 0.01 * aux,
                                        rel=1e-6)
    router = grads["blocks"]["b0"]["moe"]["router"]["w"]
    assert float(router.abs().sum()) > 0


@pytest.mark.parametrize("arch", TRAIN_FAMILY_ARCHS)
def test_every_remat_setting_gives_the_same_gradients(ref, arch):
    """``remat`` "full" (and "dots" where the family has it) recompute
    the forward in backward; the gradients equal "none"'s bit for bit."""
    base = _loss_and_grads(arch, ref[arch], remat="none")
    for remat in ("full", "dots"):
        loss, _, grads = _loss_and_grads(arch, ref[arch], remat=remat)
        assert torch.equal(loss, base[0]), remat
        for a, b in zip(flatten(grads)[0], flatten(base[2])[0]):
            assert torch.equal(a, b), remat


@pytest.mark.parametrize("arch", ("qwen2-0.5b",) + TRAIN_FAMILY_ARCHS)
def test_train_logits_give_the_fused_loss(arch):
    """Each family's head over its whole ``hidden_states`` (the (B, S, V)
    logits at once) under ``next_token_xent`` gives the nll and aux that
    ``loss_fn``'s fused, chunked head gives (f32 summation order
    apart); for lm they are ``lm.train_logits``."""
    from repro_torch.configs import InputShape
    from repro_torch.models import encdec, griffin, lm, rwkv, vlm
    from repro_torch.models.losses import next_token_xent
    cfg = reduced(arch)
    api = registry.build(cfg)
    params = api.init(0, "cpu", draws="numpy")
    batch = registry.materialize_batch(
        cfg, InputShape("train", TRAIN_SEQ, 2, "train"), seed=5,
        device="cpu")
    inp, tgt = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    with torch.no_grad():
        _, metrics = api.loss_fn(params, batch)
        mod = {"lm": lm, "rwkv": rwkv, "griffin": griffin, "vlm": vlm,
               "encdec": encdec}[cfg.family]
        extra = {"vlm": ("patches",), "encdec": ("frames",)}.get(
            cfg.family, ())
        x, aux = mod.hidden_states(params, cfg, inp,
                                   *(batch[k] for k in extra))
        logits = mod.head(params, cfg, x)
        if cfg.family == "lm":
            whole, whole_aux = lm.train_logits(params, cfg, inp)
            assert torch.equal(whole, logits) and torch.equal(whole_aux, aux)
        nll, _ = next_token_xent(logits, tgt)
    assert logits.shape == (2, TRAIN_SEQ, cfg.padded_vocab)
    assert logits.dtype == torch.float32
    assert float(nll) == pytest.approx(float(metrics["nll"]), rel=1e-6)
    assert float(aux) == pytest.approx(float(metrics["aux"]), rel=1e-6)


def test_loss_fn_is_set_for_every_family():
    from repro_torch.configs import get_config
    for arch in ("qwen2-0.5b",) + TRAIN_FAMILY_ARCHS:
        assert callable(registry.build(get_config(arch)).loss_fn), arch
