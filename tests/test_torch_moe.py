"""The port's MoE layer (``repro_torch.layers.moe``) against the JAX
reference's (``repro.layers.moe``), on the CPU.

The reference's ``init`` draws the parameters, which reach the port
through ``convert.params_from_numpy``; inputs come from a numpy seed.
Both layers run on the same numbers:

* routing (expert ids, queue positions, ``fits``) EXACT, in both
  dispatch modes, with a capacity small enough that assignments drop
  (asserted), and with router columns built to tie exactly, where
  ``jax.lax.top_k`` puts the lower expert first and the port's stable
  sort must too;
* ``y`` within one bf16 ulp (2^-7 relative) plus 1e-6 absolute: both
  layers round to bf16 at the same points, and the bf16 products differ
  only in their f32 summation order; seen: 0 for bf16 inputs, 2e-7 for
  f32 inputs;
* ``aux`` (f32) within 1e-6 relative;
* experts raw (bf16), fake-quantized per call (int8 and int4 policies
  on raw stacks, one weight quantization a stack and call) and prepared
  (int8 rows, packed int4, per-group int4 and fp8): the prepared
  expert stacks are 4-D under the model's group axis, and the port's
  ``prepare`` gives the reference's codes and scales bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import reduced as ref_reduced
from repro.core import policy as ref_policy
from repro.layers import moe as ref_moe
from repro.models import registry as ref_registry
from repro_torch.configs import reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as port_policy
from repro_torch.layers import moe
from repro_torch.layers.mplinear import count_weight_quant
from repro_torch.models import registry
from repro_torch.quant.prepare import PreparedWeight

from _torch_parity import f32, jax_to_numpy
from _torch_parity import one_intra_op_thread  # noqa: F401 (autouse)

Y_RTOL, Y_ATOL = 2.0 ** -7, 1e-6
AUX_RTOL = 1e-6

# a per-group int4 and an fp8 route for the expert stacks, registered in
# both packages under the same name
GROUPED = {"moe_int4_g16": ("int4", 16), "moe_fp8_g8": ("fp8", 8)}
for _name, (_mode, _gs) in GROUPED.items():
    ref_policy.register_policy(ref_policy.PrecisionPolicy(
        _name, rules=((r"moe/experts", ref_policy.PrecisionSpec(
            _mode, group_size=_gs)),)))
    port_policy.register_policy(port_policy.PrecisionPolicy(
        _name, rules=((r"moe/experts", port_policy.PrecisionSpec(
            _mode, group_size=_gs)),)))


def _cfgs(dispatch="einsum", capacity_factor=1.25, **kw):
    ref = ref_moe.MoEConfig(d_model=32, d_expert=16, n_experts=6, top_k=2,
                            capacity_factor=capacity_factor,
                            dispatch=dispatch, **kw)
    return ref, moe.MoEConfig(**dataclasses.asdict(ref))


def _params(ref_cfg, seed=0):
    p = ref_moe.init(jax.random.PRNGKey(seed), ref_cfg)
    return p, params_from_numpy(jax_to_numpy(p), device="cpu")


def _x(shape=(3, 16, 32), seed=1, dtype=np.float32):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(dtype)


def _ref_route(params, cfg, x):
    """The reference's routing, the lines of ``repro.layers.moe.forward``
    that decide it (top-k, renormalized gates, queue positions, fits)."""
    b, s, _ = x.shape
    cap = ref_moe._capacity(s, cfg)
    logits = jnp.einsum("gsd,de->gse", x.astype(jnp.float32),
                        params["router"]["w"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_ids = jax.lax.top_k(probs, cfg.top_k)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True),
                                        1e-9)
    onehot = jax.nn.one_hot(expert_ids, cfg.n_experts, dtype=jnp.int32)
    flat = onehot.reshape(b, s * cfg.top_k, cfg.n_experts)
    pos = ((jnp.cumsum(flat, axis=1) - flat).reshape(
        b, s, cfg.top_k, cfg.n_experts) * onehot).sum(-1)
    fits = pos < cap
    return {"ids": np.asarray(expert_ids), "pos": np.asarray(pos),
            "fits": np.asarray(fits), "gates": np.asarray(gate_vals * fits),
            "probs": np.asarray(probs), "cap": cap}


def _port_route(params, cfg, x):
    probs, ids, gates, pos, fits, cap = moe.route(params, cfg, x)
    return {"ids": ids.numpy(), "pos": pos.numpy(), "fits": fits.numpy(),
            "gates": gates.numpy(), "probs": probs.numpy(), "cap": cap}


def _same_routing(rp, tp, rc, tc, x, xt):
    want, got = _ref_route(rp, rc, x), _port_route(tp, tc, xt)
    assert got["cap"] == want["cap"]
    for k in ("ids", "pos", "fits"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["gates"], want["gates"], rtol=1e-6,
                               atol=1e-7)
    return want


def _forward_both(rp, tp, rc, tc, x, policy, dtype=jnp.bfloat16):
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(torch.bfloat16 if dtype == jnp.bfloat16
                                else torch.float32)
    y_ref, aux_ref = ref_moe.forward(rp, rc, xj,
                                     ref_policy.get_policy(policy), "m")
    with count_weight_quant() as wq, torch.no_grad():
        y, aux = moe.forward(tp, tc, xt, port_policy.get_policy(policy),
                             "m")
    assert y.dtype == xt.dtype and y.shape == xt.shape
    np.testing.assert_allclose(f32(y), f32(y_ref), rtol=Y_RTOL,
                               atol=Y_ATOL)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=AUX_RTOL)
    return xj, xt, wq[0]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_forward_matches_reference(dispatch, dtype):
    rc, tc = _cfgs(dispatch)
    rp, tp = _params(rc)
    x = _x()
    xj, xt, _ = _forward_both(rp, tp, rc, tc, x, "bf16",
                              getattr(jnp, dtype))
    _same_routing(rp, tp, rc, tc, xj, xt)


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_capacity_drops_match_reference(dispatch):
    """A capacity of 2 for 24 assignments over 6 experts: most drop."""
    rc, tc = _cfgs(dispatch, capacity_factor=0.25)
    rp, tp = _params(rc, seed=3)
    x = _x(seed=4)
    xj, xt, _ = _forward_both(rp, tp, rc, tc, x, "bf16")
    want = _same_routing(rp, tp, rc, tc, xj, xt)
    assert want["cap"] == 2
    assert 0 < want["fits"].sum() < want["fits"].size
    # a dropped assignment takes no weight
    assert np.all(want["gates"][~want["fits"]] == 0)


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_exact_router_ties_take_the_lower_expert_first(dispatch):
    """Router columns 0/3 and 1/4 equal: their probabilities tie bit for
    bit, and both layers must order a tied pair the same way
    (``lax.top_k``: lower index first)."""
    rc, tc = _cfgs(dispatch)
    rp, _ = _params(rc, seed=5)
    w = np.asarray(rp["router"]["w"]).copy()
    w[:, 3], w[:, 4] = w[:, 0], w[:, 1]
    # and make the tied columns win: scale them above the rest
    w[:, [0, 1, 3, 4]] *= 4.0
    rp = dict(rp, router={"w": jnp.asarray(w)})
    tp = params_from_numpy(jax_to_numpy(rp), device="cpu")
    x = _x(seed=6)
    xj, xt, _ = _forward_both(rp, tp, rc, tc, x, "bf16")
    want = _same_routing(rp, tp, rc, tc, xj, xt)
    ids, probs = want["ids"], want["probs"]
    tied = ((ids[..., 0] == 0) & (ids[..., 1] == 3)) | (
        (ids[..., 0] == 1) & (ids[..., 1] == 4))
    assert tied.sum() > 10
    p = np.take_along_axis(probs, ids, -1)
    assert np.all(p[tied][:, 0] == p[tied][:, 1])


def test_stable_sort_orders_ties_as_lax_top_k():
    """The stable descending sort keeps the lower index first on ties,
    the order ``lax.top_k`` gives."""
    probs = torch.tensor([[0.1, 0.3, 0.1, 0.3, 0.2]])
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    assert ids[0, :3].tolist() == [1, 3, 4]
    assert ids[0, 3:].tolist() == [0, 2]
    _, jids = jax.lax.top_k(jnp.asarray(probs.numpy()), 5)
    assert np.asarray(jids).tolist() == ids.tolist()


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("policy", ["int8_serving", "int4_serving"])
def test_fake_quant_experts_match_reference(dispatch, policy):
    """Raw stacks under an int policy fake-quantize per expert and
    out-channel on every call: one weight quantization per stack."""
    rc, tc = _cfgs(dispatch)
    rp, tp = _params(rc, seed=7)
    _, _, wq = _forward_both(rp, tp, rc, tc, _x(seed=8), policy)
    assert wq == 3


PREPARED = [("int8_serving", "int8"), ("int4_serving", "int4_packed"),
            ("moe_int4_g16", "int4_packed"), ("moe_fp8_g8", "fp8")]


@pytest.fixture(scope="module")
def mixtral():
    cfg = ref_reduced("mixtral-8x7b")
    params = ref_registry.build(cfg).init(jax.random.PRNGKey(0))
    return cfg, params, params_from_numpy(jax_to_numpy(params),
                                          device="cpu")


@pytest.mark.parametrize("policy,kind", PREPARED)
def test_prepared_expert_stacks_bit_equal_to_reference(mixtral, policy,
                                                       kind):
    """``prepare`` of a reduced mixtral tree: each 4-D (n_groups, E, K,
    N) expert stack gets the reference's codes and scales bit for bit
    (per expert and out-channel, or per group of K), and ``dequant`` and
    ``index`` are the reference's values."""
    ref_cfg, rparams, tparams = mixtral
    rprep = ref_registry.build(ref_cfg).prepare(
        rparams, ref_policy.get_policy(policy))
    tprep = registry.build(reduced("mixtral-8x7b")).prepare(
        tparams, port_policy.get_policy(policy))
    for name in ("w_gate", "w_up", "w_down"):
        r = rprep["blocks"]["b0"]["moe"][name]["w"]
        t = tprep["blocks"]["b0"]["moe"][name]["w"]
        assert isinstance(t, PreparedWeight) and t.kind == r.kind == kind
        assert t.data.dim() == 4 and t.act_scale is None
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(r.data))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(r.scale))
        np.testing.assert_array_equal(t.dequant().numpy(),
                                      np.asarray(r.dequant()))
        np.testing.assert_array_equal(t.index(1).dequant().numpy(),
                                      np.asarray(r.dequant())[1])
    # the router stays raw f32 under every policy
    router = tprep["blocks"]["b0"]["moe"]["router"]["w"]
    assert isinstance(router, torch.Tensor) and router.dtype == torch.float32


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("policy,kind", PREPARED)
def test_prepared_experts_forward_matches_reference(mixtral, dispatch,
                                                    policy, kind):
    """The layer over one group's prepared stacks: dequantized from
    storage (no weight quantization), the reference's output."""
    ref_cfg, rparams, tparams = mixtral
    rprep = ref_registry.build(ref_cfg).prepare(
        rparams, ref_policy.get_policy(policy))
    tprep = registry.build(reduced("mixtral-8x7b")).prepare(
        tparams, port_policy.get_policy(policy))
    from repro_torch.models.lm import unstack
    rp = jax.tree.map(lambda a: a[0], rprep["blocks"]["b0"]["moe"])
    tp = unstack(tprep["blocks"]["b0"]["moe"])[0]
    rc = dataclasses.replace(ref_moe.MoEConfig(
        ref_cfg.d_model, ref_cfg.moe.d_expert, ref_cfg.moe.n_experts,
        ref_cfg.moe.top_k, ref_cfg.moe.capacity_factor, ref_cfg.act),
        dispatch=dispatch)
    tc = moe.MoEConfig(**dataclasses.asdict(rc))
    x = _x((2, 8, ref_cfg.d_model), seed=9)
    _, _, wq = _forward_both(rp, tp, rc, tc, x, policy)
    assert wq == 0
