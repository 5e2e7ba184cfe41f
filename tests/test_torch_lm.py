"""The port's lm model against the JAX reference on ``reduced("qwen2-0.5b")``.

Both packages run the same converted weights, the same calibrated act
scales and the same numpy tokens. The reference's outputs come from
``tests/_jax_reference.py lm`` (see there for the XLA flag it needs).
For each policy and executor variant: prefill logits and caches, a
chunked prefill into a live cache, and three greedy decode steps fed
the reference's own argmax tokens.

Tolerances:

* logits (f32, |logit| < 4): 1e-5 absolute. Both packages round to bf16
  at the same places and differ only in the order of f32 sums inside a
  matrix product, a few f32 ulps (2.4e-7 at this magnitude); 1e-5 is
  about 40 of them.
* cache contents: K and V (bf16) within one bf16 ulp (at most 2^-7
  relative) of the reference, since a last-bit difference of an f32 sum
  can flip the bf16 rounding of one element; position tags equal.
* calibrated act scales: bit-equal to the reference computed op by op
  (``jax.disable_jit``). The reference's jitted calibration can differ by
  one int8 rounding step under the dynamic per-row act quantize of
  ``fidelity_int8`` (XLA fuses that quantize), so it is held to the
  jitted scales only where no dynamic int quantize runs.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.core.policy import get_policy
from repro_torch.models import registry
from repro_torch.quant.calibrate import calibrate_act_scales

from _jax_reference import CALIBRATED, LM_POLICIES, calib_prompts
from _torch_parity import one_intra_op_thread  # noqa: F401 (autouse)
from _torch_parity import check_lm_case, reference, run_lm

LOGIT_ATOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    out = reference("lm")
    return out, params_from_numpy(out["params"], device="cpu")


@pytest.mark.parametrize("variant", [None, "fused"])
@pytest.mark.parametrize("policy", LM_POLICIES)
def test_lm_matches_reference(ref, policy, variant):
    out, params = ref
    case = out["cases"][(policy, variant)]
    cfg = dataclasses.replace(reduced("qwen2-0.5b"), precision_policy=policy)
    api = registry.build(cfg)
    prepared = api.prepare(params, get_policy(policy),
                           act_scales=case["scales"])
    check_lm_case(api, prepared, variant, case, LOGIT_ATOL)


@pytest.mark.parametrize("policy", CALIBRATED)
def test_calibrated_scales_match_reference(ref, policy):
    out, params = ref
    cfg = dataclasses.replace(reduced("qwen2-0.5b"), precision_policy=policy)
    got = calibrate_act_scales(cfg, registry.build(cfg), params,
                               prompts=calib_prompts(), device="cpu")
    if get_policy(policy).default.exact:
        assert got == out["eager_scales"][policy]
    else:
        assert got == out["cases"][(policy, None)]["scales"]


def test_fused_and_unfused_exact_int_agree(ref):
    """Under an exact int policy the fused executor (``fused_qmm``) and
    the unfused one (``qmm`` + epilogue) give bit-equal logits."""
    out, params = ref
    cfg = dataclasses.replace(reduced("qwen2-0.5b"),
                              precision_policy="fidelity_int8")
    api = registry.build(cfg)
    prepared = api.prepare(params, get_policy("fidelity_int8"),
                           act_scales=out["cases"][("fidelity_int8",
                                                    None)]["scales"])
    a, _ = run_lm(api, prepared, None)
    b, _ = run_lm(api, prepared, "fused")
    assert torch.equal(a["prefill_logits"], b["prefill_logits"])


def test_init_defaults_to_cuda_and_keeps_the_reference_tree(ref):
    out, _ = ref
    cfg = reduced("qwen2-0.5b")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            registry.init_params(cfg)
    params = registry.init_params(cfg, seed=3, device="cpu")
    flat_t = _flatten(to_numpy(params))
    flat_j = _flatten(out["params"])
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_j.items():
        assert flat_t[k].shape == np.asarray(v).shape, k
        assert flat_t[k].dtype == np.asarray(v).dtype, k
    # the reference's distribution (truncated at 3 sigma of
    # 1/sqrt(d_in)), not its bits: spreads within 3% of each other
    for k in ("blocks/b0/attn/wq/w", "blocks/b0/mlp/w_down/w", "embed/w"):
        d_in = cfg.d_model if k != "blocks/b0/mlp/w_down/w" else cfg.d_ff
        assert np.abs(flat_t[k]).max() <= 3.0 / np.sqrt(d_in) + 1e-6, k
        assert abs(flat_t[k].std() / flat_j[k].std() - 1) < 0.03, k


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, p))
        else:
            out[p] = np.asarray(v)
    return out
