"""PyTorch/CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
module names (``repro_torch.quant.quantize`` <-> ``repro.quant.quantize``
and so on) and keeps its parameter-tree paths and layouts, so the two
compute the same thing on converted weights (``repro_torch.convert``).

It imports ``torch`` and ``numpy`` only: never ``jax`` and never a module
of ``repro``. Where it needs a framework-free piece of the reference
(configs, observability) it keeps its own copy.

Entry points (``ServingEngine``, ``models.registry.init_params``,
``quant.calibrate.calibrate_act_scales``, ``convert.params_from_numpy``)
run on the CUDA device unless the caller passes ``device="cpu"``; with no
CUDA device and no explicit CPU request they raise. The reference's
five Pallas kernels are hand-written CUDA C++ for ``sm_90a`` under
``kernels/csrc``, built with ``nvcc`` at first use; the paper's
numerics (``core``) are integer torch ops.
"""
