"""Training step and CLI trainer on one device (mirror of
``repro/launch/train.py``).

``make_train_step`` builds the step: forward, gradients, optional
microbatch accumulation and dynamic loss scaling, then AdamW under the
warmup-cosine schedule. The reference's step is a jitted SPMD program
over a device mesh with donated, sharded state; the port's runs on one
device, takes no mesh or a one-device one, and is functional (it
returns a new state and leaves the old one intact, so
``FaultTolerantLoop`` can replay from it). Its kernels are PyTorch's:
the training path launches none of the port's hand-written kernels, as
the reference's reaches none of its Pallas kernels (none has a
backward).

Numerics (:func:`train_numerics`, around every step): TF32 off, as the
reference multiplies in f32. torch's deterministic mode stays as the
caller set it: the step's accumulating backwards are deterministic
without it (the embedding gather's sorts its indices; the target-logit
and MoE gathers' add one source to each target), so a run on the card
repeats itself bit for bit and a killed run resumes onto the
uninterrupted run's bits. ``chip_smoke.py`` phase 18 (e) checks that
at full width and measures what the mode would cost.

CLI (one device; CUDA unless ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        [--reduced] --steps 30 --batch 8 --seq 128 --ckpt-dir DIR

It prints the reference's closing line: ``arch=... steps=... time=...s
loss[0]=... loss[-1]=... markov_entropy=...``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.models import registry
from repro_torch.optim import (AdamWConfig, AdamWState, LossScaleState,
                               adamw_init, adamw_update, grads_finite,
                               loss_scale_init, loss_scale_update,
                               warmup_cosine)
from repro_torch.optim.tree import flatten, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    loss_scale: LossScaleState
    step: torch.Tensor      # () int32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = AdamWConfig()
    warmup: int = 100
    total_steps: int = 10_000
    use_loss_scaling: bool = False   # fp16-arithmetic policies
    # gradient accumulation: the batch splits into this many microbatches
    # whose gradients average exactly
    microbatches: int = 1


def init_state(api: registry.ModelAPI, params=None, seed: int = 0,
               device=None) -> TrainState:
    """The state at step 0 around ``params`` (e.g. converted from the
    reference's init), or around ``api.init(seed, device)``'s."""
    if params is None:
        params = api.init(seed, device)
    dev = flatten(params)[0][0].device
    return TrainState(params, adamw_init(params),
                      loss_scale_init(device=dev),
                      torch.zeros((), dtype=torch.int32, device=dev))


def _grad_once(api, tc: TrainConfig, state: TrainState, batch):
    leaves, unflatten = flatten(state.params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss, metrics = api.loss_fn(unflatten(live), batch)
        target = loss * state.loss_scale.scale if tc.use_loss_scaling \
            else loss
        grads = torch.autograd.grad(target, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    if tc.use_loss_scaling:
        inv = 1.0 / state.loss_scale.scale
        grads = [g.to(torch.float32) * inv for g in grads]
    return (unflatten(grads), loss.detach(),
            {k: v.detach() for k, v in metrics.items()})


def grad_step(api: registry.ModelAPI, tc: TrainConfig, state: TrainState,
              batch):
    """``(grads, loss, metrics)`` of one batch (the reference's
    ``_grad_step``). With ``tc.microbatches`` = mb > 1 the batch splits
    along its first axis; each microbatch's gradient is divided by mb
    and added in order, and the metrics are ``{"nll": loss, "aux": 0}``."""
    if tc.microbatches <= 1:
        return _grad_once(api, tc, state, batch)
    mb = tc.microbatches

    def part(x, i):
        b = x.shape[0]
        if b % mb:
            raise ValueError(f"batch {b} does not split into {mb} "
                             f"microbatches")
        return x.reshape(mb, b // mb, *x.shape[1:])[i]

    g_acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     state.params)
    loss = torch.zeros((), dtype=torch.float32,
                       device=state.loss_scale.scale.device)
    for i in range(mb):
        grads, li, _ = _grad_once(api, tc, state,
                                  {k: part(v, i) for k, v in batch.items()})
        g_acc = tree_map(lambda a, g: a + g.to(torch.float32) / mb, g_acc,
                         grads)
        loss = loss + li / mb
    return g_acc, loss, {"nll": loss, "aux": torch.zeros_like(loss)}


@torch.no_grad()
def apply_updates(api: registry.ModelAPI, tc: TrainConfig,
                  state: TrainState, grads, loss, metrics):
    """AdamW at the schedule's rate -> ``(new state, metrics)`` (the
    reference's ``_apply_updates``). Under loss scaling a non-finite
    gradient keeps the old parameters and moments and halves the scale.
    The metrics are ``loss``, ``finite``, the loss's own (``nll``,
    ``aux``), ``grad_norm`` and the ``loss_scale`` the step ran at."""
    finite = grads_finite(grads)
    lr_scale = warmup_cosine(state.step, warmup=tc.warmup,
                             total=tc.total_steps)
    new_params, new_opt, opt_metrics = adamw_update(
        tc.adamw, state.params, grads, state.opt, lr_scale)
    if tc.use_loss_scaling:
        keep = lambda n, o: torch.where(finite, n, o)   # noqa: E731
        new_params = tree_map(keep, new_params, state.params)
        new_opt = tree_map(keep, new_opt, state.opt)
        new_ls = loss_scale_update(state.loss_scale, finite)
    else:
        new_ls = state.loss_scale
    new_state = TrainState(new_params, new_opt, new_ls, state.step + 1)
    out = {"loss": loss, "finite": finite.to(torch.float32), **metrics,
           **opt_metrics, "loss_scale": state.loss_scale.scale}
    return new_state, out


@contextlib.contextmanager
def train_numerics():
    """The trainer's numerics while open: TF32 off. The previous
    settings come back after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]


def _mesh_size(mesh) -> int:
    if mesh is None:
        return 1
    size = getattr(mesh, "size", None)
    if callable(size):
        return int(size())
    return int(size) if size is not None else len(mesh)


def make_train_step(api: registry.ModelAPI, tc: TrainConfig = TrainConfig(),
                    mesh=None) -> Callable:
    """``step(state, batch) -> (new state, metrics)`` on one device.
    ``mesh`` may be None or a one-device mesh (anything with ``size`` 1,
    e.g. a ``torch.distributed.DeviceMesh``); a larger one raises, as
    sharded training is not ported."""
    if _mesh_size(mesh) != 1:
        raise NotImplementedError(
            f"the port trains on one device; a mesh of {_mesh_size(mesh)} "
            f"devices needs sharded training, which is not ported")

    def step(state: TrainState, batch):
        with train_numerics():
            grads, loss, metrics = grad_step(api, tc, state, batch)
            return apply_updates(api, tc, state, grads, loss, metrics)

    return step


# ----------------------------------------------------------------- CLI

def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--policy", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "plain path on the CPU)")
    return ap.parse_args(argv)


@dataclasses.dataclass
class TrainRun:
    cfg: Any
    state: TrainState
    step: int
    seconds: float
    losses: List[float]
    history: List[Dict]
    restarts: int


def run(args: argparse.Namespace, wrap_step: Optional[Callable] = None,
        failure_hook: Optional[Callable[[int], None]] = None) -> TrainRun:
    """What ``main`` runs: the model, its state at step 0, the Markov
    stream and ``FaultTolerantLoop`` (resuming from ``--ckpt-dir``'s
    newest checkpoint if there is one). ``wrap_step(step) -> step`` may
    wrap the train step (a timer); ``failure_hook`` goes to the loop."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.device import resolve_device
    from repro_torch.runtime.fault_tolerance import (FTConfig,
                                                     FaultTolerantLoop)

    device = resolve_device(args.device)
    cfg = reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.policy:
        cfg = dataclasses.replace(cfg, precision_policy=args.policy)
    api = registry.build(cfg)
    tc = TrainConfig(adamw=AdamWConfig(lr=args.lr), total_steps=args.steps)
    step_fn = make_train_step(api, tc)
    if wrap_step is not None:
        step_fn = wrap_step(step_fn)
    state = init_state(api, device=device)
    ds = SyntheticLMDataset(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch),
        device=device)
    loop = FaultTolerantLoop(
        step_fn=step_fn, batch_fn=ds.batch, ckpt_dir=args.ckpt_dir,
        cfg=FTConfig(checkpoint_every=args.ckpt_every),
        failure_hook=failure_hook)
    t0 = time.time()
    state, step = loop.run(state, 0, args.steps, device=device)
    dt = time.time() - t0
    return TrainRun(cfg, state, step, dt,
                    [h["loss"] for h in loop.history], loop.history,
                    loop.restarts)


def main(argv=None):
    args = parse_args(argv)
    r = run(args)
    print(f"arch={r.cfg.arch_id} steps={r.step} time={r.seconds:.1f}s "
          f"loss[0]={r.losses[0]:.4f} loss[-1]={r.losses[-1]:.4f} "
          f"markov_entropy={np.log(16):.4f}")


if __name__ == "__main__":
    main()
