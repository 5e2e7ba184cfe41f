"""Train a small LM on the synthetic Markov stream with the port's full
stack (mirror of ``examples/train_lm.py``; the same flags and prints):
the train step, AdamW, the LR schedule, the fault-tolerant loop with
checkpoints, and a mixed-precision policy.

    PYTHONPATH=src python -m repro_torch.examples.train_lm \\
        [--d-model 256 --layers 4 --steps 200 --policy int8_serving] \\
        [--device cpu]

Runs on ``--device`` (``cuda`` by default; without CUDA it raises,
``--device cpu`` runs on the CPU).
"""
import argparse
import dataclasses
import os
import shutil
import tempfile
import time

from repro_torch.configs import reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.launch.train import (TrainConfig, init_state,
                                      make_train_step)
from repro_torch.models import registry
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.fault_tolerance import FTConfig, FaultTolerantLoop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--policy", default="bf16")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--resume", action="store_true",
                    help="resume from existing checkpoints (default: "
                         "start fresh)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the "
                         "CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if not args.resume:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    cfg = dataclasses.replace(
        reduced(args.arch),
        d_model=args.d_model, n_layers=args.layers, d_ff=4 * args.d_model,
        vocab=args.vocab, precision_policy=args.policy,
        head_dim=args.d_model // 4)
    api = registry.build(cfg)
    print(f"arch={cfg.arch_id} params~{cfg.params_count()/1e6:.1f}M "
          f"policy={args.policy}")

    tc = TrainConfig(adamw=AdamWConfig(lr=args.lr), warmup=20,
                     total_steps=args.steps)
    step_fn = make_train_step(api, tc)
    state = init_state(api, device=device)
    ds = SyntheticLMDataset(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch),
        device=device)
    loop = FaultTolerantLoop(
        step_fn=step_fn, batch_fn=ds.batch, ckpt_dir=args.ckpt_dir,
        cfg=FTConfig(checkpoint_every=50))

    t0 = time.time()
    state, step = loop.run(state, 0, args.steps, device=device)
    dt = time.time() - t0

    losses = [h["loss"] for h in loop.history]
    ent = ds.conditional_entropy()
    print(f"steps={step} time={dt:.1f}s "
          f"({args.steps * args.batch * args.seq / dt:.0f} tok/s)")
    print(f"loss: start={losses[0]:.3f} -> end={losses[-1]:.3f} "
          f"(markov entropy floor = {ent:.3f} nats)")
    assert losses[-1] < losses[0], "no learning happened"
    if losses[-1] < 0.8 * losses[0]:
        print("model is learning the Markov structure ✓")
    return losses


if __name__ == "__main__":
    main()
