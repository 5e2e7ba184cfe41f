"""Bisect the per-device memory of the train step on the production
mesh (mirror of ``tools/mem_probe.py``; no card needed).

The reference's five probes (full-width qwen2-0.5b at 4096 x 256 on a
16 x 16 mesh: the whole model under ``remat="full"`` and ``"none"``, 2
layers, a quarter of the sequence, a quarter of the batch), each through
the dry-run's memory estimate (``launch.dryrun.run_cell`` on a fake
world of 256: the ``MemTracker`` peak of rank 0's step, and its
``Temp`` category, the backward's temporaries).

    PYTHONPATH=src python -m repro_torch.tools.mem_probe [--reduced]

``--reduced`` runs the same probes on the reduced config at 32 x 8 on a
(2, 4) mesh of 8 fake ranks (a quick check).
"""
from __future__ import annotations

import argparse
import dataclasses


def probes(cfg, seq: int, batch: int):
    """(tag, config, seq, batch) of the five probes around ``cfg``."""
    n = cfg.n_layers
    return (
        (f"L{n} s{seq} b{batch} remat=full", cfg, seq, batch),
        (f"L{n} s{seq} b{batch} remat=none",
         dataclasses.replace(cfg, remat="none"), seq, batch),
        (f"L2 s{seq} b{batch} remat=full",
         dataclasses.replace(cfg, n_layers=2), seq, batch),
        (f"L{n} s{seq // 4} b{batch} remat=full", cfg, seq // 4, batch),
        (f"L{n} s{seq} b{batch // 4} remat=full", cfg, seq, batch // 4),
    )


def probe(tag, cfg, seq, batch, mesh_shape=(16, 16)):
    from repro_torch.configs import InputShape
    from repro_torch.launch.dryrun import run_cell
    rec = run_cell(cfg.arch_id, "p", False, remat=cfg.remat, cfg=cfg,
                   shape=InputShape("p", seq, batch, "train"),
                   mesh_shape=mesh_shape)
    temp = rec["memory"].get("Temp", 0)
    print(f"{tag:50s} temp={temp / 1e9:8.2f} GB "
          f"peak={rec['per_device_bytes'] / 1e9:8.2f} GB", flush=True)
    return rec


def main(argv=None):
    from repro_torch.configs import get_config, reduced
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    if args.reduced:
        cfg = dataclasses.replace(reduced(args.arch), remat="full")
        cells, mesh = probes(cfg, 32, 8), (2, 4)
    else:
        cells, mesh = probes(get_config(args.arch), 4096, 256), (16, 16)
    return [probe(*c, mesh_shape=mesh) for c in cells]


if __name__ == "__main__":
    main()
