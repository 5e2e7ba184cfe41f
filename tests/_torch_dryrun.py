"""The subprocess side of ``tests/test_torch_dryrun.py``: one fake world
of 8 ranks (this process rank 0) running the dry-run on reduced cells
and the three tools on reduced inputs; the results go to a JSON file.

Run it alone: ``PYTHONPATH=src python tests/_torch_dryrun.py OUT.json``.
A fake process group is process-wide state, so the test runs this in a
process of its own.
"""
import contextlib
import io
import json
import os
import sys
import tempfile
import warnings

# (name, arch, (seq, batch, kind), mesh shape, moe dispatch)
CELLS = (("train", "qwen2-0.5b", (32, 8, "train"), (2, 4), None),
         ("decode", "qwen2-0.5b", (64, 8, "decode"), (2, 2, 2), None),
         ("prefill", "qwen2-0.5b", (32, 8, "prefill"), (2, 4), None),
         ("moe_prefill", "qwen3-moe-30b-a3b", (32, 8, "prefill"), (2, 4),
          "gather"))


def run(out_path):
    import torch
    from repro_torch.configs import InputShape, reduced
    from repro_torch.launch import dryrun
    from repro_torch.tools import exchange_bench, mem_probe, roofline_table

    warnings.filterwarnings("ignore")
    import logging
    logging.getLogger("torch").setLevel(logging.ERROR)
    torch.set_num_threads(1)
    out = {"cells": {}}
    with dryrun.fake_world(8), tempfile.TemporaryDirectory() as tmp:
        for name, arch, (seq, batch, kind), mesh, md in CELLS:
            rec = dryrun.run_cell(arch, name, False, remat="none",
                                  moe_dispatch=md, cfg=reduced(arch),
                                  shape=InputShape(name, seq, batch, kind),
                                  mesh_shape=mesh)
            out["cells"][name] = rec
        out["exchange"] = exchange_bench.exchange_bytes(
            reduced("gemma2-9b"), (2, 2, 2), os.path.join(tmp, "ex.json"))
        with contextlib.redirect_stdout(io.StringIO()):
            probes = mem_probe.main(["--reduced"])
        out["mem_probe"] = [r["per_device_bytes"] for r in probes]
        # roofline_table reads records of production shapes: the train
        # cell's record, renamed to train_4k on its reduced arch
        rec = dict(out["cells"]["train"], shape="train_4k")
        os.makedirs(os.path.join(tmp, "dryrun"))
        with open(os.path.join(tmp, "dryrun", "cell.json"), "w") as f:
            json.dump(rec, f)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            roofline_table.main(["--dir", os.path.join(tmp, "dryrun")])
        out["roofline_table"] = text.getvalue()
        out["enriched"] = roofline_table.enrich(rec)
    with open(out_path, "w") as f:
        json.dump(out, f, default=float)


if __name__ == "__main__":
    run(sys.argv[1])
