"""``python -m repro_torch.fabric {worker,smoke,chaos}`` (mirror of
``repro/fabric/__main__.py``)."""
from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m repro_torch.fabric {worker,smoke,chaos} "
              "[options]")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "worker":
        from repro_torch.fabric.worker import worker_main
        return worker_main(rest)
    if cmd == "smoke":
        from repro_torch.fabric.smoke import main as smoke_main
        return smoke_main(rest)
    if cmd == "chaos":
        from repro_torch.fabric.chaos_smoke import main as chaos_main
        return chaos_main(rest)
    print(f"unknown repro_torch.fabric command {cmd!r} "
          f"(want worker|smoke|chaos)")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
