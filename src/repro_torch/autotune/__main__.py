"""``python -m repro_torch.autotune {search,score,report,smoke}``."""
import sys

from repro_torch.autotune.cli import main

if __name__ == "__main__":
    sys.exit(main())
