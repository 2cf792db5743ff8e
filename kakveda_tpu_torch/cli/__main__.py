"""`python -m kakveda_tpu_torch.cli` — the port's command line."""

import sys

from kakveda_tpu_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
