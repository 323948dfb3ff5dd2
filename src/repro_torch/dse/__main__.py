"""`python -m repro_torch.dse` — see `repro_torch.dse.cli`."""

import sys

from repro_torch.dse.cli import main

sys.exit(main())
