"""`python -m ecloop_tpu_torch <cmd> ...` — CLI entry point."""

import sys

from .cli import main

sys.exit(main())
