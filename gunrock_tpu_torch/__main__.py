"""``python -m gunrock_tpu_torch bfs ...`` — see :mod:`gunrock_tpu_torch.cli`."""

import sys

from .cli import main

sys.exit(main())
