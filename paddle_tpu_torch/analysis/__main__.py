"""`python -m paddle_tpu_torch.analysis`: the tracelint CLI (`cli.main`)."""
import sys

from .cli import main

sys.exit(main())
