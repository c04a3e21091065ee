import sys

from atomo_tpu_torch.cli import main

sys.exit(main())
