import sys

from atomo_tpu_torch.cli import cli_entry

sys.exit(cli_entry())
