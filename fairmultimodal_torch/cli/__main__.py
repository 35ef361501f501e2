"""``python -m fairmultimodal_torch.cli`` entry point."""

import sys

from fairmultimodal_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
