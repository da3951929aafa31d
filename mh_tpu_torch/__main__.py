import sys

from mh_tpu_torch.cli import main

sys.exit(main())
