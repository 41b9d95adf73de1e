import sys

from sntc_tpu_torch.app import main

sys.exit(main())
