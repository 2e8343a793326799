import sys

from fft_restoration_tpu_torch.cli import main

sys.exit(main())
