import sys

from gan_inpainting_torch.cli import main

sys.exit(main())
