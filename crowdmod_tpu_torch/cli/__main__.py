"""``python -m crowdmod_tpu_torch.cli <command>``."""

from crowdmod_tpu_torch.cli import main

raise SystemExit(main())
