"""``python -m brickmap_tpu_torch`` entry point."""

from .app.cli import main

raise SystemExit(main())
