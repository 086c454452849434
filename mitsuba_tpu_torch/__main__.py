"""`python -m mitsuba_tpu_torch scene.xml [options]`: the command-line
renderer (cli.py)."""
from .cli import main

raise SystemExit(main())
