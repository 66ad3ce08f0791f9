"""Engines under test, one module per kind, named by a configuration file's
"engine_module" (``gkp_batched`` where it names none); ``gkp/`` holds what
the GKP engines share (the draw recorder and the check)."""
