"""Evaluation machinery of the port: FID statistics (``fid``) and the loader
of a run directory's saves (``saved_run``) that the evaluation tools share."""
