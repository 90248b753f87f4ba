"""Evaluation machinery of the port: FID statistics (``fid``), the
InceptionV3 network of Inception FID (``inception``) and the loader of a run
directory's saves (``saved_run``) that the evaluation tools share."""
