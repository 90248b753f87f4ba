"""Shared sizes of the benchmark's CPU tests."""

from pathlib import Path


def tiny(cell: str, data_root: Path) -> dict:
    """Overrides that run a cell on the CPU in seconds: small batches and
    data sets, one log row an epoch."""
    if cell.startswith("mnist"):
        return {"flags": {"-bs": "16", "-tss": "320", "--log_every": "320"},
                "config": {"train_set_size": 320}, "data_root": str(data_root / "mnist")}
    return {"flags": {"-bs": "2", "-tss": "6", "--log_every": "6", "--sample_every": "24",
                      "--mean_sample_size": "2", "--sample_num": "4"},
            "config": {"train_set_size": 6, "mean_sample_size": 2, "reference_chunk": 2},
            "dataset": {"rows": 6}, "data_root": str(data_root / "celeba")}


CELLS = ("mnist-acgan-mlp.gc-k1.b600", "celeba-acgan-dcresnet64.gc-ghost.b512",
         "celeba-acgan-dcresnet64.gc-materialized.b512")
