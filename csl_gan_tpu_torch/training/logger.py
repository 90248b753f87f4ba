"""Interval-averaged stats logger (reference logger.py:3-38 + train.py:263-278).

The same console format, stat names and ``log.csv`` layout as the JAX
package's training/logger.py, so CSV tooling reads either package's logs.
Values are host numbers or numpy arrays by the time they are logged.
"""

from __future__ import annotations

import csv
from typing import List

import numpy as np


class Logger:
    def __init__(self, str_format: str, stat_names: List[str], interval: int,
                 csv_path: str,
                 epoch_batch_str_format: str = "=== Epoch {} ({:2.1f}%) ===\n",
                 write_header: bool = True):
        self.stat_names = stat_names
        self.stats = {name: 0.0 for name in stat_names}
        self.interval = interval
        self.str_format = epoch_batch_str_format + str_format
        self.f = open(csv_path, "a")
        self.csv_writer = csv.writer(self.f)
        if write_header:
            self.csv_writer.writerow(["Epoch", "Batch"] + stat_names)
        self.f.flush()
        self.log_g_iter = 0

    def average(self):
        for name in self.stats:
            self.stats[name] = np.asarray(self.stats[name]) / self.interval

    def reset_stats(self):
        for name in self.stats:
            self.stats[name] = 0.0

    def _fmt(self, v):
        v = np.asarray(v)
        if v.ndim == 0:
            return float(v)
        return np.array2string(v, precision=4, suppress_small=True,
                               max_line_width=999999)

    def log(self, epoch, epoch_percent):
        self.average()
        ordered = [epoch, epoch_percent] + [self._fmt(self.stats[n])
                                            for n in self.stat_names]
        print(self.str_format.format(*ordered))
        self.csv_writer.writerow(ordered)
        self.f.flush()
        self.reset_stats()

    def close(self):
        self.f.close()


def build_logger(opt, csv_path: str, write_header: bool = True) -> Logger:
    """The dp-mode-dependent format/column sets of reference train.py:263-278."""
    use_aux = opt.use_aux_loss
    has_penalty = len(opt.penalty) > 0
    fmt = ("G " + ("Adv " if use_aux else "") + "Loss: {:4.4f}"
           + (", G Aux: {:4.4f} / {:3.1f}%\n" if use_aux else " | ")
           + "D Adv Loss: {:4.4f} (Real: {:4.4f} / {:3.1f}%, Fake: {:4.4f} / {:3.1f}%"
           + (", Real Aux: {:4.4f} / {:3.1f}%" if use_aux else "")
           + (", Penalty: {:4.4f}" if has_penalty else "") + ")"
           + ("\n=== Grad Norms ===\nMean Per Layer: {}\nStd Per Layer: {}\n"
              "Max Per Layer: {}\nClipping Params: {}\nGrads Clipped: {}"
              if opt.dp_mode == "gc" else "")
           + ("\nIS - Mean: {} - Min: {} - Max: {}" if opt.dp_mode == "is" else ""))
    names = (["G Adv Loss"]
             + (["G Aux Loss", "G Aux Acc"] if use_aux else [])
             + ["D Adv Loss", "D Real Loss", "D Real Acc", "D Fake Loss", "D Fake Acc"]
             + (["D Real Aux Loss", "D Real Aux Acc"] if use_aux else [])
             + (["D Penalty"] if has_penalty else [])
             + (["D Layer Grad Norm Means", "D Layer Grad Norm Stds",
                 "D Layer Grad Norm Maxes", "Clipping Params", "Grads Clipped"]
                if opt.dp_mode == "gc" else [])
             + (["IS Mean", "IS Min", "IS Max"] if opt.dp_mode == "is" else []))
    interval = ((opt.log_every_epochs * opt.train_set_size
                 if opt.log_every_epochs > 0 else opt.log_every)
                // opt.batch_size)
    return Logger(fmt, names, interval, csv_path, write_header=write_header)
