"""Downstream classification of generated MNIST samples (the port's
counterpart of the root tool downstream.py):

    python -m csl_gan_tpu_torch.downstream <output_dir> [-e epoch | -ei interval] [-c lr svm ...] [-d cpu]

Per generator checkpoint of either package: generate -n labelled samples,
train scikit-learn one-vs-rest classifiers on them, report the micro-AUROC
against the MNIST test set, and append it to <output_dir>/downstream_log.csv.
scikit-learn is needed only here, and is imported when the tool runs.
"""

import argparse
import csv
import os
import time

import numpy as np
import torch

from csl_gan_tpu_torch import options
from csl_gan_tpu_torch.data import mnist
from csl_gan_tpu_torch.tools.saved_run import add_device_flag, load_run

CLASSIFIERS = ["svm", "dt", "lr", "rf", "gnb", "bnb", "ab", "mlp"]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("path", type=str)
    parser.add_argument("-e", "--epochs", type=int, default=None)
    parser.add_argument("-ei", "--epoch_interval", type=int, default=100)
    parser.add_argument("-bs", "--batch_size", type=int, default=50)
    parser.add_argument("-c", "--classifiers", type=str, default=["lr"], nargs="*",
                        choices=CLASSIFIERS)
    parser.add_argument("-n", "--num_samples", type=int, default=10000)
    add_device_flag(parser)
    args = parser.parse_args(argv)
    try:
        import warnings

        from sklearn.ensemble import AdaBoostClassifier, RandomForestClassifier
        from sklearn.exceptions import ConvergenceWarning
        from sklearn.linear_model import LogisticRegression
        from sklearn.metrics import auc, roc_curve
        from sklearn.multiclass import OneVsRestClassifier
        from sklearn.naive_bayes import BernoulliNB, GaussianNB
        from sklearn.neural_network import MLPClassifier
        from sklearn.preprocessing import label_binarize
        from sklearn.svm import SVC
        from sklearn.tree import DecisionTreeClassifier
    except ImportError as e:
        raise ImportError("downstream needs scikit-learn (sklearn), which is not "
                          "installed") from e
    makers = {
        "svm": lambda: SVC(kernel="linear", probability=True, random_state=30),
        "dt": lambda: DecisionTreeClassifier(random_state=30),
        "lr": lambda: LogisticRegression(solver="lbfgs", random_state=30),
        "rf": lambda: RandomForestClassifier(n_estimators=100, random_state=30),
        "gnb": lambda: GaussianNB(),
        "bnb": lambda: BernoulliNB(alpha=0.01),
        "ab": lambda: AdaBoostClassifier(random_state=30),
        "mlp": lambda: MLPClassifier(random_state=30, alpha=1),
    }

    t0 = time.perf_counter()
    path = options.add_slash(args.path)
    train_opt = options.load_opt(path + "opt.txt")
    if train_opt.dataset != "MNIST":
        raise Exception("Downstream evaluation only implemented for MNIST.")
    x_test, y_test_raw = mnist.load_mnist(train_opt.data_path, train=False)
    x_test = x_test.reshape(x_test.shape[0], -1).astype(float)
    y_test = label_binarize([int(t) for t in y_test_raw], classes=list(range(10)))

    log = open(path + "downstream_log.csv", "a")
    logger = csv.writer(log)
    logger.writerow(["Epoch"] + [c + " AUROC" for c in args.classifiers])
    log.flush()
    n = args.num_samples
    epoch = args.epoch_interval if args.epochs is None else args.epochs
    while os.path.isfile(path + "saves/G-" + str(epoch)):
        _, builder, state, _ = load_run(path, epoch, args.device, with_d=False)
        gen = torch.Generator(next(iter(state.g_params.values())).device).manual_seed(30)
        z = builder.gen_z(gen, n)
        y = torch.randint(0, 10, (n,), generator=gen, device=z.device)
        # As in the JAX tool, an unconditional G samples without the labels
        # it is scored against.
        images = np.concatenate([
            builder.sample_images(state, z[i:i + args.batch_size],
                                  y[i:i + args.batch_size] if train_opt.conditional else None
                                  ).cpu().numpy()
            for i in range(0, n, args.batch_size)]).reshape(n, -1)
        labels = y.cpu().numpy()
        aurocs = []
        for c in args.classifiers:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", ConvergenceWarning)
                score = OneVsRestClassifier(makers[c]()).fit(images, labels).predict_proba(x_test)
            fpr, tpr, _ = roc_curve(y_test.ravel(), score.ravel())
            aurocs.append(auc(fpr, tpr))
            print("{} AUROC ({}):  {}".format(c, epoch, aurocs[-1]))
        logger.writerow([epoch] + aurocs)
        log.flush()
        if args.epochs is not None:
            break
        epoch += args.epoch_interval
    log.close()
    print(f"downstream: {time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
    main()
