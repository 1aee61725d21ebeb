"""idle_share.topk: ``idle_share.train`` (the device's idle share of the traced step) in the top-k training
cell, whose rate is ``train_pairs_per_s.topk``, a bound of its own: the
cell is host-bound and its rate spreads wider."""

from benchmark.harness import metric_reader


def read(trace, work):
    return metric_reader("idle_share.train").read(trace, work)
