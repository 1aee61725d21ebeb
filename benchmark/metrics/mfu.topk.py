"""mfu.topk: ``mfu.train`` (the whole training step's share of the card's peak) in the top-k training
cell, whose rate is ``train_pairs_per_s.topk``, a bound of its own: the
cell is host-bound and its rate spreads wider."""

from benchmark.harness import metric_reader


def read(trace, work):
    return metric_reader("mfu.train").read(trace, work)
