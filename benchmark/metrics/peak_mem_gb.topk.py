"""peak_mem_gb.topk: ``peak_mem_gb.train`` (the allocator's peak over the window) in the top-k training
cell, whose rate is ``train_pairs_per_s.topk``, a bound of its own: the
cell is host-bound and its rate spreads wider."""

from benchmark.harness import metric_reader


def read(trace, work):
    return metric_reader("peak_mem_gb.train").read(trace, work)
