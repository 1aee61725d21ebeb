"""slot_use.topk: the useful share of the top-k dispatch's work in the
traced step: kept assignments over the slot table.

Layer: expert branch (``models/moe.py`` ``apply_dispatched``). Moves
``train_pairs_per_s.topk``. The program's counters ``moe.kept`` (the
assignments under an expert's capacity) over ``moe.slots`` (K·C a
micro-batch), summed over the traced step, in %. The program counts them
only while a profiler records (``medmoe_torch/utils/trace.py``), so they
cover the traced step alone. Nothing to read where the program has no such
counters or no top-k dispatch ran."""


def read(trace, work):
    if trace is None or work.get("kind") != "train":
        return None
    try:
        from medmoe_torch.utils import trace as program
    except ImportError:
        return None
    counters = getattr(program, "counters", None)
    got = counters() if callable(counters) else {}
    if not got.get("moe.slots"):
        return None
    return 100.0 * float(got.get("moe.kept", 0.0)) / float(got["moe.slots"])
