"""gloria_kept.train: the share of the GLoRIA kernel backwards that ran from
K3's kept state rather than running K3's first two passes again.

Layer: GLoRIA similarity (``ops/gloria_attention.py``). Moves
``train_pairs_per_s``. The program's host counters ``gloria.kept`` over
``gloria.kept`` + ``gloria.recomputed``, one a backward's prologue, over
the whole run, in %. Nothing to read where the program has no such
counters or no GLoRIA kernel backward ran."""


def read(trace, work):
    if trace is None or work.get("kind") != "train":
        return None
    try:
        from medmoe_torch.utils import trace as program
    except ImportError:
        return None
    counters = getattr(program, "counters", None)
    got = counters() if callable(counters) else {}
    kept = float(got.get("gloria.kept", 0))
    total = kept + float(got.get("gloria.recomputed", 0))
    if not total:
        return None
    return 100.0 * kept / total
