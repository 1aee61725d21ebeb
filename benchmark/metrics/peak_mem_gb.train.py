"""peak_mem_gb.train: the device memory the training window peaks at.

Layer: device. Moves ``train_pairs_per_s`` (a trade of memory for time
shows here without being refused). ``torch.cuda.max_memory_allocated``
over the unprofiled window, after ``reset_peak_memory_stats``, in GB
(10^9 bytes)."""


def read(trace, work):
    if work.get("kind") != "train" or not work.get("peak_bytes"):
        return None
    return work["peak_bytes"] / 1e9
