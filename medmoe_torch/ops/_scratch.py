"""The device scratch budget that the kernels' wrappers share: a batch runs
its passes over chunks of images whose scratch fits in it."""

CHUNK_BYTES = 1.7e9      # the scratch of one chunk of images, at most


def images_in_budget(b: int, per_image: int) -> int:
    """Images of a chunk whose scratch takes ``per_image`` bytes an image:
    as many as fit in ``CHUNK_BYTES``, at least one, at most the batch
    ``b``."""
    return max(1, min(b, int(CHUNK_BYTES // per_image)))
