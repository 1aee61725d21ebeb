"""Caption template sampling for multi-template webdataset captions (a
copy of medmoe_tpu/data/templates.py: the same draws from the same rng).

Re-implements reference ``preprocess_txt_rad`` (src/data/data_utils.py:94-143):
shard builders concatenate up to ~10 caption templates per sample joined by a
dataset-specific separator token; at load time one caption is sampled.
"""

from __future__ import annotations

import random
from typing import Optional

# dataset → separator token (the ones sample_caption splits on below);
# shard builders writing in join mode use the same table
SEPARATORS = {
    "radimagenet": "_radimagenet_",
    "chexpert": "_chexpert_",
    "chestxray": "_chestxray8_",
    "openi": "_openi_",
    "retina": "_all_retina_merged_",
    "dr": "_dr_",
    "medicat": "_medicat_",
    "mimiccxr": "_mimiccxr_",
}


def sample_caption(text: str, rng: Optional[random.Random] = None) -> str:
    rng = rng or random
    if "_radimagenet_" in text:
        return rng.choice(text.split("_radimagenet_")[0:10])
    if "_chexpert_" in text:
        return rng.choice(text.split("_chexpert_")[0:10])
    if "_openi_" in text:
        # 1 original + 3 templates; reference pins original=True
        return text.split("_openi_")[0]
    if "_chestxray8_" in text:
        return rng.choice(text.split("_chestxray8_")[0:10])
    if "_all_retina_merged_" in text:
        return rng.choice(text.split("_all_retina_merged_")[0:10])
    if "_dr_" in text:
        return rng.choice(text.split("_dr_")[0:15])
    if "_medicat_" in text:
        parts = text.split("_medicat_")
        if parts[1] == "nothingpresent":
            return parts[0]
        return rng.choice(parts)
    if "_mimiccxr_" in text:
        parts = text.split("_mimiccxr_")
        caption = parts[-1]
        if caption == "noreportpresent":
            return rng.choice(parts[0:10])
        return caption
    # single original caption (llava/quilt style)
    return text
