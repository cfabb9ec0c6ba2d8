"""EdgeNeXt-S [arXiv:2206.10589] — the paper's benchmark hybrid ViT.

4 stages, depths (3,3,9,3), dims (48,96,160,304); stages 2-4 end in an SDTA
(split depthwise transpose attention) block.  Convolution kernel sizes per
stage (3,5,7,9) in the conv encoder blocks; inverted bottlenecks expand 4x.
Input 256x256x3, 1000 classes.  ~5.6M params, ~1.3 GMACs.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class EdgeNeXtConfig:
    name: str = "edgenext-s"
    img_size: int = 256
    in_channels: int = 3
    num_classes: int = 1000
    depths: Tuple[int, ...] = (3, 3, 9, 3)
    dims: Tuple[int, ...] = (48, 96, 160, 304)
    # conv-encoder depthwise kernel size per stage
    kernel_sizes: Tuple[int, ...] = (3, 5, 7, 9)
    # number of SDTA (transposed-attention) blocks at the END of each stage
    sdta_blocks: Tuple[int, ...] = (0, 1, 1, 1)
    # SDTA: number of scales (splits) per stage
    sdta_scales: Tuple[int, ...] = (2, 2, 3, 4)
    heads: int = 4              # attention heads in SDTA blocks
    expan_ratio: int = 4        # inverted-bottleneck expansion
    dtype: str = "float32"


CONFIG = EdgeNeXtConfig()


def reduced_edgenext() -> EdgeNeXtConfig:
    return EdgeNeXtConfig(
        name="edgenext-tiny-test",
        img_size=32,
        num_classes=10,
        depths=(1, 1, 2, 1),
        dims=(16, 24, 32, 48),
        kernel_sizes=(3, 3, 5, 5),
        sdta_blocks=(0, 1, 1, 1),
        sdta_scales=(1, 1, 2, 2),
        heads=2,
        expan_ratio=4,
    )
