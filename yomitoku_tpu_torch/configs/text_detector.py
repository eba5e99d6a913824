"""DBNet text-detector configs, all variants (the port's copy of
yomitoku_tpu/configs/text_detector.py).

Reference parity: configs/cfg_text_detector_dbnet*.py — variants differ
only in hub repo and postprocess thresholds.
"""

from dataclasses import dataclass, field
from typing import List


@dataclass
class DetBackbone:
    name: str = "resnet50"
    dilation: bool = True


@dataclass
class DetDecoder:
    in_channels: List[int] = field(default_factory=lambda: [256, 512, 1024, 2048])
    hidden_dim: int = 256
    adaptive: bool = True
    serial: bool = True
    smooth: bool = False
    k: int = 50


@dataclass
class DetData:
    shortest_size: int = 1280
    limit_size: int = 1600


@dataclass
class DetPostProcess:
    min_size: int = 2
    thresh: float = 0.15
    box_thresh: float = 0.5
    max_candidates: int = 1500
    unclip_ratio: float = 7.0


@dataclass
class DetVisualize:
    color: List[int] = field(default_factory=lambda: [0, 255, 0])
    heatmap: bool = False


@dataclass
class TextDetectorDBNetConfig:
    hf_hub_repo: str = "KotaroKinoshita/yomitoku-text-detector-dbnet-open-beta"
    backbone: DetBackbone = field(default_factory=DetBackbone)
    decoder: DetDecoder = field(default_factory=DetDecoder)
    data: DetData = field(default_factory=DetData)
    post_process: DetPostProcess = field(default_factory=DetPostProcess)
    visualize: DetVisualize = field(default_factory=DetVisualize)


@dataclass
class TextDetectorDBNetV2Config(TextDetectorDBNetConfig):
    hf_hub_repo: str = "KotaroKinoshita/yomitoku-text-detector-dbnet-v2"
    post_process: DetPostProcess = field(
        default_factory=lambda: DetPostProcess(thresh=0.2, unclip_ratio=5.0)
    )


@dataclass
class TextDetectorDBNetV2_1Config(TextDetectorDBNetConfig):
    hf_hub_repo: str = "KotaroKinoshita/yomitoku-text-detector-dbnet-v2_1"
    post_process: DetPostProcess = field(
        default_factory=lambda: DetPostProcess(
            thresh=0.3, box_thresh=0.4, unclip_ratio=3.5
        )
    )


@dataclass
class TextDetectorDBNetV2_1LiteConfig(TextDetectorDBNetV2_1Config):
    """CPU-efficient variant: same v2_1 weights, reduced input resolution
    (the reference's --lite runs an ONNX DBNet on CPU,
    cli/main.py:505-514; on the JAX CPU backend the conv FLOPs dominate,
    so lite trades page resolution ~2x per side for ~4x detector time)."""

    data: DetData = field(
        default_factory=lambda: DetData(shortest_size=640, limit_size=960)
    )
