"""PARSeq text-recognizer configs, all variants (the port's copy of
yomitoku_tpu/configs/text_recognizer.py; charset and font paths point
into yomitoku_tpu_torch/resource).

Reference parity: configs/cfg_text_recognizer_parseq*.py.  One shared set of
dataclasses parameterized per variant instead of five near-identical files.
"""

from dataclasses import dataclass, field
from typing import List

from ..constants import ROOT_DIR


@dataclass
class RecData:
    num_workers: int = 4
    batch_size: int = 128
    img_size: List[int] = field(default_factory=lambda: [32, 800])


@dataclass
class RecEncoder:
    patch_size: List[int] = field(default_factory=lambda: [8, 8])
    num_heads: int = 8
    embed_dim: int = 512
    mlp_ratio: int = 4
    depth: int = 12


@dataclass
class RecDecoder:
    embed_dim: int = 512
    num_heads: int = 8
    mlp_ratio: int = 4
    depth: int = 1


@dataclass
class RecVisualize:
    font: str = str(ROOT_DIR + "/resource/MPLUS1p-Medium.ttf")
    color: List[int] = field(default_factory=lambda: [0, 0, 255])  # RGB
    font_size: int = 18


def _enc(patch, dim, depth):
    return lambda: RecEncoder(patch_size=list(patch), embed_dim=dim, depth=depth)


def _dec(dim):
    return lambda: RecDecoder(embed_dim=dim)


@dataclass
class TextRecognizerPARSeqConfig:
    hf_hub_repo: str = "KotaroKinoshita/yomitoku-text-recognizer-parseq-open-beta"
    charset: str = str(ROOT_DIR + "/resource/charset.txt")
    num_tokens: int = 7312
    max_label_length: int = 100
    decode_ar: int = 1
    refine_iters: int = 1
    rec_orientation_fallback: bool = False
    rec_orientation_fallback_thresh: float = 0.75

    data: RecData = field(default_factory=RecData)
    encoder: RecEncoder = field(default_factory=_enc((8, 8), 512, 12))
    decoder: RecDecoder = field(default_factory=_dec(512))
    visualize: RecVisualize = field(default_factory=RecVisualize)


@dataclass
class TextRecognizerPARSeqV2Config(TextRecognizerPARSeqConfig):
    hf_hub_repo: str = "KotaroKinoshita/yomitoku-text-recognizer-parseq-middle-v2"


@dataclass
class TextRecognizerPARSeqSmallConfig(TextRecognizerPARSeqConfig):
    hf_hub_repo: str = "KotaroKinoshita/yomitoku-text-recognizer-parseq-small-open-beta"
    encoder: RecEncoder = field(default_factory=_enc((16, 16), 384, 9))
    decoder: RecDecoder = field(default_factory=_dec(384))


@dataclass
class TextRecognizerPARSeqTinyConfig(TextRecognizerPARSeqConfig):
    hf_hub_repo: str = "KotaroKinoshita/yomitoku-text-recognizer-parseq-tiny"
    charset: str = str(ROOT_DIR + "/resource/charsetv2.txt")
    num_tokens: int = 7121
    max_label_length: int = 50
    data: RecData = field(
        default_factory=lambda: RecData(img_size=[32, 400])
    )
    encoder: RecEncoder = field(default_factory=_enc((8, 16), 368, 12))
    decoder: RecDecoder = field(default_factory=_dec(368))


@dataclass
class TextRecognizerPARSeqLargeV41Config(TextRecognizerPARSeqConfig):
    hf_hub_repo: str = "KotaroKinoshita/yomitoku-text-recognizer-parseq-large-v4_1"
    charset: str = str(ROOT_DIR + "/resource/charsetv2.txt")
    num_tokens: int = 7121
    encoder: RecEncoder = field(default_factory=_enc((8, 8), 768, 12))
    decoder: RecDecoder = field(default_factory=_dec(768))
