"""``yomitoku_torch_download_model``: prefetch the default models'
checkpoints into the weight store (the port's copy of
yomitoku_tpu/cli/download_model.py, the JAX package's ``download_model``).

Reference parity: yomitoku/cli/download_model.py (``snapshot_download`` of
every repo in ``DEFAULT_CONFIGS``).  The port reads the reference torch
checkpoints as they are, from the store both packages share
(``weights.weights_dir``: ``$YOMITOKU_TPU_WEIGHTS``, one directory per
repo).  Where ``huggingface_hub`` is missing or the download fails (no
network), it warns with the directory to place the checkpoint in by hand.
"""

from argparse import ArgumentParser

from ..configs import DEFAULT_CONFIGS
from ..utils.logger import set_logger
from ..weights import weights_dir

logger = set_logger(__name__, "INFO")


_BY_NAME = {c.__name__: c for c in DEFAULT_CONFIGS}


def download_one(name: str) -> bool:
    cfg = _BY_NAME[name]()
    repo = cfg.hf_hub_repo
    dest = weights_dir() / repo.split("/")[-1]
    try:
        from huggingface_hub import snapshot_download

        snapshot_download(repo, local_dir=dest)
        logger.info(f"downloaded {repo} -> {dest}")
        return True
    except Exception as e:  # no hub package, no network, no such repo
        logger.warning(
            f"could not download {repo} ({e}); place its torch checkpoint "
            f"(model.safetensors or pytorch_model.bin) under {dest}/ manually"
        )
        return False


def main():
    parser = ArgumentParser()
    parser.add_argument(
        "--name",
        type=str,
        default=None,
        choices=list(_BY_NAME),
        help="model to download (default: all)",
    )
    args = parser.parse_args()
    names = [args.name] if args.name else list(_BY_NAME)
    for name in names:
        download_one(name)


if __name__ == "__main__":
    main()
