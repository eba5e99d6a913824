"""Task-module base of the port (counterpart of yomitoku_tpu/base.py):
``BaseModule.load_model`` builds one of the port's models on an explicit
device.  The model catalog class and the timing observer are the JAX
package's own (both free of JAX)."""

import torch

from yomitoku_tpu.base import BaseModelCatalog, observer
from yomitoku_tpu.config import load_config
from yomitoku_tpu.utils.logger import set_logger

from .weights import load_pretrained

logger = set_logger(__name__, "INFO")

__all__ = ["BaseModelCatalog", "BaseModule", "resolve_device"]


def resolve_device(device) -> torch.device:
    """``"cuda"`` (or ``"cuda:N"``) or ``"cpu"``.  CUDA is never swapped for
    the CPU: asking for it where there is none raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} requested, but torch.cuda.is_available() "
                "is false; pass device='cpu' to run the plain CPU path"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


class BaseModule:
    """Common base of the task modules.  Subclasses set ``model_catalog``
    and call ``load_model`` in __init__; ``__call__`` is wrapped in the
    timing observer, as in the JAX package."""

    model_catalog = None

    def __init__(self):
        if not isinstance(self.model_catalog, BaseModelCatalog):
            raise ValueError(f"{type(self).__name__} has no model catalog")
        if not self.model_catalog.list_model():
            raise ValueError("No model is registered.")

    def __new__(cls, *args, **kwds):
        logger.info(f"Initialize {cls.__name__}")
        if not getattr(cls.__call__, "_is_observer", False):
            cls.__call__ = observer(cls, cls.__call__)
        return super().__new__(cls)

    def load_model(self, name, path_cfg=None, device="cuda",
                   from_pretrained=True, dtype=None):
        default_cfg, Net = self.model_catalog.get(name)
        self._cfg = load_config(default_cfg, path_cfg)
        self.device = resolve_device(device)
        self.model = Net(self._cfg, device=self.device, dtype=dtype)
        if from_pretrained:
            load_pretrained(self.model, self._cfg)
