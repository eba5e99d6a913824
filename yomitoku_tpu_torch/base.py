"""Task-module base of the port (counterpart of yomitoku_tpu/base.py):
the model catalog, the timing observer, the schema base class (every
schema writes itself as JSON, ``to_json``), and
``BaseModule.load_model``, which builds one of the port's models on an
explicit device."""

import os
import time
from pathlib import Path

import torch
from pydantic import BaseModel, ConfigDict

from .config import load_config
from .utils.logger import set_logger
from .weights import load_pretrained

logger = set_logger(__name__, "INFO")

__all__ = ["BaseModelCatalog", "BaseModule", "BaseSchema", "observer",
           "resolve_device"]


def observer(cls, func):
    """Wrap a callable with wall-clock INFO timing.

    When ``YOMITOKU_TPU_PROFILE=<dir>`` is set, each observed call is also
    recorded with ``torch.profiler`` (host and, where there is a card,
    device timelines), written as a Chrome trace under ``<dir>/<Module>/``
    (the JAX package records a jax.profiler trace there)."""

    def wrapper(*args, **kwargs):
        profile_dir = os.environ.get("YOMITOKU_TPU_PROFILE")
        prof = None
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.__enter__()
        try:
            start = time.time()
            result = func(*args, **kwargs)
            elapsed = time.time() - start
            logger.info(f"{cls.__name__} {func.__name__} elapsed_time: {elapsed}")
        except Exception as e:
            logger.error(f"Error occurred in {cls.__name__} {func.__name__}: {e}")
            raise e
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
                out = Path(profile_dir) / cls.__name__
                out.mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(str(out / f"trace_{time.time_ns()}.json"))
        return result

    wrapper._is_observer = True
    return wrapper


class BaseSchema(BaseModel):
    model_config = ConfigDict(extra="forbid", validate_assignment=True)

    def to_json(self, out_path: str, **kwargs):
        from .export import export_json

        return export_json(self, out_path, **kwargs)


class BaseModelCatalog:
    """Registry mapping model-variant name -> (default config, model class)."""

    def __init__(self):
        self.catalog = {}

    def get(self, model_name: str):
        model_name = model_name.lower()
        if model_name in self.catalog:
            return self.catalog[model_name]
        raise ValueError(f"Unknown model: {model_name}")

    def register(self, model_name: str, config, model):
        if model_name in self.catalog:
            raise ValueError(f"{model_name} is already registered.")
        self.catalog[model_name] = (config, model)

    def list_model(self):
        return list(self.catalog.keys())


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


def check_num_devices(num_devices):
    """The port runs on one card: ``num_devices`` None or 1, as the JAX
    package's single-device default; more raises."""
    if num_devices is not None and num_devices != 1:
        raise NotImplementedError(
            f"num_devices={num_devices}: page data parallelism is not ported "
            "yet; the port runs on one device")

