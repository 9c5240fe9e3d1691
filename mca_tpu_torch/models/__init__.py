import inspect

from mca_tpu_torch.models.layers import (  # noqa: F401
    Attention,
    FeedForward,
    LayerNorm,
    MCALayer,
)
from mca_tpu_torch.models.eao import EAO  # noqa: F401
from mca_tpu_torch.models.mca import MCA  # noqa: F401
from mca_tpu_torch.models.pool import MeanTokenProjectionPool  # noqa: F401


def build_model(model_config: dict, fused_ff: bool = True):
    """MCA / EAO selector over ``get_model_config`` kwargs (``eao``
    picks the family).  Keys the constructor does not take are dropped,
    as in the JAX package.  ``fused_ff=True`` builds the forward-only
    fused feed-forward (serving, inference); training passes ``False``."""
    cfg = dict(model_config, fused_ff=fused_ff)
    cls = EAO if cfg.pop("eao", False) else MCA
    params = inspect.signature(cls.__init__).parameters
    return cls(**{k: v for k, v in cfg.items() if k in params})
