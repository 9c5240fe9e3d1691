import inspect

from mca_tpu_torch.models.layers import (  # noqa: F401
    Attention,
    FeedForward,
    LayerNorm,
    MCALayer,
)
from mca_tpu_torch.models.mca import MCA  # noqa: F401


def build_model(model_config: dict) -> MCA:
    """Model selector over ``get_model_config`` kwargs (MCA family; EAO
    is not ported yet).  Keys the constructor does not take (loss-graph
    and training options) are dropped, as in the JAX package."""
    cfg = dict(model_config)
    if cfg.pop("eao", False):
        raise NotImplementedError("the EAO family is not ported yet")
    params = inspect.signature(MCA.__init__).parameters
    return MCA(**{k: v for k, v in cfg.items() if k in params})
