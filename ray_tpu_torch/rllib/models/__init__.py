from ray_tpu_torch.rllib.models.catalog import (
    MODEL_DEFAULTS,
    ModelCatalog,
    register_custom_module,
)

__all__ = ["MODEL_DEFAULTS", "ModelCatalog", "register_custom_module"]
