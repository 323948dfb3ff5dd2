from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig
from repro_torch.models.layers import Runtime, Spec

__all__ = ["ArchConfig", "MLAConfig", "MoEConfig", "Runtime", "Spec"]
