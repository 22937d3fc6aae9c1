"""The LM stack of the port: layers, attention (on the flash kernel) and
the model factory."""
from repro_torch.models import attention, layers
from repro_torch.models.model import LM

__all__ = ["LM", "attention", "layers"]
