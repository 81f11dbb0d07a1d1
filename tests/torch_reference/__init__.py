"""Plain references of the port's models: straightforward PyTorch in float32,
from the published descriptions, importing nothing of either package."""
