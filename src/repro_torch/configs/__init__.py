"""Architecture configurations (data only)."""
from repro_torch.configs.base import (ARCH_IDS, ArchConfig, entries,  # noqa: F401
                                      get, get_smoke)
