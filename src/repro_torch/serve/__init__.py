"""Serving: continuous-batching engine over quantized weights and KV pages."""
from repro_torch.serve.engine import (Engine, EngineConfig, Request,  # noqa: F401
                                      RequestOutput, SamplingParams)
