"""Block-streaming core: stream specs, processors, pipelines, streaming loop."""

from libsdr_tpu_torch.core.stream import (StreamSpec, ConfigError,
                                          RuntimeSDRError, SDRError)
from libsdr_tpu_torch.core.block import Lambda, Processor
from libsdr_tpu_torch.core.graph import Pipeline
from libsdr_tpu_torch.core.runtime import stream_blocks, run_pipeline

__all__ = [
    "StreamSpec",
    "ConfigError",
    "RuntimeSDRError",
    "SDRError",
    "Processor",
    "Lambda",
    "Pipeline",
    "stream_blocks",
    "run_pipeline",
]
