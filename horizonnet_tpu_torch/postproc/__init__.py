"""Layout post-processing of the port: the fused cuboid and general-layout
fits (device) and their host tails."""

from .device import (pack_cuboid_outputs, pack_general_outputs,
                     postprocess_cuboid_batch, postprocess_general_batch)
from .serving import (finish_general_batch, general_from_candidates,
                      unpack_cuboid_outputs, unpack_general_outputs)

__all__ = ["finish_general_batch", "general_from_candidates",
           "pack_cuboid_outputs", "pack_general_outputs",
           "postprocess_cuboid_batch", "postprocess_general_batch",
           "unpack_cuboid_outputs", "unpack_general_outputs"]
