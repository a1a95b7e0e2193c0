"""Layout post-processing of the port: the fused cuboid fit (device) and
the host unpacking of its packed output."""

from .serving import unpack_cuboid_outputs

__all__ = ["unpack_cuboid_outputs"]
