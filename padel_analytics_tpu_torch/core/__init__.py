"""Checkpoint IO (the JAX package's Flax .msgpack files, without flax) and
profiling (stage timers, logging, device traces)."""

from .checkpoint import load_checkpoint, msgpack_restore, msgpack_serialize, save_checkpoint
from .profiling import StageTimer, device_trace, log

__all__ = ["StageTimer", "device_trace", "load_checkpoint", "log", "msgpack_restore",
           "msgpack_serialize", "save_checkpoint"]
