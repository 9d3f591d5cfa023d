"""Checkpoint IO: the JAX package's Flax .msgpack files, without flax."""

from .checkpoint import load_checkpoint, msgpack_restore, msgpack_serialize, save_checkpoint

__all__ = ["load_checkpoint", "msgpack_restore", "msgpack_serialize", "save_checkpoint"]
