"""Checkpoints: the weight bridge to and from the JAX parameter tree
(`bridge`) and the training checkpoint manager (`manager`), which writes
the JAX manager's npz layout."""
from repro_torch.checkpoint.bridge import (SEP, from_jax_flat, jax_key,
                                           load_npz, params_from_numpy,
                                           params_to_numpy, to_jax_flat,
                                           to_numpy, to_torch)
from repro_torch.checkpoint.manager import CheckpointManager
