"""In-mesh SPMD query execution over slots of torch devices.

The port of the JAX package's ``parallel/`` (``jax.sharding.Mesh`` and
``shard_map``). A mesh here is a list of slots, each a torch device;
repeats are allowed, so n slots can share one card or the CPU. The
per-slot rows of a stage stay stacked as ``[n_slots, cap]`` tensors, each
slot's work calls the single-device functions of the port in a loop over
slots inside one governed program, and the collectives are tensor ops
on the stacked layout (``mesh.SlotAxis``). ``torch.distributed`` is used
only where the reference crosses processes (``multihost.py``).
"""

from .mesh import MeshQueryRunner, SlotAxis, make_mesh  # noqa: F401
