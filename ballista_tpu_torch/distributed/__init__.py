"""The port's distributed data plane: stage planning, partition
locations, the shuffle file server and the shuffle memory governor.

Copies of the JAX package's ``distributed/{planner,types,spill,
dataplane}.py`` (the data plane builds the port's own native daemon).
The scheduler and executor are not ported yet (ROADMAP queue 1 item 9):
``testing/stages.py`` runs a query stage by stage without them.
"""
