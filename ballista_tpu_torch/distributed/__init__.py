"""The port's distributed runtime: scheduler (control plane), executors
(data plane), cluster state and the shuffle data plane.

The JAX package's ``distributed/`` on torch: the scheduler plans and
cuts queries into stages on the CPU, executors pull tasks and run them
on their device (``ExecutorConfig.device``, "cuda" by default), and
stage outputs cross between executors as Arrow IPC files served by the
data plane (the port's own native daemon, or the Python server). An
executor that reports a mesh of slots runs mesh-fused stages, whose
exchanges stay on its device (``physical/mesh_agg.py``); a mesh group
(``mesh_group.py``) spans several executor processes.
"""
