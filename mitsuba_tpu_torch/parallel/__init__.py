"""Multi-device rendering and gradients over torch.distributed (port of
mitsuba_tpu/parallel/): dist.py (the mesh, the scene broadcast, the
sharded render and training step, the process launcher) and dryrun.py
(the port's copy of __graft_entry__.py::dryrun_multichip and the
Cornell-box cases run on every rank)."""
