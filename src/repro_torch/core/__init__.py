"""The design-space explorer's core: the port's own copy of the JAX
package's ``core/`` (agents, PsA, space, workload, topology, collectives,
simulator, backends, scenarios, fleet, rewards, env, study, analysis,
surrogate), kept textually close to it.  Everything here is numpy or pure
Python except the ``torch`` simulation backend
(``backends/torch_backend.py``), which prices durations and sweeps the
schedule with the ``dse_sim`` CUDA kernels."""
